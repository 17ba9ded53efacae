"""Feature detection and matching for textureless scenes, the counterpart
of ``txr/geometry/features.py``.

Two SIFT backends, as in ``txr``: ``"cv2"`` rides OpenCV's C++ kernels (the
reference's substrate; imported at first use, and optional: the card's
machine need not have it), ``"device"`` runs the port's own CLAHE + SIFT
(``ops/clahe.py``, ``ops/sift.py``) on the detector's device. Descriptor
matching is one product on the device (``ops/matching.py``).

Fixed-capacity contract: every detector returns exactly ``capacity`` rows
with a validity mask. ``ORBDetector`` has the same two backends (OpenCV's
ORB, or ``ops/orb.py`` on the device); their descriptors come from
different BRIEF patterns and must not be matched against each other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.io.opencv import cv2_or_none, require_cv2
from txr_torch.ops.clahe import clahe
from txr_torch.ops.matching import (match_hamming_ratio, match_l2_ratio,
                                    unpack_bits)
from txr_torch.ops.orb import orb_features
from txr_torch.ops.sift import sift_features


def resolve_backend(backend: str, device: torch.device) -> str:
    """Resolve 'auto' to a concrete feature backend: 'device' when the
    detector runs on a CUDA device (the whole RGB -> features -> pose path
    stays on the card); on the CPU, cv2's C++ kernels when OpenCV imports,
    else the device ops."""
    if backend != "auto":
        return backend
    if device.type == "cuda":
        return "device"
    return "cv2" if cv2_or_none() is not None else "device"


@dataclass
class Features:
    """Fixed-capacity keypoints + descriptors (tensors on the detector's
    device)."""

    uv: torch.Tensor        # (N, 2) float32 pixel coords
    desc: torch.Tensor      # (N, D) float32 descriptors (SIFT) / packed uint8
    mask: torch.Tensor      # (N,) bool
    kind: str = "sift"      # 'sift' | 'orb'

    @property
    def count(self) -> int:
        return int(self.mask.sum())


def _pad_features(uv: np.ndarray, desc: np.ndarray, capacity: int,
                  kind: str, device: torch.device) -> Features:
    n = min(len(uv), capacity)
    d = desc.shape[1] if len(desc) else (128 if kind == "sift" else 32)
    out_uv = np.zeros((capacity, 2), np.float32)
    out_desc = np.zeros((capacity, d), desc.dtype if len(desc) else np.float32)
    out_mask = np.zeros((capacity,), bool)
    out_uv[:n] = uv[:n]
    out_desc[:n] = desc[:n]
    out_mask[:n] = True
    return Features(*(torch.from_numpy(a).to(device)
                      for a in (out_uv, out_desc, out_mask)), kind)


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 BGR -> (H, W) uint8 grey on the tensor's device, with
    OpenCV's fixed-point BT.601 weights (cv2.cvtColor(COLOR_BGR2GRAY) bit
    for bit: (R*9798 + G*19235 + B*3735 + 2^14) >> 15)."""
    c = bgr.to(torch.int32)
    y = c[..., 2] * 9798 + c[..., 1] * 19235 + c[..., 0] * 3735
    return ((y + (1 << 14)) >> 15).to(torch.uint8)


class SIFTDetector:
    """SIFT with optional CLAHE preprocessing.

    Defaults follow the fusion pipeline's textureless-tuned settings
    (reference depth_to_reconstruction.py:133-153): 8000 features,
    contrastThreshold 0.01, edgeThreshold 15, CLAHE(2.0, 8x8).

    backend: 'cv2' (OpenCV's C++ SIFT), 'device' (``ops/clahe.py`` +
    ``ops/sift.py`` on ``device``), 'auto' (see ``resolve_backend``).
    device: where features are computed and kept (``None``: the CUDA
    device; raises when there is none).
    """

    def __init__(self, n_features: int = 8000,
                 contrast_threshold: float = 0.01,
                 edge_threshold: float = 15, use_clahe: bool = True,
                 capacity: int = 8192, backend: str = "auto", device=None):
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.use_clahe = use_clahe
        self.n_features = n_features
        self.contrast_threshold = contrast_threshold
        self.edge_threshold = edge_threshold
        self.capacity = capacity
        self.clahe = None
        if self.backend == "cv2":
            cv2 = require_cv2("the 'cv2' feature backend")
            self.sift = cv2.SIFT_create(nfeatures=n_features,
                                        contrastThreshold=contrast_threshold,
                                        edgeThreshold=edge_threshold)
            if use_clahe:
                self.clahe = cv2.createCLAHE(clipLimit=2.0,
                                             tileGridSize=(8, 8))

    def _detect_device(self, gray: torch.Tensor) -> Features:
        g = clahe(gray, 2.0, 8) if self.use_clahe else gray
        f = sift_features(g, capacity=self.capacity,
                          contrast_threshold=self.contrast_threshold,
                          edge_threshold=float(self.edge_threshold),
                          n_features=self.n_features)
        return Features(f.uv, f.desc, f.mask, "sift")

    def _detect_cv2(self, image) -> Features:
        cv2 = require_cv2("the 'cv2' feature backend")
        img = image.cpu().numpy() if isinstance(image, torch.Tensor) \
            else np.asarray(image)
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 \
            else img
        if self.clahe is not None:
            gray = self.clahe.apply(gray)
        kps, desc = self.sift.detectAndCompute(gray, None)
        if desc is None or len(kps) == 0:
            return _pad_features(np.zeros((0, 2), np.float32),
                                 np.zeros((0, 128), np.float32),
                                 self.capacity, "sift", self.device)
        uv = np.array([kp.pt for kp in kps], np.float32)
        return _pad_features(uv, desc.astype(np.float32), self.capacity,
                             "sift", self.device)

    @torch.no_grad()
    def detect(self, bgr) -> Features:
        """Features of one (H, W, 3) BGR or (H, W) grey image."""
        if self.backend == "device":
            return self._detect_device(gray_u8(bgr, self.device))
        return self._detect_cv2(bgr)

    @torch.no_grad()
    def detect_batch(self, images) -> list:
        """Features of every image of a sequence, kept on the device. The
        device backend runs the frames one at a time (as ``txr``'s
        ``lax.map``), so peak memory stays at one frame's pyramid."""
        return [self.detect(im) for im in images]


def gray_u8(image, device: torch.device) -> torch.Tensor:
    """uint8 grey on ``device`` from a BGR or grey image (numpy or tensor);
    other dtypes are clipped to 0..255 and truncated."""
    img = image if isinstance(image, torch.Tensor) \
        else torch.as_tensor(np.asarray(image))
    img = img.to(device)
    if img.dtype != torch.uint8:
        img = torch.clamp(img, 0, 255).to(torch.uint8)
    return bgr_to_gray(img) if img.ndim == 3 else img


class ORBDetector:
    """ORB (reference depth_enhanced_reconstruction.py:197-199: 2000
    features, 8 levels).

    backend: 'cv2' (OpenCV's C++ ORB), 'device' (``ops/orb.py`` on
    ``device``), 'auto' (see ``resolve_backend``). device: where features
    are computed and kept (``None``: the CUDA device; raises when there is
    none). Grey is ``bgr_to_gray`` on the device for the device backend,
    ``cv2.cvtColor`` for OpenCV's (the same values).
    """

    def __init__(self, n_features: int = 2000, n_levels: int = 8,
                 capacity: int = 2048, backend: str = "auto", device=None):
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.n_levels = n_levels
        self.capacity = capacity
        if self.backend == "cv2":
            cv2 = require_cv2("the 'cv2' feature backend")
            self.orb = cv2.ORB_create(nfeatures=n_features,
                                      nlevels=n_levels)

    @torch.no_grad()
    def detect(self, bgr) -> Features:
        """Features of one (H, W, 3) BGR or (H, W) grey image."""
        if self.backend == "device":
            f = orb_features(gray_u8(bgr, self.device),
                             capacity=self.capacity, n_levels=self.n_levels)
            return Features(f.uv, f.desc, f.mask, "orb")
        cv2 = require_cv2("the 'cv2' feature backend")
        img = bgr.cpu().numpy() if isinstance(bgr, torch.Tensor) \
            else np.asarray(bgr)
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 \
            else img
        kps, desc = self.orb.detectAndCompute(gray, None)
        if desc is None or len(kps) == 0:
            return _pad_features(np.zeros((0, 2), np.float32),
                                 np.zeros((0, 32), np.uint8), self.capacity,
                                 "orb", self.device)
        uv = np.array([kp.pt for kp in kps], np.float32)
        return _pad_features(uv, desc, self.capacity, "orb", self.device)


def match_features(f1: Features, f2: Features, ratio: float = 0.75
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ratio-test match two feature sets on their device.

    Returns (uv1 (N, 2), uv2 (N, 2), mask (N,)) fixed-capacity
    correspondences aligned to f1's capacity.
    """
    if f1.kind == "sift":
        idx2, ok = match_l2_ratio(f1.desc, f2.desc, f1.mask, f2.mask, ratio)
    else:
        idx2, ok = match_hamming_ratio(unpack_bits(f1.desc),
                                       unpack_bits(f2.desc), f1.mask,
                                       f2.mask, ratio)
    return f1.uv, f2.uv[idx2], ok


def dedupe_matches(uv1, uv2, mask, px_threshold: float = 2.0) -> np.ndarray:
    """Drop near-duplicate correspondences on the host (reference O(n^2)
    loop at depth_enhanced_reconstruction.py:388-406, vectorised): keep the
    first of any pair whose endpoints both lie within px_threshold.
    Tensors are copied to the host; returns a numpy bool mask."""
    uv1, uv2, mask = (a.cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a) for a in (uv1, uv2, mask))
    valid_idx = np.where(mask)[0]
    keep = mask.copy()
    if len(valid_idx) == 0:
        return keep
    a = uv1[valid_idx]
    b = uv2[valid_idx]
    # Quantise to a grid of px_threshold cells; duplicates share a cell.
    key = np.stack([
        np.floor(a[:, 0] / px_threshold), np.floor(a[:, 1] / px_threshold),
        np.floor(b[:, 0] / px_threshold), np.floor(b[:, 1] / px_threshold),
    ], axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    dup = np.ones(len(valid_idx), bool)
    dup[first] = False
    keep[valid_idx[dup]] = False
    return keep
