"""Hybrid feature detection + matching for textureless surfaces, the
counterpart of ``txr/geometry/hybrid.py`` (reference
HybridFeatureDetector / DepthGuidedMatcher,
depth_enhanced_reconstruction.py:178-528): SIFT + ORB + LSD line-endpoint
features with NCC patch verification, ratio-test matching, duplicate
removal and a depth-consistency filter.

Detection has two backends, as in ``txr``: ``"cv2"`` (OpenCV's C++ SIFT,
ORB, LSD and Canny, imported at first use) and ``"device"`` (the port's
``ops/{sift,orb,lsd,canny}.py`` on the detector's device). Descriptor
matching is a product on the device (``ops/matching.py``); the line
endpoints' NCC check and the depth filter stay host numpy, as in ``txr``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.geometry.features import (Features, _pad_features,
                                         dedupe_matches, gray_u8,
                                         resolve_backend)
from txr_torch.io.opencv import require_cv2
from txr_torch.ops.canny import canny
from txr_torch.ops.lsd import lsd_lines
from txr_torch.ops.matching import (match_hamming_ratio, match_l2_ratio,
                                    unpack_bits)
from txr_torch.ops.orb import orb_features
from txr_torch.ops.sift import sift_features


@dataclass
class HybridFeatures:
    sift: Optional[Features]           # tensors on the detector's device
    orb: Optional[Features]
    lines: Optional[np.ndarray]        # (L, 4) x1 y1 x2 y2
    edges: Optional[np.ndarray]        # (H, W) uint8 Canny map
    gray: np.ndarray


def _matched(f1: Features, f2: Features, idx2: torch.Tensor,
             ok: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """The matched rows' (uv1, uv2) on the host, in one copy."""
    rows = torch.cat([f1.uv, f2.uv[idx2], ok[:, None].to(f1.uv.dtype)], 1)
    rows = rows.cpu().numpy()
    keep = rows[:, 4] > 0
    return rows[keep, :2], rows[keep, 2:4]


class HybridFeatureDetector:
    """SIFT(3000, 0.02) + ORB(2000, 8 levels) + LSD lines + Canny(50, 150).

    backend: 'cv2' rides OpenCV C++ (the reference's substrate), 'device'
    runs every stage on ``device`` (``ops/{sift,orb,lsd,canny}.py``),
    'auto' resolves as ``geometry/features.py:resolve_backend`` does.
    device: where features are computed and kept (``None``: the CUDA
    device; raises when there is none).
    """

    BATCH = 4  # frames per host copy of the device batch

    def __init__(self, use_sift: bool = True, use_orb: bool = True,
                 use_lines: bool = True, use_edges: bool = True,
                 sift_capacity: int = 3072, orb_capacity: int = 2048,
                 verbose: bool = True, backend: str = "auto", device=None):
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.use_sift = use_sift
        self.use_orb = use_orb
        self.use_lines = use_lines
        self.use_edges = use_edges
        self.verbose = verbose
        self.sift_capacity = sift_capacity
        self.orb_capacity = orb_capacity
        if self.backend == "cv2":
            cv2 = require_cv2("the 'cv2' feature backend")
            if use_sift:
                self.sift = cv2.SIFT_create(nfeatures=3000,
                                            contrastThreshold=0.02)
            if use_orb:
                self.orb = cv2.ORB_create(nfeatures=2000, scaleFactor=1.2,
                                          nlevels=8)
            if use_lines:
                self.lsd = cv2.createLineSegmentDetector(cv2.LSD_REFINE_STD)

    def _log(self, msg):
        if self.verbose:
            print(msg)

    # ------------------------------------------------------------ detection

    def detect(self, image) -> HybridFeatures:
        """Hybrid features of one (H, W, 3) BGR or (H, W) grey image."""
        if self.backend == "device":
            return self.detect_batch([image])[0]
        cv2 = require_cv2("the 'cv2' feature backend")
        img = image.cpu().numpy() if isinstance(image, torch.Tensor) \
            else np.asarray(image)
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if img.ndim == 3 \
            else img
        sift = orb = None
        lines = edges = None
        if self.use_sift:
            kps, desc = self.sift.detectAndCompute(gray, None)
            uv = np.array([k.pt for k in kps], np.float32) if kps \
                else np.zeros((0, 2), np.float32)
            d = desc.astype(np.float32) if desc is not None \
                else np.zeros((0, 128), np.float32)
            sift = _pad_features(uv, d, self.sift_capacity, "sift",
                                 self.device)
            self._log(f"  SIFT: {len(uv)} keypoints")
        if self.use_orb:
            kps, desc = self.orb.detectAndCompute(gray, None)
            uv = np.array([k.pt for k in kps], np.float32) if kps \
                else np.zeros((0, 2), np.float32)
            d = desc if desc is not None else np.zeros((0, 32), np.uint8)
            orb = _pad_features(uv, d, self.orb_capacity, "orb", self.device)
            self._log(f"  ORB: {len(uv)} keypoints")
        if self.use_lines:
            out = self.lsd.detect(gray)
            raw = out[0] if out is not None else None
            lines = raw.reshape(-1, 4) if raw is not None \
                else np.zeros((0, 4), np.float32)
            self._log(f"  Lines: {len(lines)} segments")
        if self.use_edges:
            edges = cv2.Canny(gray, 50, 150)
            self._log(f"  Edge points: {int((edges > 0).sum())}")
        return HybridFeatures(sift=sift, orb=orb, lines=lines, edges=edges,
                              gray=gray)

    @torch.no_grad()
    def _device_frame(self, image) -> dict:
        """The four stages of one frame on the device; nothing is read
        back."""
        g = gray_u8(image, self.device)
        out = {"gray": g}
        if self.use_sift:
            f = sift_features(g, capacity=self.sift_capacity,
                              contrast_threshold=0.02)
            out["sift"] = Features(f.uv, f.desc, f.mask, "sift")
        if self.use_orb:
            f = orb_features(g, capacity=self.orb_capacity, n_levels=8)
            out["orb"] = Features(f.uv, f.desc, f.mask, "orb")
        if self.use_lines:
            ln = lsd_lines(g)
            out["lines"] = (ln.lines, ln.mask)
        if self.use_edges:
            out["edges"] = canny(g, 50.0, 150.0)
        return out

    def detect_batch(self, images) -> list:
        """Hybrid features of every image of a sequence. The device backend
        runs the frames one after another on the device and copies each
        group of BATCH frames to the host together (grey and edge maps,
        lines, keypoint counts), with no read-back between stages; SIFT and
        ORB stay on the device. The cv2 backend keeps the per-frame C++
        loop."""
        if self.backend != "device":
            return [self.detect(im) for im in images]
        out: list = [None] * len(images)
        groups: dict = {}      # folders may mix shapes: stack per shape
        for i, im in enumerate(images):
            groups.setdefault(tuple(im.shape[:2]), []).append(i)
        for idx in groups.values():
            for s in range(0, len(idx), self.BATCH):
                chunk = idx[s:s + self.BATCH]
                frames = [self._device_frame(images[i]) for i in chunk]
                for i, f in zip(chunk, self._to_host(frames)):
                    out[i] = f
        return out

    def _to_host(self, frames: list) -> list:
        """One batch of device frames -> HybridFeatures, with one copy per
        kind of host data."""
        def host(get):
            return torch.stack([get(f) for f in frames]).cpu().numpy()

        gray = host(lambda f: f["gray"])
        edges = host(lambda f: f["edges"]) if self.use_edges else None
        if self.use_lines:
            lines = host(lambda f: f["lines"][0])
            lmask = host(lambda f: f["lines"][1])
        kinds = [k for k in ("sift", "orb") if k in frames[0]]
        counts = {k: host(lambda f, k=k: f[k].mask.sum()) for k in kinds}
        res = []
        for j, f in enumerate(frames):
            for k in kinds:
                self._log(f"  {k.upper()}: {int(counts[k][j])} keypoints")
            hf = HybridFeatures(sift=f.get("sift"), orb=f.get("orb"),
                                lines=None, edges=None, gray=gray[j])
            if self.use_lines:
                hf.lines = lines[j][lmask[j]]
                self._log(f"  Lines: {len(hf.lines)} segments")
            if self.use_edges:
                hf.edges = edges[j]
                self._log(f"  Edge points: {int((hf.edges > 0).sum())}")
            res.append(hf)
        return res

    # ------------------------------------------------------------- matching

    def match_features(self, f1: HybridFeatures, f2: HybridFeatures,
                       ratio_thresh: float = 0.75
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns dense (pts1 (M, 2), pts2 (M, 2)) matched pairs (host
        arrays)."""
        all1, all2 = [], []
        if f1.sift is not None and f2.sift is not None:
            idx2, ok = match_l2_ratio(f1.sift.desc, f2.sift.desc,
                                      f1.sift.mask, f2.sift.mask,
                                      ratio_thresh)
            a, b = _matched(f1.sift, f2.sift, idx2, ok)
            all1.append(a)
            all2.append(b)
            self._log(f"  SIFT matches: {len(a)}")
        if f1.orb is not None and f2.orb is not None:
            idx2, ok = match_hamming_ratio(
                unpack_bits(f1.orb.desc), unpack_bits(f2.orb.desc),
                f1.orb.mask, f2.orb.mask, ratio_thresh)
            a, b = _matched(f1.orb, f2.orb, idx2, ok)
            all1.append(a)
            all2.append(b)
            self._log(f"  ORB matches: {len(a)}")
        if f1.lines is not None and f2.lines is not None:
            l1, l2 = match_line_endpoints(f1.lines, f2.lines, f1.gray,
                                          f2.gray)
            if len(l1):
                all1.append(l1)
                all2.append(l2)
            self._log(f"  Line endpoint matches: {len(l1)}")

        if not all1 or sum(len(a) for a in all1) == 0:
            return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)
        pts1 = np.concatenate(all1).astype(np.float32)
        pts2 = np.concatenate(all2).astype(np.float32)
        mask = np.ones(len(pts1), bool)
        keep = dedupe_matches(pts1, pts2, mask, px_threshold=2.0)
        self._log(f"  Total unique matches: {int(keep.sum())}")
        return pts1[keep], pts2[keep]


def match_line_endpoints(lines1: np.ndarray, lines2: np.ndarray,
                         gray1: np.ndarray, gray2: np.ndarray,
                         search_radius: float = 30.0,
                         max_endpoints: int = 200, patch_size: int = 11,
                         ncc_thresh: float = 0.7
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest line-endpoint matching verified by 11x11 NCC (host numpy,
    as ``txr``'s vectorised rebuild of reference :322-386)."""
    if len(lines1) == 0 or len(lines2) == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)
    ep1 = lines1[:, :4].reshape(-1, 2)[:max_endpoints]
    ep2 = lines2[:, :4].reshape(-1, 2)

    # all-pairs distances, nearest within the radius
    d = np.linalg.norm(ep1[:, None, :] - ep2[None, :, :], axis=-1)  # (m, n)
    best = d.argmin(axis=1)
    ok = d[np.arange(len(ep1)), best] < search_radius
    if not ok.any():
        return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)

    p1 = ep1[ok]
    p2 = ep2[best[ok]]
    half = patch_size // 2

    def extract(gray, pts):
        h, w = gray.shape
        x = pts[:, 0].astype(int)
        y = pts[:, 1].astype(int)
        inb = (x >= half) & (x + half < w) & (y >= half) & (y + half < h)
        patches = np.zeros((len(pts), patch_size, patch_size), np.float32)
        for i in np.where(inb)[0]:  # bounded by max_endpoints
            patches[i] = gray[y[i] - half:y[i] + half + 1,
                              x[i] - half:x[i] + half + 1]
        return patches, inb

    pa, in1 = extract(gray1, p1)
    pb, in2 = extract(gray2, p2)
    valid = in1 & in2
    pa = pa.reshape(len(pa), -1)
    pb = pb.reshape(len(pb), -1)
    pa = (pa - pa.mean(axis=1, keepdims=True)) \
        / (pa.std(axis=1, keepdims=True) + 1e-6)
    pb = (pb - pb.mean(axis=1, keepdims=True)) \
        / (pb.std(axis=1, keepdims=True) + 1e-6)
    ncc = (pa * pb).mean(axis=1)
    keep = valid & (ncc > ncc_thresh)
    return p1[keep].astype(np.float32), p2[keep].astype(np.float32)


class DepthGuidedMatcher:
    """Depth-consistency match filter (reference :413-483, host numpy)."""

    def __init__(self, depth_consistency_thresh: float = 0.15):
        self.depth_thresh = depth_consistency_thresh

    def filter_matches_by_depth(self, pts1, pts2, depth1, depth2):
        if depth1 is None or depth2 is None or len(pts1) < 4:
            return pts1, pts2
        h1, w1 = depth1.shape
        h2, w2 = depth2.shape
        x1 = pts1[:, 0].astype(int)
        y1 = pts1[:, 1].astype(int)
        x2 = pts2[:, 0].astype(int)
        y2 = pts2[:, 1].astype(int)
        inb = ((x1 >= 0) & (x1 < w1) & (y1 >= 0) & (y1 < h1) &
               (x2 >= 0) & (x2 < w2) & (y2 >= 0) & (y2 < h2))
        idx = np.where(inb)[0]
        d1 = depth1[y1[idx], x1[idx]]
        d2 = depth2[y2[idx], x2[idx]]
        pos = (d1 > 0) & (d2 > 0)
        idx = idx[pos]
        if len(idx) < 4:
            return pts1, pts2
        d1, d2 = d1[pos], d2[pos]
        n1 = (d1 - d1.min()) / (d1.max() - d1.min() + 1e-6)
        n2 = (d2 - d2.min()) / (d2.max() - d2.min() + 1e-6)
        consistent = np.abs(n1 - n2) < self.depth_thresh
        rank1 = np.argsort(np.argsort(d1))
        rank2 = np.argsort(np.argsort(d2))
        rank_ok = np.abs(rank1 - rank2) / len(rank1) < 0.3
        final = consistent | rank_ok
        sel = idx[final]
        return pts1[sel], pts2[sel]


def generate_dense_correspondences(depth1: np.ndarray, depth2: np.ndarray,
                                   R: np.ndarray, t: np.ndarray,
                                   K: np.ndarray, grid_step: int = 16):
    """Dense grid correspondences from depth + a known pose (host numpy, as
    ``txr``'s rebuild of reference :485-528, which the reference defines
    but never calls).

    Back-projects a grid of image-1 pixels with depth1, moves them into
    camera 2, reprojects, and keeps in-bounds points with positive depth.
    Returns (pts1 (M, 2), pts2 (M, 2)) float32.
    """
    h, w = depth1.shape
    ys, xs = np.mgrid[0:h:grid_step, 0:w:grid_step]
    xs = xs.ravel().astype(np.float64)
    ys = ys.ravel().astype(np.float64)
    d = depth1[ys.astype(int), xs.astype(int)]
    ok = d > 0
    xs, ys, d = xs[ok], ys[ok], d[ok]

    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    P1 = np.stack([(xs - cx) * d / fx, (ys - cy) * d / fy, d], axis=1)
    P2 = P1 @ np.asarray(R).T + np.asarray(t).reshape(1, 3)
    front = P2[:, 2] > 0
    P2, xs, ys = P2[front], xs[front], ys[front]
    u2 = fx * P2[:, 0] / P2[:, 2] + cx
    v2 = fy * P2[:, 1] / P2[:, 2] + cy
    inb = (u2 >= 0) & (u2 < w) & (v2 >= 0) & (v2 < h)
    pts1 = np.stack([xs[inb], ys[inb]], axis=1).astype(np.float32)
    pts2 = np.stack([u2[inb], v2[inb]], axis=1).astype(np.float32)
    return pts1, pts2
