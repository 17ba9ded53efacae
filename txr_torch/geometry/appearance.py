"""Keyframe appearance sketches for loop-closure candidate gating, the
counterpart of ``txr/geometry/appearance.py`` (host numpy, bit-equal).

The reference's live mode retrieves loop candidates from rtabmap_slam's
bag-of-words memory (slam.launch.py:126-145) before any geometric check.
Here each keyframe keeps a compact VLAD-style sketch: L2-normalised local
descriptors are assigned to the nearest of K fixed random unit anchors, the
per-anchor residual sums are intra-normalised (per-cluster L2,
Arandjelovic & Zisserman, "All about VLAD", CVPR 2013) and the
concatenation is L2-normalised. Similarity is a dot product in [-1, 1], so
scoring the whole keyframe history is one small host product. The anchors
come from a fixed seed, so sketches compare across sessions and processes.
``appearance_sketch_device`` computes the same sketch on the descriptors'
device, for the fused stream, whose keyframe descriptors stay there.
"""

from __future__ import annotations

import numpy as np
import torch

from txr_torch.core.device import device_constant
from txr_torch.core.precision import f32_dots

N_ANCHORS = 16


_anchor_cache: dict[int, np.ndarray] = {}


def _anchors(dim: int) -> np.ndarray:
    a = _anchor_cache.get(dim)
    if a is None:
        rng = np.random.default_rng(0x7c5)
        a = rng.standard_normal((N_ANCHORS, dim)).astype(np.float32)
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        _anchor_cache[dim] = a
    return a


def sketch_dim(desc_dim: int) -> int:
    return N_ANCHORS * desc_dim


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def appearance_sketch(desc, mask) -> np.ndarray:
    """(capacity, D) descriptors + validity mask (numpy or tensors; one
    copy to the host) -> (N_ANCHORS*D,) unit sketch.

    All-invalid input returns the zero vector (scores 0 against everything,
    so such keyframes never gate in as candidates)."""
    desc = _host(desc).astype(np.float32, copy=False)
    mask = _host(mask).astype(bool)
    dim = desc.shape[1]
    d = desc[mask]
    if d.shape[0] == 0:
        return np.zeros(N_ANCHORS * dim, np.float32)
    norms = np.linalg.norm(d, axis=1, keepdims=True)
    d = d / np.maximum(norms, 1e-12)
    anchors = _anchors(dim)
    assign = np.argmax(d @ anchors.T, axis=1)
    resid = d - anchors[assign]
    sk = np.zeros((N_ANCHORS, dim), np.float32)
    np.add.at(sk, assign, resid)
    # Intra-normalisation: each cluster contributes equally, which damps
    # bursty repeated structure (the textureless-tunnel failure mode).
    cn = np.linalg.norm(sk, axis=1, keepdims=True)
    sk = np.where(cn > 1e-12, sk / np.maximum(cn, 1e-12), sk)
    flat = sk.ravel()
    n = float(np.linalg.norm(flat))
    if n > 1e-12:
        flat = flat / n
    return flat.astype(np.float32)


@f32_dots
def appearance_sketch_device(desc: torch.Tensor, mask: torch.Tensor
                             ) -> torch.Tensor:
    """``appearance_sketch`` on the descriptors' device, the counterpart of
    ``txr``'s ``appearance_sketch_jax``: (capacity, D) descriptors + mask ->
    (N_ANCHORS*D,) f32 sketch, still on the device.

    The per-anchor residual sums are a one-hot product in place of
    ``np.add.at``, so the result matches the host sketch up to f32
    summation order; nothing is read back, and only the sketch need cross
    to the host (the descriptors stay where they are)."""
    desc = desc.to(torch.float32)
    dim = desc.shape[1]
    anchors = device_constant(_anchors(dim), desc.device)     # (K, D)
    tiny = desc.new_full((), 1e-12)
    d = desc / torch.maximum(torch.linalg.vector_norm(desc, dim=1,
                                                      keepdim=True), tiny)
    assign = torch.argmax(d @ anchors.T, dim=1)               # (N,)
    k = torch.arange(N_ANCHORS, device=desc.device)
    onehot = ((assign[:, None] == k[None, :]).to(torch.float32)
              * mask.to(torch.float32)[:, None])              # (N, K)
    # per anchor k: the sum over its rows of (d_i - anchor_k)
    sk = onehot.T @ d - onehot.sum(dim=0)[:, None] * anchors  # (K, D)
    cn = torch.linalg.vector_norm(sk, dim=1, keepdim=True)
    sk = torch.where(cn > 1e-12, sk / torch.maximum(cn, tiny), sk)
    flat = sk.reshape(-1)
    n = torch.linalg.vector_norm(flat)
    return torch.where(n > 1e-12, flat / torch.maximum(n, tiny), flat)


def appearance_scores(sketches: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(n, S) stacked sketches x (S,) query -> (n,) cosine scores."""
    if sketches.size == 0:
        return np.zeros(0, np.float32)
    return np.asarray(sketches, np.float32) @ np.asarray(query, np.float32)
