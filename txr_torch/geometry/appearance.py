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
"""

from __future__ import annotations

import numpy as np
import torch

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


def appearance_scores(sketches: np.ndarray, query: np.ndarray) -> np.ndarray:
    """(n, S) stacked sketches x (S,) query -> (n,) cosine scores."""
    if sketches.size == 0:
        return np.zeros(0, np.float32)
    return np.asarray(sketches, np.float32) @ np.asarray(query, np.float32)
