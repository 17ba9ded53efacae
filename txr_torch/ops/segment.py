"""Segment reduction helpers, the counterpart of ``txr/ops/segment.py``.

Only what the packed voxel map needs is here: the empty-key sentinel and the
log-step segmented prefix sum, which is the plain PyTorch version of the
segmented-scan kernel in ``txr_torch/ops/scan.py``.
"""

from __future__ import annotations

import torch

INT_MAX = 2147483647  # int32 maximum: the empty / invalid key sentinel


def segmented_cumsum(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per-segment inclusive prefix sums.

    vals: (N, D) float32; starts: (N,) bool, True at each segment's first
    row (row 0 starts a segment whether flagged or not).

    Hillis-Steele segmented scan in ceil(log2 N) steps of shift + masked
    add: v_i += v_{i-d} unless a segment boundary lies within distance d,
    f_i |= f_{i-d}. The value at a segment's last row is its total.
    """
    n = vals.shape[0]
    f = starts.to(vals.dtype)[:, None]
    v = vals
    d = 1
    while d < n:
        vs = torch.cat([v.new_zeros((d, v.shape[1])), v[:-d]], dim=0)
        fs = torch.cat([f.new_ones((d, 1)), f[:-d]], dim=0)
        v = v + (1.0 - f) * vs
        f = torch.maximum(f, fs)
        d *= 2
    return v
