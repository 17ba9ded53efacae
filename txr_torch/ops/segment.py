"""Segment reductions of the fusion ops, the counterpart of
``txr/ops/segment.py``.

Rows are grouped by three int32 keys (a voxel's coordinates) with a
lexicographic sort, and each group's columns are summed by a segmented
prefix sum that restarts at every group: the value at a group's last row is
its total. On CUDA tensors that sum is the segmented-scan kernel
(``txr_torch/ops/scan.py:segmented_cumsum_cols``), on CPU tensors its plain
version, :func:`segmented_cumsum` below.

``txr`` takes ``sorted_voxel_reduce``'s sums as differences of one global
f32 cumulative sum over all rows; its rounding error grows with the row
count times the coordinates' magnitude and lands in every group's sum
(centimetres to metres at the fusion CLI's sizes). The scan restarts at
each group, so each group's rows are summed as far as f32 allows, which is
the function both packages document. ``txr``'s sort is unstable and the
port's stable, so the rows of one group may be summed in another order.
"""

from __future__ import annotations

from typing import Tuple

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


def lexsort3(kx: torch.Tensor, ky: torch.Tensor, kz: torch.Tensor
             ) -> torch.Tensor:
    """The permutation that sorts rows by (kx, ky, kz), ascending and
    stable, for any int32 keys (negative ones and INT_MAX included).

    Two stable passes: (ky, kz) packed into one int64 as ky * 2^32 + (kz +
    2^31), which orders every pair of int32 lexicographically, then kx.
    """
    yz = ky.to(torch.int64) * (1 << 32) + (kz.to(torch.int64) + (1 << 31))
    perm = torch.sort(yz, stable=True)[1]
    return perm[torch.sort(kx[perm], stable=True)[1]]


def _sorted_segments(kx, ky, kz, cols):
    """Sort rows by (kx, ky, kz); the sorted keys, the segment starts and
    ends, and each column's per-segment inclusive prefix sums."""
    from txr_torch.ops.scan import segmented_cumsum_cols

    perm = lexsort3(kx, ky, kz)
    skx, sky, skz = kx[perm], ky[perm], kz[perm]
    change = ((skx[1:] != skx[:-1]) | (sky[1:] != sky[:-1])
              | (skz[1:] != skz[:-1]))
    one = torch.ones((1,), dtype=torch.bool, device=kx.device)
    starts = torch.cat([one, change])
    last = torch.cat([change, one])
    seg = segmented_cumsum_cols(tuple(c[perm] for c in cols), starts)
    return skx, sky, skz, starts, last, seg


def sorted_voxel_reduce(kx: torch.Tensor, ky: torch.Tensor,
                        kz: torch.Tensor, cols: Tuple[torch.Tensor, ...],
                        capacity: int):
    """Group rows by (kx, ky, kz) and sum each column per group.

    Args:
      kx, ky, kz: (N,) int32 keys. Invalid rows should carry INT_MAX keys
        and zeroed columns (they form a zero-weight tail segment).
      cols: 1 to 8 (N,) float32 columns to segment-sum. Include a weight
        column to derive counts / validity.
      capacity: number of output rows (first ``capacity`` segments in key
        order; at most N).

    Returns:
      (okx, oky, okz, ocols, valid): each (min(capacity, N),) — one row per
      segment, in ascending key order; ``valid`` is False for slots past the
      last segment, whose keys are INT_MAX and sums 0. ocols are segment
      SUMS. Nothing is read back to the host.
    """
    n = kx.shape[0]
    cap = min(capacity, n)
    if n == 0:
        return kx, ky, kz, tuple(cols), torch.zeros_like(kx, dtype=torch.bool)
    skx, sky, skz, _, last, seg = _sorted_segments(kx, ky, kz, cols)
    # the j-th segment ends at the first row where the running count of
    # segment ends reaches j + 1; no such row (n) past the last segment
    ends = torch.searchsorted(torch.cumsum(last, 0),
                              torch.arange(1, cap + 1, device=kx.device))
    is_seg = ends < n
    ends = torch.clamp(ends, max=n - 1)
    okx, oky, okz = (torch.where(is_seg, k[ends], INT_MAX)
                     for k in (skx, sky, skz))
    ocols = tuple(torch.where(is_seg, s[ends], 0.0) for s in seg)
    return okx, oky, okz, ocols, is_seg


def sorted_segment_reduce_at_ends(kx: torch.Tensor, ky: torch.Tensor,
                                  kz: torch.Tensor,
                                  cols: Tuple[torch.Tensor, ...],
                                  capacity: int):
    """Group rows by (kx, ky, kz); emit each group's column sums AT its
    segment-end row.

    The output is not compacted: row i of the output is row i of the
    sorted order — a segment end carrying that segment's totals, or an
    INT_MAX hole (as are the ends of INT_MAX-keyed segments). Rows past
    ``capacity`` are dropped, so a segment whose end falls beyond the first
    ``capacity`` sorted rows is lost.

    Returns (okx, oky, okz, ocols, valid): each (min(capacity, N),).
    """
    if kx.shape[0] == 0:
        return kx, ky, kz, tuple(cols), torch.zeros_like(kx, dtype=torch.bool)
    skx, sky, skz, _, last, seg = _sorted_segments(kx, ky, kz, cols)
    emit = last & (skx != INT_MAX)
    okx, oky, okz = (torch.where(emit, k, INT_MAX)[:capacity]
                     for k in (skx, sky, skz))
    ocols = tuple(torch.where(emit, s, 0.0)[:capacity] for s in seg)
    return okx, oky, okz, ocols, emit[:capacity]
