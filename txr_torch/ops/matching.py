"""Descriptor matching as one product, the counterpart of
``txr/ops/matching.py``.

- L2 (SIFT float descriptors): ||a-b||^2 = |a|^2 + |b|^2 - 2 a.b, the cross
  term one (N1, N2) ``torch.matmul``.
- Hamming (ORB binary descriptors): with bits unpacked to {0,1},
  H(a,b) = |a| + |b| - 2 a.b, also a product.

Lowe ratio test on the two smallest distances of each row. Outputs are
fixed-capacity masked index pairs.
"""

from __future__ import annotations

import torch

from txr_torch.core.precision import f32_dots

_BIG = 3.0e38


def _two_smallest(d: torch.Tensor):
    """(best, second, index of best) per row. ``torch.topk`` does not order
    ties as ``jax.lax.top_k`` does, but no tie reaches a match: the two
    values are the same either way, and a best tied with the second fails
    the ratio test."""
    vals, idx = torch.topk(d, 2, dim=-1, largest=False, sorted=True)
    return vals[:, 0], vals[:, 1], idx[:, 0]


@f32_dots
def match_l2_ratio(desc1: torch.Tensor, desc2: torch.Tensor,
                   mask1: torch.Tensor, mask2: torch.Tensor,
                   ratio: float = 0.75):
    """One-directional Lowe ratio-test matching for float descriptors (best
    desc2 candidate per desc1 row; no cross-check: several desc1 rows may
    map to one desc2 index, as FLANN knnMatch(k=2) + ratio).

    desc1: (N1, D), desc2: (N2, D) float32; mask1 / mask2 validity.
    Returns idx2 (N1,) int64, match_mask (N1,) bool.
    """
    sq1 = (desc1 * desc1).sum(-1)
    sq2 = (desc2 * desc2).sum(-1)
    d2 = sq1[:, None] + sq2[None, :] - 2.0 * torch.matmul(desc1, desc2.T)
    d2 = torch.clamp(d2, min=0.0)
    d2 = torch.where(mask2[None, :], d2, _BIG)
    best, second, idx = _two_smallest(d2)
    # Lowe ratio on distances (not squared). A row with no valid second
    # neighbour is dropped (OpenCV knnMatch(k=2)).
    ok = torch.sqrt(best) < ratio * torch.sqrt(torch.clamp(second, min=1e-20))
    ok = ok & mask1 & (best < 1.0e37) & (second < 1.0e37)
    return idx, ok


@f32_dots
def match_hamming_ratio(bits1: torch.Tensor, bits2: torch.Tensor,
                        mask1: torch.Tensor, mask2: torch.Tensor,
                        ratio: float = 0.75):
    """Ratio-test matching for binary descriptors unpacked to {0,1} float:
    bits1 (N1, B), bits2 (N2, B); Hamming distance |a| + |b| - 2 a.b."""
    pop1 = bits1.sum(-1)
    pop2 = bits2.sum(-1)
    h = pop1[:, None] + pop2[None, :] - 2.0 * torch.matmul(bits1, bits2.T)
    h = torch.where(mask2[None, :], h, _BIG)
    best, second, idx = _two_smallest(h)
    ok = best < ratio * torch.clamp(second, min=1e-6)
    ok = ok & mask1 & (best < 1.0e37) & (second < 1.0e37)
    return idx, ok


def unpack_bits(desc_u8: torch.Tensor) -> torch.Tensor:
    """(N, B/8) uint8 packed descriptors -> (N, B) float32 {0,1} bits, most
    significant bit first (``numpy.unpackbits``)."""
    shifts = torch.arange(7, -1, -1, device=desc_u8.device,
                          dtype=torch.uint8)
    bits = (desc_u8.to(torch.uint8)[..., None] >> shifts) & 1
    return bits.reshape(*desc_u8.shape[:-1], -1).to(torch.float32)
