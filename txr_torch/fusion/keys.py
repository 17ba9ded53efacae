"""Order-preserving packed voxel keys, the counterpart of
``txr/fusion/keys.py``.

(kx, ky, kz) signed int32 voxel coordinates pack into two int32 sort columns
(hi: x18|y14hi, lo: y4lo|z18) so a sort over (hi, lo) orders voxels
lexicographically; invalid rows carry the INT_MAX empty sentinel.

PyTorch has no usable uint32 arithmetic and ``>>`` on a negative int32 is an
arithmetic shift, so the fields are assembled in int64, where every 32-bit
pattern is a non-negative number, and narrowed to int32 at the end. The
"xor the sign bit, then read as int32" step of ``txr`` is the subtraction of
2^31 there.
"""

from __future__ import annotations

import torch

from txr_torch.ops.segment import INT_MAX

HALF_RANGE = 1 << 17  # 2^17 cells per semi-axis
_BIAS = 1 << 31


def pack_keys(kx: torch.Tensor, ky: torch.Tensor, kz: torch.Tensor,
              valid: torch.Tensor):
    """(kx, ky, kz) int32 -> (hi, lo) int32, order-preserving; invalid rows
    get (INT_MAX, INT_MAX).

    The upper clip is HALF_RANGE - 2 (one voxel tighter than the lower
    side) so no packed field is ever all-ones on a valid row: at - 1 a far
    +corner voxel would pack to exactly INT_MAX, the empty sentinel, and be
    dropped. Boundary points merge one voxel inward."""
    ox = kx.long().clamp(-HALF_RANGE + 1, HALF_RANGE - 2) + HALF_RANGE
    oy = ky.long().clamp(-HALF_RANGE + 1, HALF_RANGE - 2) + HALF_RANGE
    oz = kz.long().clamp(-HALF_RANGE + 1, HALF_RANGE - 2) + HALF_RANGE
    hi_u = (ox << 14) | (oy >> 4)           # 18 + 14 = 32 bits
    lo_u = ((oy & 15) << 18) | oz           # 4 + 18 = 22 bits
    hi = (hi_u - _BIAS).to(torch.int32)     # unsigned order as signed int32
    lo = lo_u.to(torch.int32)
    sentinel = torch.full_like(hi, INT_MAX)
    return torch.where(valid, hi, sentinel), torch.where(valid, lo, sentinel)


def unpack_keys(hi: torch.Tensor, lo: torch.Tensor):
    """(hi, lo) -> (kx, ky, kz) int32; only meaningful on valid rows."""
    hi_u = hi.long() + _BIAS
    lo_u = lo.long() & 0xFFFFFFFF
    ox = hi_u >> 14
    oy = ((hi_u & 0x3FFF) << 4) | (lo_u >> 18)
    oz = lo_u & 0x3FFFF
    return ((ox - HALF_RANGE).to(torch.int32),
            (oy - HALF_RANGE).to(torch.int32),
            (oz - HALF_RANGE).to(torch.int32))
