"""The mean-offset voxel map's insert, in plain PyTorch with float64 sums.

What an insert means (the semantics of ``txr``'s packed map, which the
program keeps bit for bit):

- a valid point p (float32) falls in voxel k = floor(p / s) per axis, with
  p / s rounded to float32 and k clamped to [-2^17 + 1, 2^17 - 2]; its
  offset in the voxel, p / s - floor(p / s), is kept as a 10-bit quantum
  q = floor(1024 * offset) and its colour as 8-bit quanta floor(256 * c),
  each clamped to its range;
- a stored voxel is a key, a weight w (at most 2047) and the mean offset
  and colour as quanta; it counts as w contributions at the quanta's
  midpoints, (q + 0.5) / 1024 and (c + 0.5) / 256; a point counts once, at
  its own quanta's midpoints;
- after an insert each voxel holds the weighted mean of all its
  contributions, quantised again by floor, its weight is the sum capped at
  2047, and the map keeps the ``capacity`` voxels of lowest key in
  (x, y, z) order.

``decode`` reads the program's four packed int32 columns (the layout of
``txr/fusion/offset_map.py``: key x18 | y14 high bits with the sign bit
flipped, then y4 low | z18 | the x-offset quantum, then y and z quanta and
the weight, then the colour bytes) into that form, so that a map the
program holds can be compared with one this module computes.
"""

from __future__ import annotations

from typing import Dict

import torch

HALF = 1 << 17
INT32_MAX = 2 ** 31 - 1
W_MAX = 2047
FIELDS = ("qx", "qy", "qz", "r", "g", "b")


def decode(cols) -> Dict[str, torch.Tensor]:
    """Occupied rows of a packed map (khi, klo_x, yzw, rgb), in storage
    order: key (int64, ordered as (x, y, z)), weight and the six quanta."""
    khi, klo, yzw, rgb = (c.to(torch.int64) for c in cols[:4])
    w = (yzw & 0xFFFFFFFF) & 0x7FF
    occ = (w > 0) & (khi != INT32_MAX)
    hi = khi[occ] + (1 << 31)
    lo = klo[occ] + (1 << 31)
    u = yzw[occ] & 0xFFFFFFFF
    c = rgb[occ] & 0xFFFFFFFF
    ox = hi >> 14
    oy = ((hi & 0x3FFF) << 4) | (lo >> 28)
    oz = (lo >> 10) & 0x3FFFF
    return {"key": key_of(ox - HALF, oy - HALF, oz - HALF), "w": w[occ],
            "qx": lo & 0x3FF, "qy": (u >> 21) & 0x3FF,
            "qz": (u >> 11) & 0x3FF, "r": (c >> 16) & 0xFF,
            "g": (c >> 8) & 0xFF, "b": c & 0xFF}


def key_of(kx, ky, kz) -> torch.Tensor:
    """(x, y, z) voxel coordinates -> one int64 in their lexicographic
    order."""
    return (((kx + HALF) << 36) | ((ky + HALF) << 18) | (kz + HALF))


def point_rows(xyz, rgb, mask, voxel: float, dtype=torch.float32
               ) -> Dict[str, torch.Tensor]:
    """Valid points as weight-1 rows. ``dtype`` other than float32 divides
    by the voxel size in that type (a control)."""
    s = torch.tensor(voxel, dtype=torch.float32).to(dtype)
    g = (xyz[mask].to(dtype) / s.to(xyz.device)).to(torch.float32)
    cell = torch.floor(g)
    k = cell.to(torch.int64).clamp(-HALF + 1, HALF - 2)
    q = torch.floor((g - cell) * 1024).clamp(0, 1023).to(torch.int64)
    c = torch.floor(rgb[mask] * 256).clamp(0, 255).to(torch.int64)
    return {"key": key_of(k[:, 0], k[:, 1], k[:, 2]),
            "w": torch.ones_like(k[:, 0]),
            "qx": q[:, 0], "qy": q[:, 1], "qz": q[:, 2],
            "r": c[:, 0], "g": c[:, 1], "b": c[:, 2]}


def insert(stored: Dict[str, torch.Tensor], points: Dict[str, torch.Tensor],
           capacity: int, dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """The map after an insert, as sorted rows. Sums in ``dtype`` (float64;
    a lower type is a control)."""
    return insert_counted(stored, points, capacity, dtype)[0]


def insert_counted(stored: Dict[str, torch.Tensor],
                   points: Dict[str, torch.Tensor], capacity: int,
                   dtype=torch.float64) -> tuple:
    """``insert`` and the number of voxels the map would hold without its
    capacity (those beyond it are dropped)."""
    rows = {f: torch.cat([stored[f], points[f]]) for f in stored}
    keys, inv = torch.unique(rows["key"], sorted=True, return_inverse=True)
    n = keys.shape[0]
    wgt = rows["w"].to(dtype)
    total = torch.zeros(n, dtype=dtype, device=keys.device).index_add_(
        0, inv, wgt)
    out = {"key": keys[:capacity],
           "w": total[:capacity].to(torch.int64).clamp(max=W_MAX)}
    for f in FIELDS:
        levels = 1024 if f.startswith("q") else 256
        mid = (rows[f].to(dtype) + 0.5) / levels
        s = torch.zeros(n, dtype=dtype, device=keys.device).index_add_(
            0, inv, mid * wgt)
        mean = (s[:capacity] / total[:capacity].clamp(min=1)).to(
            torch.float64)
        out[f] = torch.floor(mean * levels).clamp(0, levels - 1).to(
            torch.int64)
    return out, n


def empty(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros(0, dtype=torch.int64, device=device)
    return {f: z for f in ("key", "w") + FIELDS}


def compare(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    """``rows_diff``: voxels missing from either map or held in another
    place or with another weight; ``quanta_max``: the largest difference of
    a mean's quanta over the voxels both hold in the same place."""
    n_got, n_want = got["key"].shape[0], want["key"].shape[0]
    n = min(n_got, n_want)
    same = (got["key"][:n] == want["key"][:n]) & (got["w"][:n] ==
                                                  want["w"][:n])
    diff = abs(n_got - n_want) + int((~same).sum())
    qmax = 0
    if n:
        for f in FIELDS:
            d = (got[f][:n] - want[f][:n]).abs()[same]
            if d.numel():
                qmax = max(qmax, int(d.max()))
    return {"rows_diff": float(diff), "quanta_max": float(qmax)}
