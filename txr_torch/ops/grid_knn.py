"""Grid-accelerated kNN mean distance for large point sets, the
counterpart of ``txr/ops/grid_knn.py``.

The exact kNN (``ops/outlier.py``) is O(N^2), hopeless for the
multi-million-point clouds the fusion CLI merges. This is the Open3D
KD-tree query's role (reference depth_to_reconstruction.py:413-415):

  1. bin points into cells of edge ``cell`` (9 bits an axis, z in the low
     bits so that a [z-1, z+1] span is contiguous in key space),
  2. sort points by the packed cell key,
  3. per query, the 27 neighbour cells collapse into nine (dx, dy) ranges
     [T(k0), T(k0 + 3)) of the sorted order, T(c) = the first sorted index
     with key >= c (``torch.searchsorted`` of the sorted keys), each
     truncated to W = 3 * per_cell candidates centred in the range.

``txr`` builds T as a direct-address table over all 2^27 keys (a
scatter-min and a reverse running minimum), packed into a (2^27, 2) range
table, and the sorted points into (N, 3W) sliding windows, because its
accelerator's gathers cost a descriptor per row; the port searches the
sorted keys for T(k0), T(k0 + 3) and gathers a window's W rows directly,
which reads the same values.

Approximate only in the tail: missing neighbours are charged 2 * cell each,
so sparse points look farther, never closer. Queries run in chunks of
``chunk`` rows (a Python loop; the results do not depend on ``chunk``).
"""

from __future__ import annotations

import torch

from txr_torch.ops.voxel import f32_scalar

_BIG = 3.0e38
_BITS = 9
_GRID = 1 << _BITS                 # cells per axis
_NKEYS = 1 << (3 * _BITS)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of a non-negative float32 tensor (PyTorch has no cbrt):
    computed in float64, rounded to float32."""
    return torch.pow(x.to(torch.float64), 1.0 / 3.0).to(torch.float32)


def _cell_keys(xyz: torch.Tensor, mask: torch.Tensor, lo: torch.Tensor,
               cell: torch.Tensor) -> torch.Tensor:
    """Packed (x, y, z) cell key of every row, clamped to the grid;
    invalid rows get _NKEYS, which sorts last. The clamp comes before the
    cast so that no value out of int32's range is converted."""
    cc = torch.clamp(torch.floor((xyz - lo) / cell), 0, _GRID - 1)
    cc = cc.to(torch.int32)
    key = (cc[:, 0] << (2 * _BITS)) | (cc[:, 1] << _BITS) | cc[:, 2]
    return torch.where(mask, key, _NKEYS)


def _median_occupancy(xyz: torch.Tensor, mask: torch.Tensor,
                      lo: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """Median points per occupied cell at grid size ``cell`` (0-d)."""
    n = xyz.shape[0]
    dev = xyz.device
    skey = torch.sort(_cell_keys(xyz, mask, lo, cell)).values
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    first_all = torch.cat([one, skey[1:] != skey[:-1]])
    first = first_all & (skey < _NKEYS)   # valid segment starts
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    # a cell ends at the first row of a larger key: the next cell, or the
    # masked tail after the last occupied one
    end = torch.searchsorted(skey, skey, right=True, out_int32=True)
    seg_len = torch.where(first, end - idx, 0).to(torch.float32)
    lens = torch.sort(torch.where(first, seg_len, _BIG)).values
    m = torch.clamp(first.sum(), min=1)
    return lens.gather(0, ((m - 1) // 2).reshape(1))[0]


def auto_cell(xyz: torch.Tensor, mask: torch.Tensor, k: int = 20,
              per_cell: int = 8) -> torch.Tensor:
    """Data-driven grid cell size for :func:`grid_knn_mean_distance`
    (0-d float32 tensor).

    Targets an occupancy tau = min(0.6 * per_cell, k / 9, >= 1) per cell.
    The bounding-box volume estimate cell0 is refined DOWN by the measured
    median occupancy when far outlier clusters stretch the box, and UP a 4x
    ladder (cell0, 4 c0, 16 c0, 64 c0; first rung whose occupancy reaches
    tau, interpolated with d = log4(med_i / med_{i-1}) clamped to [0.5,
    3]) when the cloud is planar and the volume estimate sits below its
    in-plane spacing. Clamped so that the longest edge fits the 512-cell
    grid.

    ``txr`` picks the branch with ``lax.cond``; here it is one host branch
    on med0 >= tau, which reads one value back (a single sync), so a
    well-tuned volumetric cloud pays one probe.
    """
    lo = torch.where(mask[:, None], xyz, _BIG).amin(dim=0)
    hi = torch.where(mask[:, None], xyz, -_BIG).amax(dim=0)
    ext = torch.clamp(hi - lo, min=1e-9)
    cnt = torch.clamp(mask.to(torch.float32).sum(), min=1.0)
    spacing = _cbrt(ext[0] * ext[1] * ext[2] / cnt)
    tau = f32_scalar(max(min(0.6 * per_cell, k / 9.0), 1.0), xyz)
    one = f32_scalar(1.0, xyz)
    fit = ext.amax() / f32_scalar(_GRID - 2, xyz)
    cell0 = torch.maximum(spacing * _cbrt(tau), fit)

    med0 = _median_occupancy(xyz, mask, lo, cell0)
    if bool(med0 >= tau):
        c = cell0 * _cbrt(tau / torch.clamp(med0, min=1.0))
        cell = torch.minimum(torch.maximum(c, 0.05 * cell0), cell0)
    else:
        cells = [cell0, 4.0 * cell0, 16.0 * cell0, 64.0 * cell0]
        meds = [med0] + [_median_occupancy(xyz, mask, lo, c)
                         for c in cells[1:]]
        # past the last rung (extreme sparsity) assume d = 1: growing the
        # cell is always safe for the grid
        cell = cells[3] * torch.clamp(tau / torch.clamp(meds[3], min=1.0),
                                      1.0, 16.0)
        log4 = torch.log(f32_scalar(4.0, xyz))
        for i in (3, 2, 1):
            d = torch.log(torch.clamp(meds[i], min=1.0)
                          / torch.clamp(meds[i - 1], min=1.0)) / log4
            d = torch.clamp(d, 0.5, 3.0)
            cand = cells[i] * torch.pow(tau / torch.clamp(meds[i], min=1.0),
                                        one / d)
            cand = torch.minimum(torch.maximum(cand, cells[i - 1]), cells[i])
            cell = torch.where(meds[i] >= tau, cand, cell)
    return torch.maximum(cell, fit)


def grid_knn_mean_distance(xyz: torch.Tensor, mask: torch.Tensor, cell,
                           k: int = 20, per_cell: int = 4,
                           chunk: int = 65536) -> torch.Tensor:
    """Approximate mean distance to the k nearest neighbours. (N,) float32;
    invalid points get +BIG."""
    n = xyz.shape[0]
    k = max(1, min(k, n - 1)) if n > 1 else 1
    W = 3 * per_cell               # candidate cap per (dx, dy) z-range
    dev = xyz.device
    cell = f32_scalar(cell, xyz)

    min_bound = torch.where(mask[:, None], xyz, _BIG).amin(dim=0)
    skey, order = torch.sort(_cell_keys(xyz, mask, min_bound, cell),
                             stable=True)
    sm = mask[order]
    # invalid points (and the window's ragged tail) must never look like
    # near neighbours: +BIG coordinates
    sxyz = torch.where(sm[:, None], xyz[order], _BIG)
    padded = torch.cat([sxyz, torch.full((W, 3), _BIG, device=dev)])
    slot = torch.arange(W, device=dev)
    two_cell = 2.0 * cell
    k_f = f32_scalar(k, xyz)

    out = torch.empty((n,), dtype=torch.float32, device=dev)
    for base in range(0, n, chunk):
        # queries in SORTED order: the self-candidate is the one whose
        # sorted index equals the query's
        e = min(base + chunk, n)
        qx, qm, qk = sxyz[base:e], sm[base:e], skey[base:e]
        zx = qk >> (2 * _BITS)
        zy = (qk >> _BITS) & (_GRID - 1)
        zz = qk & (_GRID - 1)
        qpos = torch.arange(base, e, device=dev)
        # the 3-key z-span clamped inside its column: at zz = GRID-1 an
        # unclamped span wraps into the next (x, y + 1) column
        z0 = torch.clamp(zz - 1, 0, _GRID - 3)
        d2_all, cv_all, self_all = [], [], []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                xx, yy = zx + dx, zy + dy
                inb = ((xx >= 0) & (xx < _GRID) & (yy >= 0) & (yy < _GRID)
                       & (qk < _NKEYS))
                k0 = torch.clamp(xx * (1 << (2 * _BITS)) + yy * (1 << _BITS)
                                 + z0, 0, _NKEYS - 1)
                lo = torch.where(inb, torch.searchsorted(
                    skey, k0, out_int32=True), 0)
                hi = torch.where(inb, torch.searchsorted(
                    skey, k0 + 3, out_int32=True), 0)
                cnt = hi - lo
                # over-full ranges: the W-window centred in the range
                lo = lo + torch.clamp(cnt - W, min=0) // 2
                cnt = torch.clamp(cnt, max=W)
                rows = torch.clamp(lo, 0, n - 1).to(torch.int64)[:, None] + slot
                diff = padded[rows] - qx[:, None, :]
                d2_all.append((diff[..., 0] * diff[..., 0]
                               + diff[..., 1] * diff[..., 1])
                              + diff[..., 2] * diff[..., 2])
                cv_all.append(slot < cnt[:, None])
                self_all.append((lo[:, None] + slot) == qpos[:, None])
        d2 = torch.cat(d2_all, dim=1)                      # (C, 9W)
        ok = torch.cat(cv_all, dim=1) & ~torch.cat(self_all, dim=1)
        d2 = torch.where(ok, d2, _BIG)
        nn2 = torch.topk(d2, k, dim=1, largest=False).values
        nn_d = torch.sqrt(torch.clamp(nn2, min=0.0))
        valid_nn = nn2 < 1.0e37
        found = valid_nn.sum(-1)
        found_sum = torch.where(valid_nn, nn_d, 0.0).sum(-1)
        # neighbours missing from the truncated windows lie at least a cell
        # away: charged 2 * cell each
        mean_d = (found_sum + (k - found).to(torch.float32) * two_cell) / k_f
        mean_d = torch.where(found > 0, mean_d, _BIG / 2)
        out[base:e] = torch.where(qm, mean_d, _BIG)

    restored = torch.empty_like(out)
    restored[order] = out
    return restored

