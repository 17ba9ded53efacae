"""Statistical outlier removal, the counterpart of ``txr/ops/outlier.py``.

Open3D-equivalent semantics (reference: depth_to_reconstruction.py:413-415,
``remove_statistical_outlier(nb_neighbors=20, std_ratio=2.0)``): for every
point the mean distance to its k nearest neighbours; the mean m and std s
of those means over valid points; points whose mean distance exceeds
m + std_ratio * s are dropped.

The exact kNN is a chunked dense distance computation,
||q - x||^2 = ||q||^2 + ||x||^2 - 2 q.x (clamped at 0), with the product in
full f32 (``core/precision.py:f32_dots``: no TF32). Above 65,536 rows the
grid kNN of ``ops/grid_knn.py`` takes over.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from txr_torch.core.precision import f32_dots
from txr_torch.core.types import PointSet

_BIG = 3.0e38
_EXACT_ROWS = 65536     # capacity at or below which the exact kNN runs


@f32_dots
def knn_mean_distance(xyz: torch.Tensor, mask: torch.Tensor, k: int = 20,
                      chunk: int = 512) -> torch.Tensor:
    """Mean distance from each valid point to its k nearest valid
    neighbours. Returns (N,) float32; invalid points get +BIG."""
    n = xyz.shape[0]
    k = max(1, min(k, n - 1)) if n > 1 else 1
    base_sq = (xyz * xyz).sum(-1)
    inv_col = torch.where(mask, 0.0, _BIG)    # invalid points excluded
    cols = torch.arange(n, device=xyz.device)
    out = []
    chunk = max(chunk, 1)
    for s in range(0, n, chunk):
        q = xyz[s:s + chunk]
        qsq = (q * q).sum(-1)
        d2 = qsq[:, None] + base_sq[None, :] - 2.0 * (q @ xyz.T)
        d2 = torch.clamp(d2, min=0.0) + inv_col[None, :]
        # exclude the self-match: query row s + r is column s + r
        d2 = torch.where(cols[None, :] == cols[s:s + chunk, None], _BIG, d2)
        nn2 = torch.topk(d2, k, dim=1, largest=False).values
        nn_d = torch.sqrt(torch.clamp(nn2, min=0.0))
        valid_nn = nn2 < 1.0e37
        cnt = torch.clamp(valid_nn.sum(-1), min=1)
        mean_d = torch.where(valid_nn, nn_d, 0.0).sum(-1) / cnt
        out.append(torch.where(mask[s:s + chunk], mean_d, _BIG))
    if not out:
        return xyz.new_zeros((0,))
    return torch.cat(out)


def _keep(points: PointSet, keep: torch.Tensor) -> PointSet:
    return PointSet(xyz=torch.where(keep[:, None], points.xyz, 0.0),
                    rgb=torch.where(keep[:, None], points.rgb, 0.0),
                    mask=keep)


def remove_statistical_outliers(points: PointSet, nb_neighbors: int = 20,
                                std_ratio: float = 2.0, chunk: int = 512
                                ) -> PointSet:
    """Drop points whose kNN mean distance exceeds mean + std_ratio * std."""
    mean_d = knn_mean_distance(points.xyz, points.mask, k=nb_neighbors,
                               chunk=chunk)
    m = points.mask
    cnt = torch.clamp(m.sum(), min=1)
    mu = torch.where(m, mean_d, 0.0).sum() / cnt
    var = torch.where(m, (mean_d - mu) ** 2, 0.0).sum() / cnt
    thresh = mu + std_ratio * torch.sqrt(var)
    return _keep(points, m & (mean_d <= thresh))


def remove_statistical_outliers_grid(
        points: PointSet, cell: Optional[Union[float, torch.Tensor]] = None,
        nb_neighbors: int = 20, std_ratio: float = 2.0, per_cell: int = 8,
        chunk: int = 65536) -> PointSet:
    """Grid-accelerated variant for multi-million-point clouds (Open3D
    uses a KD-tree here). ``cell`` ≈ 2.5x the point spacing; None tunes it
    from the data (``ops/grid_knn.py:auto_cell``).

    Capacities of at most 65,536 rows take the EXACT kNN instead, with
    Open3D's always-k semantics; a ``cell`` passed in is unused there."""
    if points.capacity <= _EXACT_ROWS:
        return remove_statistical_outliers(
            points, nb_neighbors=nb_neighbors, std_ratio=std_ratio,
            chunk=min(512, points.capacity))

    from txr_torch.ops.grid_knn import auto_cell, grid_knn_mean_distance

    if cell is None:
        cell = auto_cell(points.xyz, points.mask, k=nb_neighbors,
                         per_cell=per_cell)
    mean_d = grid_knn_mean_distance(points.xyz, points.mask, cell,
                                    k=nb_neighbors, per_cell=per_cell,
                                    chunk=chunk)
    m = points.mask
    # A valid point with an empty 27-cell window reads the no-neighbour
    # sentinel (about BIG / 2). A few such points are outliers: dropped, and
    # kept out of mu and sigma (one would inflate sigma by 1e5). More than
    # a quarter of the valid points means the cell is mis-tuned for this
    # cloud (planar data), not that a quarter of it is outliers: then every
    # sentinel is kept, so a mis-tuned cell never empties the output.
    sent = m & (mean_d >= 1.0e6)
    found = m & (mean_d < 1.0e6)
    n_valid = torch.clamp(m.sum(), min=1)
    cell_mistuned = sent.sum() > 0.25 * n_valid
    cnt = torch.clamp(found.sum(), min=1)
    d = torch.where(found, mean_d, 0.0)
    mu = d.sum() / cnt
    var = torch.where(found, (d - mu) ** 2, 0.0).sum() / cnt
    thresh = mu + std_ratio * torch.sqrt(var)
    keep = (found & (mean_d <= thresh)) | (sent & cell_mistuned)
    return _keep(points, keep)

