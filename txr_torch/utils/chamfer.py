"""Chamfer distance between point clouds, the fidelity metric; the
counterpart of ``txr/utils/chamfer.py``.

The symmetric mean nearest-neighbour distance. The distance matrix is taken
in chunks of 1024 query rows, in two passes per chunk: the nearest
neighbour is chosen from the ``|a|^2 + |b|^2 - 2 a.b`` expansion (one
matrix product, in full f32: it cancels badly at large coordinates, which
is harmless for the choice), then its distance is taken by direct
subtraction, which does not cancel.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.core.precision import f32_dots

CHUNK = 1024


@f32_dots
def _one_sided(a: torch.Tensor, b: torch.Tensor,
               chunk: int = CHUNK) -> torch.Tensor:
    """mean_i min_j |a_i - b_j| for a (N, 3), b (M, 3) f32."""
    bsq = (b * b).sum(-1)
    out = []
    for q in a.split(chunk):
        qsq = (q * q).sum(-1)
        d2 = qsq[:, None] + bsq[None, :] - 2.0 * (q @ b.T)
        nn = b[d2.argmin(-1)]
        out.append(torch.linalg.vector_norm(q - nn, dim=-1))
    return torch.cat(out).mean()


def chamfer_distance(a: np.ndarray, b: np.ndarray,
                     max_points: int = 200_000, seed: int = 0,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> float:
    """Symmetric chamfer distance between (N, 3) and (M, 3) clouds, on
    ``device`` (``None``: the CUDA device).

    Clouds larger than ``max_points`` are subsampled with ``txr``'s
    deterministic draw (numpy, ``seed``); an empty cloud gives infinity.
    """
    rng = np.random.default_rng(seed)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if len(a) == 0 or len(b) == 0:
        return float("inf")
    if len(a) > max_points:
        a = a[rng.choice(len(a), max_points, replace=False)]
    if len(b) > max_points:
        b = b[rng.choice(len(b), max_points, replace=False)]
    dev = resolve_device(device)
    ta = torch.from_numpy(a).to(dev)
    tb = torch.from_numpy(b).to(dev)
    d_ab = _one_sided(ta, tb).item()
    d_ba = _one_sided(tb, ta).item()
    return 0.5 * (d_ab + d_ba)


def chamfer_between_plys(path_a: str, path_b: str, **kw) -> float:
    from txr_torch.io.ply import read_ply

    xa, _ = read_ply(path_a)
    xb, _ = read_ply(path_b)
    return chamfer_distance(xa, xb, **kw)


if __name__ == "__main__":  # python -m txr_torch.utils.chamfer a.ply b.ply
    import sys

    d = chamfer_between_plys(sys.argv[1], sys.argv[2])
    print(f"chamfer: {d:.6f}")
