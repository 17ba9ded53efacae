"""Point-to-plane ICP, the counterpart of ``txr/geometry/icp.py``.

The streaming reconstruction's frame-to-frame registration (the reference
gets it from RTAB-Map's odometry, slam.launch.py:105-123): a fixed number
of Gauss-Newton steps, each matching every source point to its nearest
target point (chunked distance products against a masked target cloud with
precomputed normals), weighting out pairs beyond ``max_correspondence``,
and solving the 6x6 normal system in f32. By default each function reads
one count back to the host (the set target rows, which alone take part in
the search); with ``compact=False`` it reads nothing back and searches
every row, masked rows pushed out of reach, which finds the same
neighbours in the same order (the fused streaming step takes that route).
The solve is ``torch.linalg.solve_ex`` (no error check), and the loop has
no early exit.

Nearest neighbours keep ``jax.lax.top_k``'s order: the smallest distance
first and, among equal distances, the lower index first. ``top_k_smallest``
gets it from one ``torch.topk`` over int64 keys that hold the distance's
order-preserving bits above the column index, so no two keys are equal.
"""

from __future__ import annotations

import torch

from txr_torch.core.precision import f32_dots
from txr_torch.geometry.refine import _so3_exp
from txr_torch.ops.eigsmall import smallest_eigvec

_BIG = 3.0e38
# rows of the (rows, targets) distance block that estimate_normals holds at
# once: 2048 x 16384 targets is 128 MiB of f32 and 256 MiB of keys
NORMAL_ROWS = 2048


def top_k_smallest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices (rows, k) of the k smallest entries of each row of a
    float32 matrix, smallest first, equal values in index order."""
    bits = d2.contiguous().view(torch.int32)
    # flip the magnitude bits of negative floats: signed int order = float
    # order
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device)
    key = (key << 32) | col
    return (torch.topk(key, k, dim=-1, largest=False, sorted=True).values
            & 0xFFFFFFFF)


def _valid_rows(mask: torch.Tensor, least: int):
    """Indices of the set rows (one host sync), or None when fewer than
    ``least`` are set: then a masked row would be among the nearest and
    the caller keeps every row."""
    rows = torch.nonzero(mask).squeeze(1)
    return rows if rows.numel() >= least else None


@f32_dots
def estimate_normals(xyz: torch.Tensor, mask: torch.Tensor, k: int = 8,
                     compact: bool = True) -> torch.Tensor:
    """Per-point normals from the k-NN covariance's smallest eigenvector.

    Exact kNN through dense distance rows (``NORMAL_ROWS`` at a time), for
    keyframe-sized clouds of a few 10^4 points. Masked points get zero
    normals. With ``compact``, only the set rows take part when there are
    at least k of them (a masked point is never among a set point's k
    nearest then), which gives the same neighbours in the same order as
    the masked search over every row that ``compact=False`` runs without a
    host read."""
    keep = _valid_rows(mask, k) if compact else None
    pts = xyz if keep is None else xyz[keep]
    n = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)
    idx = []
    for lo in range(0, n, NORMAL_ROWS):
        hi = lo + NORMAL_ROWS
        blk = pts[lo:hi]
        d2 = sq[lo:hi, None] + sq[None, :] - 2.0 * (blk @ pts.T)
        if keep is None:
            d2 = torch.where(mask[None, :], d2, _BIG)
        d2.diagonal(offset=lo).fill_(0.0)            # include self
        idx.append(top_k_smallest(d2, k))
    nbrs = pts[torch.cat(idx)]                       # (n, k, 3)
    mean = torch.mean(nbrs, dim=1, keepdim=True)
    c = nbrs - mean
    cov = torch.einsum("nki,nkj->nij", c, c) / xyz.new_full((), float(k))
    normals = smallest_eigvec(cov)
    if keep is None:
        return torch.where(mask[:, None], normals, 0.0)
    out = torch.zeros_like(xyz)
    out[keep] = normals
    return out


@f32_dots
def icp_point_to_plane(src_xyz: torch.Tensor, src_mask: torch.Tensor,
                       tgt_xyz: torch.Tensor, tgt_normals: torch.Tensor,
                       tgt_mask: torch.Tensor, R_init: torch.Tensor,
                       t_init: torch.Tensor, iterations: int = 10,
                       max_correspondence: float = 0.1, chunk: int = 1024,
                       compact: bool = True):
    """Register src onto tgt. Returns 0-d / small tensors (R, t, rmse,
    inlier_frac) with x_tgt ~ R @ x_src + t.

    With ``compact`` the nearest-target search runs over the set target
    rows alone when there is one (a masked target is never nearer than a
    set one); ``compact=False`` searches every row with the masked ones
    pushed out of reach and reads nothing back."""
    ns = src_xyz.shape[0]
    pad = (-ns) % chunk
    src_p = torch.nn.functional.pad(src_xyz, (0, 0, 0, pad))
    srcm_p = torch.nn.functional.pad(src_mask, (0, pad))
    keep = _valid_rows(tgt_mask, 1) if compact else None
    if keep is not None:
        tgt_xyz, tgt_normals = tgt_xyz[keep], tgt_normals[keep]
        tgt_mask = tgt_mask[keep]
    tsq = torch.sum(tgt_xyz * tgt_xyz, dim=-1)
    inv_t = torch.where(tgt_mask, 0.0, _BIG)
    max_d2 = max_correspondence * max_correspondence

    def nn_all(moved):
        """Nearest target index and squared distance of every (padded)
        source row, ``chunk`` rows at a time; the first of equal minima,
        as ``top_k``."""
        idxs, d2s = [], []
        for lo in range(0, moved.shape[0], chunk):
            pts = moved[lo:lo + chunk]
            psq = torch.sum(pts * pts, dim=-1)
            d2 = psq[:, None] + tsq[None, :] - 2.0 * (pts @ tgt_xyz.T)
            d2 = d2 + inv_t[None, :]
            val, idx = torch.min(d2, dim=1)
            idxs.append(idx)
            d2s.append(val)
        return torch.cat(idxs), torch.cat(d2s)

    R = R_init.to(torch.float32)
    t = t_init.to(torch.float32)
    eye6 = 1e-6 * torch.eye(6, dtype=torch.float32, device=src_xyz.device)
    for _ in range(iterations):
        moved = src_p @ R.T + t
        idx, d2 = nn_all(moved)
        q = tgt_xyz[idx]
        nrm = tgt_normals[idx]
        w = (srcm_p & (d2 < max_d2)).to(torch.float32)
        r = torch.sum((moved - q) * nrm, dim=-1)     # point-to-plane residual
        J = torch.cat([torch.linalg.cross(moved, nrm), nrm], dim=-1)
        Jw = J * w[:, None]
        H = Jw.T @ J + eye6
        g = Jw.T @ r
        delta = -torch.linalg.solve_ex(H, g)[0]      # (6,) [omega, v]
        dR = _so3_exp(delta[:3])
        R = dR @ R
        t = dR @ t + delta[3:]

    moved = src_p @ R.T + t
    _, d2 = nn_all(moved)
    ok = srcm_p & (d2 < max_d2)
    cnt = torch.clamp(ok.sum(), min=1).to(torch.float32)
    rmse = torch.sqrt(torch.sum(torch.where(ok, d2, 0.0)) / cnt)
    frac = cnt / torch.clamp(srcm_p.sum(), min=1).to(torch.float32)
    return R, t, rmse, frac
