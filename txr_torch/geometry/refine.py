"""Two-view pose refinement: Gauss-Newton on the essential manifold, the
counterpart of ``txr/geometry/refine.py``.

Minimal-solver poses (8-point essential, homography decomposition) carry
fraction-of-a-degree rotation errors from pixel noise; at small-baseline
parallax that bias multiplies straight into triangulated depth. This refines
(R, t) by Gauss-Newton on the Sampson error of the epipolar constraint,
parameterised minimally: omega in so(3) for R and a 2-D tangent step for the
unit translation. Fixed iteration count, 5x5 normal equations, a step kept
only when it lowers the cost; nothing is read back to the host (the solve
is ``torch.linalg.solve_ex``, whose error flag stays on the device).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from txr_torch.core.precision import f32_dots

_EPS = 1e-12


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (3,) axis-angle -> (3, 3) rotation; a copy of ``txr``'s
    ``txr/geometry/icp.py:_so3_exp``.

    Smooth at w = 0 (Taylor branch + guarded denominators), so it is safe
    under jacfwd, which differentiates through it at exactly zero.
    """
    t2 = (w * w).sum()
    t = torch.sqrt(t2 + 1e-24)
    A = torch.where(t2 > 1e-8, torch.sin(t) / t, 1.0 - t2 / 6.0)
    B = torch.where(t2 > 1e-8, (1.0 - torch.cos(t)) / (t2 + 1e-24),
                    0.5 - t2 / 24.0)
    K = _skew(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * K + B * (K @ K)


def _tangent_basis(t: torch.Tensor):
    """Two unit vectors orthogonal to t (deterministic)."""
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    a = torch.where(t[0].abs() < 0.9, eye[0], eye[1])
    b1 = torch.linalg.cross(t, a)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=_EPS)
    b2 = torch.linalg.cross(t, b1)
    return b1, b2


def _sampson(E: torch.Tensor, n1: torch.Tensor,
             n2: torch.Tensor) -> torch.Tensor:
    """Signed Sampson residual per correspondence on normalised coords."""
    p1 = torch.cat([n1, torch.ones_like(n1[:, :1])], dim=1)
    p2 = torch.cat([n2, torch.ones_like(n2[:, :1])], dim=1)
    Ex1 = p1 @ E.T
    Etx2 = p2 @ E
    num = (p2 * Ex1).sum(-1)
    den = torch.sqrt(torch.clamp(
        Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2,
        min=_EPS))
    return num / den


def _step(params: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """The pose ``params`` (omega, tangent step) moves (R, t) to."""
    w, v = params[:3], params[3:]
    b1, b2 = _tangent_basis(t)
    tn = t + v[0] * b1 + v[1] * b2
    tn = tn / torch.clamp(torch.linalg.vector_norm(tn), min=_EPS)
    return _so3_exp(w) @ R, tn


@f32_dots
def refine_pose(R0: torch.Tensor, t0: torch.Tensor, uv1: torch.Tensor,
                uv2: torch.Tensor, K: torch.Tensor, mask: torch.Tensor,
                iters: int = 10, damping: float = 1e-6):
    """Gauss-Newton refinement of (R, t) over masked correspondences.

    Returns (R, t) with ||t|| = 1. The objective is the masked mean squared
    Sampson error in normalised coordinates; a step is accepted only when it
    lowers the objective, so the result is never worse than the input.
    """
    dt = R0.dtype
    Kinv = torch.linalg.inv_ex(K.to(dt))[0]
    p1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=1) @ Kinv.T
    p2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], dim=1) @ Kinv.T
    n1 = p1[:, :2] / p1[:, 2:3]
    n2 = p2[:, :2] / p2[:, 2:3]
    m = mask.to(dt)
    msum = torch.clamp(m.sum(), min=1.0)
    eye5 = torch.eye(5, dtype=dt, device=R0.device)
    z5 = torch.zeros(5, dtype=dt, device=R0.device)

    def cost_res(params, R, t):
        Rn, tn = _step(params, R, t)
        return _sampson(_skew(tn) @ Rn, n1, n2) * m

    R, t = R0, t0
    c_old = (cost_res(z5, R, t) ** 2).sum() / msum
    for _ in range(iters):
        r = cost_res(z5, R, t)
        J = jacfwd(cost_res)(z5, R, t)                         # (N, 5)
        JtJ = J.T @ J + damping * eye5
        g = J.T @ r
        delta = -torch.linalg.solve_ex(JtJ, g)[0]
        c_new = (cost_res(delta, R, t) ** 2).sum() / msum
        accept = c_new < c_old
        Rn, tn = _step(delta, R, t)
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        c_old = torch.where(accept, c_new, c_old)
    return R, t
