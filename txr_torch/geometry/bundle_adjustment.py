"""Bundle adjustment, the counterpart of
``txr/geometry/bundle_adjustment.py`` (the reference declares BA but never
runs it, depth_enhanced_reconstruction.py:45-50).

Alternating Gauss-Newton (resection-intersection), as in ``txr``:

  - point step: every 3D point refines on its own given the poses, a (3, 3)
    normal-equation solve per point;
  - camera step: every camera refines on its own given the points, a (6, 6)
    solve per camera (axis-angle increment on the left, then translation);
  - Huber-weighted reprojection residuals; observations behind a camera do
    not steer a step; camera 0 is the gauge and stays fixed.

Fixed capacity and masks throughout: observations are (K,) index tensors
with a validity mask, and the per-point / per-camera sums of the normal
equations are ``index_add_`` (``txr``: ``jax.ops.segment_sum``). The
Jacobians are closed-form (``txr`` takes ``jax.jacfwd`` of the same
residual; the camera Jacobian is that of the Rodrigues map at zero, where
its Taylor branch makes it exact).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.core.precision import f32_dots


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment problem (tensors on one device).

    rotations: (C, 3, 3) world -> camera; translations: (C, 3).
    points: (M, 3) world points; point_mask: (M,).
    obs_cam / obs_point: (K,) int64 indices; obs_uv: (K, 2); obs_mask: (K,).
    """

    rotations: torch.Tensor
    translations: torch.Tensor
    points: torch.Tensor
    point_mask: torch.Tensor
    obs_cam: torch.Tensor
    obs_point: torch.Tensor
    obs_uv: torch.Tensor
    obs_mask: torch.Tensor


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues, batched: (..., 3) axis-angle -> (..., 3, 3); a copy of
    ``txr/geometry/icp.py:_so3_exp`` (Taylor branch near zero)."""
    t2 = (w * w).sum(-1)[..., None, None]
    t = torch.sqrt(t2 + 1e-24)
    A = torch.where(t2 > 1e-8, torch.sin(t) / t, 1.0 - t2 / 6.0)
    B = torch.where(t2 > 1e-8, (1.0 - torch.cos(t)) / (t2 + 1e-24),
                    0.5 - t2 / 24.0)
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A * K + B * (K @ K)


def _project(K: torch.Tensor, Xc: torch.Tensor):
    """Camera-frame points (N, 3) -> pixels (N, 2), depth z (N,) and the
    Jacobian d uv / d Xc (N, 2, 3) (``txr``'s projection: divide by z
    where |z| > 1e-9, else by 1)."""
    z = Xc[:, 2]
    big = z.abs() > 1e-9
    zs = torch.where(big, z, 1.0)
    p = Xc @ K.T
    uv = p[:, :2] / zs[:, None]
    J = K[None, :2, :] / zs[:, None, None]
    J[:, :, 2] -= torch.where(big[:, None], uv, 0.0) / zs[:, None]
    return uv, z, J


def _huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    n = torch.linalg.vector_norm(r, dim=-1) + 1e-12
    return torch.clamp(delta / n, max=1.0)


@f32_dots
def bundle_adjust(problem: BAProblem, K: torch.Tensor, iterations: int = 10,
                  damping: float = 1e-3, huber_delta: float = 4.0):
    """Refine poses and points by alternating Gauss-Newton. Returns
    (rotations, translations, points, rms_history (iterations + 1,)), all
    on the problem's device; nothing is read back."""
    dev = problem.points.device
    K = torch.as_tensor(K).to(device=dev, dtype=torch.float32)
    C = problem.rotations.shape[0]
    M = problem.points.shape[0]
    oc, op, uv_obs = problem.obs_cam, problem.obs_point, problem.obs_uv
    w_obs = problem.obs_mask.to(torch.float32)

    def residuals(R, t, X):
        Xc = (R[oc] @ X[op][:, :, None])[:, :, 0] + t[oc]
        uv, z, J = _project(K, Xc)
        return uv - uv_obs, z, J, Xc

    def rms(R, t, X):
        r, z, _, _ = residuals(R, t, X)
        ok = w_obs * (z > 1e-6)
        sq = (r * r).sum(-1) * ok
        return torch.sqrt(sq.sum() / torch.clamp(ok.sum() * 2.0, min=1.0))

    def weights(r, z):
        # behind-camera observations (z <= 0: a sign-flipped projection and
        # a huge spurious residual) must not steer a step
        return w_obs * _huber_weight(r, huber_delta) * (z > 1e-6)

    def solve(JtJ, Jtr, idx, n, d):
        H = torch.zeros((n, d, d), dtype=JtJ.dtype, device=dev)
        g = torch.zeros((n, d), dtype=Jtr.dtype, device=dev)
        H.index_add_(0, idx, JtJ)
        g.index_add_(0, idx, Jtr)
        H = H + damping * torch.eye(d, dtype=H.dtype, device=dev)
        return torch.linalg.solve(H, -g[..., None])[..., 0]

    def point_step(R, t, X):
        r, z, Juv, _ = residuals(R, t, X)
        J = Juv @ R[oc]                                   # (K, 2, 3)
        hw = weights(r, z)[:, None]
        JtJ = J.transpose(1, 2) @ J * hw[:, :, None]
        Jtr = (J.transpose(1, 2) @ r[:, :, None])[:, :, 0] * hw
        delta = solve(JtJ, Jtr, op, M, 3)
        delta = torch.where(problem.point_mask[:, None], delta, 0.0)
        return X + delta

    def camera_step(R, t, X):
        r, z, Juv, Xc = residuals(R, t, X)
        eye = torch.eye(3, dtype=Xc.dtype, device=dev).expand(Xc.shape[0],
                                                              3, 3)
        dXc = torch.cat([-_skew(Xc), eye], dim=2)         # (K, 3, 6)
        J = Juv @ dXc                                     # (K, 2, 6)
        hw = weights(r, z)[:, None]
        JtJ = J.transpose(1, 2) @ J * hw[:, :, None]
        Jtr = (J.transpose(1, 2) @ r[:, :, None])[:, :, 0] * hw
        delta = solve(JtJ, Jtr, oc, C, 6)
        delta[0] = 0.0                                    # gauge
        dR = _so3_exp(delta[:, :3])
        return dR @ R, (dR @ t[:, :, None])[:, :, 0] + delta[:, 3:]

    R = problem.rotations.to(torch.float32)
    t = problem.translations.to(torch.float32)
    X = problem.points.to(torch.float32)
    history = [rms(R, t, X)]
    for _ in range(iterations):
        X = point_step(R, t, X)
        R, t = camera_step(R, t, X)
        history.append(rms(R, t, X))
    return R, t, X, torch.stack(history)


def build_problem(poses, points, observations, max_obs: int | None = None,
                  device=None) -> BAProblem:
    """Assemble a BAProblem on ``device`` (``None``: the CUDA device) from
    host-side lists.

    poses: list of (R (3, 3), t (3,)) world -> camera.
    points: (M, 3) array.
    observations: list of (cam_idx, point_idx, (u, v)).
    """
    dev = resolve_device(device)
    Rs = np.stack([np.asarray(R, np.float32) for R, _ in poses])
    ts = np.stack([np.asarray(t, np.float32).reshape(3) for _, t in poses])
    X = np.asarray(points, np.float32)
    cap = max_obs if max_obs is not None else len(observations)
    oc = np.zeros(cap, np.int64)
    op = np.zeros(cap, np.int64)
    uv = np.zeros((cap, 2), np.float32)
    om = np.zeros(cap, bool)
    for i, (ci, pi, p) in enumerate(observations[:cap]):
        oc[i], op[i] = ci, pi
        uv[i] = p
        om[i] = True

    def T(a):
        return torch.from_numpy(a).to(dev)

    return BAProblem(rotations=T(Rs), translations=T(ts), points=T(X),
                     point_mask=torch.ones(len(X), dtype=torch.bool,
                                           device=dev),
                     obs_cam=T(oc), obs_point=T(op), obs_uv=T(uv),
                     obs_mask=T(om))
