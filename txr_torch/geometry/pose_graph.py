"""SE(3) pose-graph optimisation for the streaming loop closure, the
counterpart of ``txr/geometry/pose_graph.py``: the same float64 numpy
Gauss-Newton on the host (tens of keyframes x 6 DoF), so the port's
results are bit-equal to ``txr``'s.

The reference's live mode delegates global pose consistency to
rtabmap_slam (appearance loop closure + graph optimisation,
slam.launch.py:126-145). Given keyframe poses, odometry edges and
loop-closure edges, the loop error is spread over the trajectory.

Conventions: poses are world->camera (X_c = R X_w + t), as in the
streaming pipeline. An edge (i, j, R_ij, t_ij) measures camera j from
camera i: X_cj = R_ij X_ci + t_ij, i.e. T_ij = T_j T_i^{-1}.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues: axis-angle (3,) -> rotation matrix."""
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        K = skew(w)
        return np.eye(3) + K
    k = w / th
    K = skew(k)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle (3,)."""
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-9:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / 2.0
    if np.pi - th < 1e-6:  # near pi: use the symmetric part
        # At theta=pi, (R+I)/2 = aa^T exactly; any column with a nonzero
        # diagonal is the axis scaled by that component, so the largest-
        # diagonal column carries ALL relative signs (per-component sqrt
        # with pairwise off-diagonal sign fixes gets y/z relative sign
        # wrong whenever a_x ~ 0 — the A[1,2] entry it never consults).
        A = (R + np.eye(3)) / 2.0
        j = int(np.argmax(np.diag(A)))
        axis = A[:, j].copy()
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        # overall sign from the skew part (sin(th)·a); at exactly pi both
        # signs are the same rotation, so the tie is harmless
        v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]])
        if float(v @ axis) < 0:
            axis = -axis
        return axis * th
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def skew(w) -> np.ndarray:
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                    dtype=np.float64)


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """(6,) [rho, phi] -> 4x4 transform (V·rho translation)."""
    rho, phi = xi[:3], xi[3:]
    th = float(np.linalg.norm(phi))
    R = so3_exp(phi)
    if th < 1e-9:
        V = np.eye(3) + 0.5 * skew(phi)
    else:
        K = skew(phi / th)
        V = (np.eye(3) + (1 - np.cos(th)) / th * K
             + (th - np.sin(th)) / th * (K @ K))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    """4x4 transform -> (6,) [rho, phi]."""
    R, t = T[:3, :3], T[:3, 3]
    phi = so3_log(R)
    th = float(np.linalg.norm(phi))
    if th < 1e-9:
        Vinv = np.eye(3) - 0.5 * skew(phi)
    else:
        K = skew(phi / th)
        half = th / 2.0
        Vinv = (np.eye(3) - half * K
                + (1 - half / np.tan(half)) * (K @ K))
    return np.concatenate([Vinv @ t, phi])


def _to_T(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).reshape(3)
    return T


def _edge_residual(Ti, Tj, Tij_meas_inv) -> np.ndarray:
    return se3_log(Tij_meas_inv @ (Tj @ np.linalg.inv(Ti)))


def optimize_pose_graph(
    poses: Sequence[Tuple[np.ndarray, np.ndarray]],
    edges: Sequence[Tuple[int, int, np.ndarray, np.ndarray, float]],
    fixed: int = 0,
    iterations: int = 15,
    damping: float = 1e-6,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Gauss-Newton pose-graph optimization.

    poses: world→camera (R, t) per node. edges: (i, j, R_ij, t_ij, weight)
    with T_ij = T_j T_i^{-1}. Node `fixed` is the gauge. Jacobians are
    numeric (central differences on the left-perturbation) — exactness is
    irrelevant at these problem sizes and GN re-linearizes each iteration.

    Returns optimized world→camera (R, t) per node.
    """
    n = len(poses)
    T = [_to_T(R, t).astype(np.float64) for R, t in poses]
    meas_inv = [np.linalg.inv(_to_T(R, t)) for _, _, R, t, _ in edges]
    w = np.array([e[4] for e in edges], np.float64)

    eps = 1e-6
    for _ in range(iterations):
        H = np.zeros((6 * n, 6 * n))
        g = np.zeros(6 * n)
        total = 0.0
        for k, (i, j, *_rest) in enumerate(edges):
            r = _edge_residual(T[i], T[j], meas_inv[k])
            total += w[k] * float(r @ r)
            # numeric jacobians wrt left-perturbations of nodes i and j
            Ji = np.zeros((6, 6))
            Jj = np.zeros((6, 6))
            for d in range(6):
                dx = np.zeros(6)
                dx[d] = eps
                Ep = se3_exp(dx)
                Em = se3_exp(-dx)
                Ji[:, d] = (_edge_residual(Ep @ T[i], T[j], meas_inv[k])
                            - _edge_residual(Em @ T[i], T[j], meas_inv[k])
                            ) / (2 * eps)
                Jj[:, d] = (_edge_residual(T[i], Ep @ T[j], meas_inv[k])
                            - _edge_residual(T[i], Em @ T[j], meas_inv[k])
                            ) / (2 * eps)
            si, sj = 6 * i, 6 * j
            H[si:si + 6, si:si + 6] += w[k] * Ji.T @ Ji
            H[sj:sj + 6, sj:sj + 6] += w[k] * Jj.T @ Jj
            H[si:si + 6, sj:sj + 6] += w[k] * Ji.T @ Jj
            H[sj:sj + 6, si:si + 6] += w[k] * Jj.T @ Ji
            g[si:si + 6] += w[k] * Ji.T @ r
            g[sj:sj + 6] += w[k] * Jj.T @ r
        # gauge: clamp the fixed node
        sf = 6 * fixed
        H[sf:sf + 6, :] = 0.0
        H[:, sf:sf + 6] = 0.0
        H[sf:sf + 6, sf:sf + 6] = np.eye(6)
        g[sf:sf + 6] = 0.0
        H += damping * np.eye(6 * n)
        try:
            dx = np.linalg.solve(H, -g)
        except np.linalg.LinAlgError:
            break
        for k2 in range(n):
            T[k2] = se3_exp(dx[6 * k2:6 * k2 + 6]) @ T[k2]
        if float(np.linalg.norm(dx)) < 1e-10:
            break

    return [(T_[:3, :3].astype(np.float32).copy(),
             T_[:3, 3].astype(np.float32).copy()) for T_ in T]
