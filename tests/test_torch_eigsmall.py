"""``txr_torch.ops.eigsmall`` against ``txr.ops.eigsmall`` (and numpy).

Both run the same fixed-sweep cyclic Jacobi, so eigenvalues, eigenvectors,
their order and their signs must agree, not only the subspaces.
Tolerances: values 1e-5 relative to the largest entry of the input (f32
round-off of the same rotations, which XLA may contract into fused
multiply-adds); eigenvectors 1e-5 plus 1e-6 over the column's relative
eigen-gap (round-off amplified by the inverse gap, the standard
perturbation bound: 9x9 normals with close eigenvalues move by up to
2e-5); ``svd3``'s zero singular value of a rank-2 input is the square root
of round-off on both sides, so only its size (< 1e-3 of the largest entry)
is held; ``inv3`` and ``det3`` 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.ops.eigsmall import eigh_jacobi as j_eigh
from txr.ops.eigsmall import inv3 as j_inv3
from txr.ops.eigsmall import smallest_eigvec as j_smallest
from txr.ops.eigsmall import svd3 as j_svd3
from txr_torch.ops.eigsmall import (det3, eigh_jacobi, inv3, smallest_eigvec,
                                    svd3)

torch.set_num_threads(1)
TOL = 1e-5


def _sym(rng, b, d):
    A = rng.normal(size=(b, d, d)).astype(np.float32)
    return A @ A.transpose(0, 2, 1)  # PSD, like the A^T A normals


def _close(got, want, scale=1.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL * scale)


def _close_vectors(V, Vj, w, scale):
    """Eigenvector columns within 1e-5 + 1e-6 / relative gap."""
    d = w.shape[-1]
    gap = np.stack([np.abs(w[:, i:i + 1] - np.delete(w, i, axis=1)).min(1)
                    for i in range(d)], axis=1) / scale
    err = np.abs(V - Vj).max(axis=1)
    tol = TOL + 1e-6 / np.maximum(gap, 1e-12)
    assert (err <= tol).all(), (err / tol).max()


@pytest.mark.parametrize("d", [3, 4, 9])
def test_eigh_matches_txr(rng, d):
    M = _sym(rng, 16, d)
    wj, Vj = jax.jit(j_eigh)(jnp.asarray(M))
    w, V = eigh_jacobi(torch.from_numpy(M))
    scale = float(np.abs(M).max())
    _close(w.numpy(), wj, scale)
    _close_vectors(V.numpy(), np.asarray(Vj), w.numpy(), scale)
    np.testing.assert_allclose(M @ V.numpy(), V.numpy() * w.numpy()[:, None],
                               atol=2e-3 * scale)


def test_exact_diagonal_tie_rotates():
    """a_pp == a_qq with a_pq != 0 must rotate by 45 degrees (zero-safe
    sign), as in ``txr``."""
    M = np.array([[[2.0, 0.9, 0.0], [0.9, 2.0, 0.0], [0.0, 0.0, 5.0]]],
                 np.float32)
    wj, Vj = jax.jit(j_eigh)(jnp.asarray(M))
    w, V = eigh_jacobi(torch.from_numpy(M))
    _close(w.numpy(), wj, 5.0)
    _close(V.numpy(), Vj)
    np.testing.assert_allclose(np.sort(w.numpy()[0]), [1.1, 2.9, 5.0],
                               atol=1e-5)


@pytest.mark.parametrize("d", [4, 9])
def test_smallest_eigvec_matches_txr(rng, d):
    B = rng.normal(size=(24, d - 1, d)).astype(np.float32)
    M = np.einsum("bkd,bke->bde", B, B)       # rank-deficient normals
    want = np.asarray(jax.jit(j_smallest)(jnp.asarray(M)))
    got = smallest_eigvec(torch.from_numpy(M)).numpy()
    w = np.linalg.eigvalsh(M.astype(np.float64))
    gap = (w[:, 1] - w[:, 0]) / np.abs(M).max(axis=(1, 2))
    assert (np.abs(got - want).max(axis=1) <= TOL + 1e-6 / gap).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def _rank2(rng, n):
    """Rank-2 matrices U diag(s0, s1, 0) V^T with s0 > s1 (distinct, so
    that the singular vectors are defined)."""
    out = []
    for _ in range(n):
        u, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        v, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        s0, s1 = np.sort(rng.uniform(0.5, 2.0, 2))[::-1]
        out.append(u @ np.diag([s0 + 0.2, s1, 0.0]) @ v.T)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "s2_zero"])
def test_svd3_matches_txr(rng, case):
    F = (rng.normal(size=(32, 3, 3)).astype(np.float32) if case == "random"
         else _rank2(rng, 32))
    Uj, sj, Vtj = jax.jit(j_svd3)(jnp.asarray(F))
    U, s, Vt = svd3(torch.from_numpy(F))
    scale = float(np.abs(F).max())
    if case == "random":
        _close(s.numpy(), sj, scale)
    else:
        # s2 is the square root of an eigenvalue that is round-off (about
        # 1e-8 scale^2) on both sides: only its size is defined
        _close(s.numpy()[:, :2], np.asarray(sj)[:, :2], scale)
        assert np.abs(s.numpy()[:, 2]).max() < 1e-3 * scale
        assert np.abs(np.asarray(sj)[:, 2]).max() < 1e-3 * scale
    Uj = np.asarray(Uj)
    if case == "s2_zero":
        # u2 = u0 x u1 signed by F v2, which is round-off when s2 = 0: its
        # sign is noise on both sides (U diag(s) Vt and the (1, 1, 0)
        # projection do not depend on it)
        sgn = np.sign((U.numpy()[..., 2] * Uj[..., 2]).sum(-1))[:, None]
        _close(U.numpy()[..., 2] * sgn, Uj[..., 2])
        _close(U.numpy()[..., :2], Uj[..., :2])
    else:
        _close(U.numpy(), Uj)
    _close(Vt.numpy(), Vtj)
    np.testing.assert_allclose(U.numpy() * s.numpy()[:, None, :] @ Vt.numpy(),
                               F, atol=5e-4 * scale)
    if case == "s2_zero":
        # u2 comes from the cross product: U stays orthonormal although s2
        # is (numerically) zero
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), U.shape)
        np.testing.assert_allclose(U.numpy().transpose(0, 2, 1) @ U.numpy(),
                                   eye, atol=1e-5)


def test_inv3_and_det3(rng):
    M = rng.normal(size=(32, 3, 3)).astype(np.float32) + 3 * np.eye(
        3, dtype=np.float32)
    want = np.asarray(j_inv3(jnp.asarray(M)))
    got = inv3(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(det3(torch.from_numpy(M)).numpy(),
                               np.linalg.det(M.astype(np.float64)), rtol=TOL)
