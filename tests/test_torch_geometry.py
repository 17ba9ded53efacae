"""The port's two-view geometry against ``txr.geometry`` on the same
numpy-seeded correspondences, the port with ``device="cpu"``: Hartley
normalisation, 8-point, Sampson error, the three RANSACs on the same
priorities (``txr`` draws them from its ``jax.random`` key; the port takes
that draw through ``priorities=``), pose recovery from E and from H, the
homography decomposition, Gauss-Newton refinement, triangulation and the
metric scale; and ``core/precision.py``.

Tolerances: the same inlier and cheirality masks; E, F and H within 1e-4
of their largest entry up to sign; R, t, refined poses 1e-4; triangulated
points, reprojection errors and depths 1e-4 relative (+1e-4); scales and
medians 1e-4 relative. Both sides are f32; they differ in the order of
sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.geometry import homography as j_hom
from txr.geometry import epipolar as j_epi
from txr.geometry import pose as j_pose
from txr.geometry import scale as j_scale
from txr.geometry.refine import refine_pose as j_refine
from txr.geometry.triangulate import depth_in_camera as j_depth
from txr.geometry.triangulate import reprojection_error as j_reproj
from txr.geometry.triangulate import triangulate as j_tri
from txr_torch.core.precision import f32_dots
from txr_torch.geometry import (chain_pose, clamp_scale, decompose_essential,
                                depth_in_camera, eight_point, ema_scale,
                                essential_ransac, estimate_scale,
                                fundamental_ransac, masked_median,
                                normalize_transform, recover_pose,
                                reprojection_error, sampson_error,
                                triangulate)
from txr_torch.geometry.homography import (decompose_homography,
                                           homography_dlt, homography_ransac,
                                           recover_pose_homography,
                                           transfer_error)
from txr_torch.geometry.refine import refine_pose
from txr_torch.geometry.scale import DepthScaleEstimator

torch.set_num_threads(1)
TOL = 1e-4
HYP = 128


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def rotmat(ax, ang):
    ax = np.asarray(ax, np.float64)
    ax = ax / np.linalg.norm(ax)
    c, s = np.cos(ang), np.sin(ang)
    Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return np.eye(3) + s * Kx + (1 - c) * Kx @ Kx


K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)


def scene_pair(rng, n=200, planar=False, noise=0.3, outliers=0.1):
    """Correspondences of points in front of two cameras (a box of depth 3
    to 8, or the plane z + 0.1 x = 5), with pixel noise, outliers and an
    invalid tenth."""
    R = rotmat([0.1, 1.0, 0.2], 0.05)
    t = np.array([0.6, 0.05, 0.1])
    uv1 = rng.uniform([10, 10], [310, 230], (n, 2))
    rays = np.c_[(uv1 - K[:2, 2]) / K[0, 0], np.ones(n)]
    z = 5.0 / (1.0 + 0.1 * rays[:, 0]) if planar else rng.uniform(3, 8, n)
    X = rays * z[:, None]
    p2 = (X @ R.T + t) @ K.T.astype(np.float64)
    uv2 = p2[:, :2] / p2[:, 2:3]
    uv1 = uv1 + rng.normal(0, noise, uv1.shape)
    uv2 = uv2 + rng.normal(0, noise, uv2.shape)
    bad = rng.random(n) < outliers
    uv2[bad] = rng.uniform([10, 10], [310, 230], (bad.sum(), 2))
    mask = rng.random(n) < 0.9
    return (uv1.astype(np.float32), uv2.astype(np.float32), mask, R,
            t / np.linalg.norm(t))


def same_up_to_sign(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    sgn = np.sign((got * want).sum())
    np.testing.assert_allclose(got * sgn, want, atol=tol * scale)


def priorities(key, n):
    return np.asarray(jax.random.uniform(key, (HYP, n)))


# ------------------------------------------------------------- 8-point

def test_normalize_eight_point_sampson_match_txr(rng):
    uv1, uv2, mask, _, _ = scene_pair(rng, outliers=0.0)
    w = mask.astype(np.float32)
    np.testing.assert_allclose(normalize_transform(T(uv1), T(w)).numpy(),
                               np.asarray(j_epi.normalize_transform(
                                   J(uv1), J(w))), rtol=TOL, atol=TOL)
    Fj = np.asarray(jax.jit(j_epi.eight_point)(J(uv1), J(uv2), J(w)))
    F = eight_point(T(uv1), T(uv2), T(w)).numpy()
    same_up_to_sign(F, Fj)
    # batched over minimal samples, as RANSAC calls it: each as on its own
    # (a minimal sample's F is too ill-conditioned to hold to txr at 1e-4;
    # the RANSAC tests below hold the whole batch through its inliers)
    idx = np.stack([rng.permutation(len(uv1))[:8] for _ in range(4)])
    Fb = eight_point(T(uv1[idx]), T(uv2[idx])).numpy()
    for b in range(4):
        np.testing.assert_allclose(
            Fb[b], eight_point(T(uv1[idx[b]]), T(uv2[idx[b]])).numpy(),
            rtol=1e-5, atol=1e-6)
    ej = np.asarray(j_epi.sampson_error(J(Fj), J(uv1), J(uv2)))
    e = sampson_error(T(Fj), T(uv1), T(uv2)).numpy()
    np.testing.assert_allclose(e, ej, rtol=TOL, atol=TOL * 1e-2)


# ------------------------------------------------------------- RANSAC

def test_fundamental_ransac_matches_txr(rng):
    uv1, uv2, mask, _, _ = scene_pair(rng)
    key = jax.random.PRNGKey(3)
    Fj, inl_j = j_epi.fundamental_ransac(J(uv1), J(uv2), J(mask), key, 3.0,
                                         HYP)
    F, inl = fundamental_ransac(T(uv1), T(uv2), T(mask), None, 3.0, HYP,
                                priorities=T(priorities(key, len(uv1))))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    same_up_to_sign(F.numpy(), Fj)


@pytest.mark.parametrize("seed", [1, 2])
def test_essential_ransac_matches_txr(rng, seed):
    uv1, uv2, mask, _, _ = scene_pair(rng)
    key = jax.random.PRNGKey(seed)
    Ej, inl_j = j_epi.essential_ransac(J(uv1), J(uv2), J(mask), J(K), key,
                                       2.0, HYP)
    E, inl = essential_ransac(T(uv1), T(uv2), T(mask), T(K), None, 2.0, HYP,
                              priorities=T(priorities(key, len(uv1))))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    same_up_to_sign(E.numpy(), Ej)
    assert inl.sum() > 100


def test_ransac_draws_from_a_generator(rng):
    """Without priorities the draw comes from the generator: the same seed
    gives the same answer; a wrong priority shape raises."""
    uv1, uv2, mask, _, _ = scene_pair(rng)
    args = (T(uv1), T(uv2), T(mask), T(K))
    a = essential_ransac(*args, torch.Generator().manual_seed(0), 2.0, HYP)
    b = essential_ransac(*args, torch.Generator().manual_seed(0), 2.0, HYP)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="priorities"):
        essential_ransac(*args, None, 2.0, HYP,
                         priorities=torch.rand(HYP, len(uv1) + 1))


def test_homography_ransac_and_pose_match_txr(rng):
    uv1, uv2, mask, R_true, t_true = scene_pair(rng, planar=True,
                                                outliers=0.05)
    key = jax.random.PRNGKey(7)
    Hj, inl_j = j_hom.homography_ransac(J(uv1), J(uv2), J(mask), key, 3.0,
                                        HYP)
    H, inl = homography_ransac(T(uv1), T(uv2), T(mask), None, 3.0, HYP,
                               priorities=T(priorities(key, len(uv1))))
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    same_up_to_sign(H.numpy(), Hj)
    np.testing.assert_allclose(
        transfer_error(T(Hj), T(uv1), T(uv2)).numpy(),
        np.asarray(j_hom.transfer_error(Hj, J(uv1), J(uv2))), rtol=TOL,
        atol=TOL)
    np.testing.assert_allclose(
        homography_dlt(T(uv1), T(uv2), T(np.asarray(inl_j, np.float32)))
        .numpy(), np.asarray(j_hom.homography_dlt(
            J(uv1), J(uv2), J(np.asarray(inl_j, np.float32)))), atol=TOL)

    Rs, ts, ns = decompose_homography(T(Hj), T(K))
    Rsj, tsj, nsj = j_hom.decompose_homography(Hj, J(K))
    for g, w in ((Rs, Rsj), (ts, tsj), (ns, nsj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    R, t, good = recover_pose_homography(T(Hj), T(uv1), T(uv2), T(K),
                                         T(np.asarray(inl_j)))
    Rj, tj, good_j = j_hom.recover_pose_homography(Hj, J(uv1), J(uv2), J(K),
                                                   inl_j)
    np.testing.assert_array_equal(good.numpy(), np.asarray(good_j))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=TOL)
    assert abs(float(t.numpy() @ t_true)) > 0.99


# ------------------------------------------------------------- pose

def test_recover_pose_matches_txr(rng):
    uv1, uv2, mask, R_true, t_true = scene_pair(rng, outliers=0.0)
    key = jax.random.PRNGKey(0)
    Ej, inl = j_epi.essential_ransac(J(uv1), J(uv2), J(mask), J(K), key,
                                     2.0, HYP)
    Rj, tj, good_j = j_pose.recover_pose(Ej, J(uv1), J(uv2), J(K), inl)
    R, t, good = recover_pose(T(Ej), T(uv1), T(uv2), T(K),
                              T(np.asarray(inl)))
    np.testing.assert_array_equal(good.numpy(), np.asarray(good_j))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=TOL)
    assert float(t.numpy() @ t_true) > 0.99
    # E has two equal singular values, so its SVD's first two columns and
    # the sign of u2 are round-off on both sides: the two rotations may
    # come in the other order and t with the other sign, the set is the same
    R1, R2, tt = (a.numpy() for a in decompose_essential(T(Ej)))
    R1j, R2j, ttj = (np.asarray(a) for a in j_pose.decompose_essential(Ej))
    if np.abs(R1 - R1j).max() > TOL:
        R1, R2 = R2, R1
    np.testing.assert_allclose(R1, R1j, atol=TOL)
    np.testing.assert_allclose(R2, R2j, atol=TOL)
    same_up_to_sign(tt, ttj)
    Rc, tc = chain_pose(R, t, R, t)
    Rcj, tcj = j_pose.chain_pose(Rj, tj, Rj, tj)
    np.testing.assert_allclose(Rc.numpy(), np.asarray(Rcj), atol=TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(tcj), atol=TOL)


def test_refine_pose_matches_txr(rng):
    uv1, uv2, mask, R_true, t_true = scene_pair(rng, outliers=0.0,
                                                noise=0.2)
    R0 = (rotmat([0, 1, 0], np.radians(0.5)) @ R_true).astype(np.float32)
    t0 = t_true + np.array([0.0, 0.03, -0.03])
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    Rj, tj = j_refine(J(R0), J(t0), J(uv1), J(uv2), J(K), J(mask))
    R, t = refine_pose(T(R0), T(t0), T(uv1), T(uv2), T(K), T(mask))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=TOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=TOL)
    assert float(t.numpy() @ t_true) > float(t0 @ t_true)


# ------------------------------------------------------------- structure

def test_triangulate_reprojection_depth_match_txr(rng):
    uv1, uv2, mask, R_true, t_true = scene_pair(rng, outliers=0.0)
    Rf, tf = R_true.astype(np.float32), t_true.astype(np.float32)
    P1 = K @ np.c_[np.eye(3), np.zeros(3)].astype(np.float32)
    P2 = K @ np.c_[Rf, tf]
    Xj = np.asarray(j_tri(J(P1), J(P2), J(uv1), J(uv2)))
    X = triangulate(T(P1), T(P2), T(uv1), T(uv2)).numpy()
    np.testing.assert_allclose(X, Xj, rtol=TOL, atol=TOL)
    for P, uv in ((P1, uv1), (P2, uv2)):
        np.testing.assert_allclose(
            reprojection_error(T(P), T(Xj), T(uv)).numpy(),
            np.asarray(j_reproj(J(P), J(Xj), J(uv))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        depth_in_camera(T(Rf), T(tf), T(Xj)).numpy(),
        np.asarray(j_depth(J(Rf), J(tf), J(Xj))), rtol=TOL, atol=TOL)
    # a point at infinity: w = 0 gives inf, as in txr
    Pinf = np.c_[np.eye(3), np.zeros(3)].astype(np.float32)
    same = np.array([[0.5, 0.5]], np.float32)
    got = triangulate(T(Pinf), T(Pinf), T(same), T(same)).numpy()
    want = np.asarray(j_tri(J(Pinf), J(Pinf), J(same), J(same)))
    assert np.array_equal(np.isinf(got), np.isinf(want))


# ------------------------------------------------------------- scale

@pytest.mark.parametrize("gates", [dict(), dict(min_points=0,
                                                per_sample_clamp=True),
                                   dict(min_points=500)])
def test_estimate_scale_matches_txr(rng, gates):
    h, w = 48, 64
    depth = rng.uniform(0.5, 2.0, (h, w)).astype(np.float32)
    depth[:4] = 0.0                                  # invalid rows
    m = 300
    uv = np.c_[rng.uniform(-3, w + 3, m), rng.uniform(-3, h + 3, m)]
    uv[:5] = [[-0.9, 10.2], [63.99, 47.5], [10.0, -0.5], [20.7, 30.1],
              [64.0, 3.0]]                           # truncation edges
    uv = uv.astype(np.float32)
    z = rng.uniform(1.0, 30.0, m).astype(np.float32)
    z[:3] = [-1.0, np.inf, 5e4]
    xyz = np.c_[rng.normal(size=(m, 2)), z].astype(np.float32)
    mask = rng.random(m) < 0.85
    want = float(j_scale.estimate_scale(J(xyz), J(uv), J(mask), J(depth),
                                        **gates))
    got = float(estimate_scale(T(xyz), T(uv), T(mask), T(depth), **gates))
    assert got == pytest.approx(want, rel=TOL)
    # batched over leading axes: each row as on its own
    many = estimate_scale(T(np.stack([xyz, xyz[::-1]])),
                          T(np.stack([uv, uv[::-1]])),
                          T(np.stack([mask, mask[::-1]])),
                          T(np.stack([depth, depth])), **gates)
    assert many.shape == (2,)
    assert float(many[0]) == got and float(many[1]) == pytest.approx(
        got, rel=TOL)


def test_masked_median_and_clamps_match_txr(rng):
    for n, p in ((0, 0.5), (1, 1.0), (7, 0.5), (64, 0.0), (64, 0.7)):
        v = rng.normal(size=n).astype(np.float32)
        m = rng.random(n) < p
        want = float(j_scale.masked_median(J(v), J(m)))
        assert float(masked_median(T(v), T(m))) == pytest.approx(
            want, rel=TOL, abs=1e-7)
    s = np.array([0.0005, 0.5, 2000.0, np.nan, np.inf, 3.0], np.float32)
    np.testing.assert_array_equal(clamp_scale(T(s)).numpy(),
                                  np.asarray(j_scale.clamp_scale(J(s))))
    assert float(clamp_scale(5.0)) == 5.0
    assert ema_scale(2.0, 4.0) == pytest.approx(j_scale.ema_scale(2.0, 4.0))


def test_depth_scale_estimator_matches_txr(rng):
    depth = rng.uniform(0.5, 2.0, (32, 32)).astype(np.float32)
    uv = rng.uniform(0, 31, (40, 2)).astype(np.float32)
    pts = np.c_[rng.normal(size=(40, 2)),
                rng.uniform(2, 6, 40)].astype(np.float32)
    want = j_scale.DepthScaleEstimator().estimate_scale(pts, uv, depth)
    est = DepthScaleEstimator(device="cpu")
    assert est.estimate_scale(pts, uv, depth) == pytest.approx(want, rel=TOL)
    assert est.estimate_scale(T(pts), T(uv), T(depth)) == pytest.approx(
        want, rel=TOL)
    assert est.estimate_scale(np.zeros((0, 3)), np.zeros((0, 2)),
                              depth) == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DepthScaleEstimator()


# ------------------------------------------------------------- precision

def test_f32_dots_switches_tf32_off_and_restores():
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, dnn.allow_tf32
    try:
        mm.allow_tf32, dnn.allow_tf32 = True, True
        seen = []

        @f32_dots
        def inside():
            seen.append((mm.allow_tf32, dnn.allow_tf32))
            raise KeyError("the caller's settings come back on an error")

        with pytest.raises(KeyError):
            inside()
        assert seen == [(False, False)]
        assert (mm.allow_tf32, dnn.allow_tf32) == (True, True)
        with f32_dots():
            assert (mm.allow_tf32, dnn.allow_tf32) == (False, False)
        assert (mm.allow_tf32, dnn.allow_tf32) == (True, True)
        assert inside.__name__ == "inside"
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


def test_f32_dots_disabled_by_environment(monkeypatch):
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    monkeypatch.setenv("TXR_F32_DOTS", "0")
    try:
        mm.allow_tf32 = True
        with f32_dots():
            assert mm.allow_tf32
    finally:
        mm.allow_tf32 = saved
