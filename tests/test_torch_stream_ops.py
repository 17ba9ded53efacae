"""The streaming slice's building blocks on the port, against ``txr`` on
the CPU: point-to-plane ICP (``_so3_exp``, ``estimate_normals``,
``icp_point_to_plane``), the SE(3) pose graph, the appearance sketches and
the occupancy grid.

Both sides get the same numpy-seeded inputs (``tests/test_streaming.py``'s
surfaces, ``tests/test_loop_closure.py``'s circle problem).

Tolerances: the pose graph, the appearance sketches and scores and the
occupancy grid are host numpy on both sides, so bit-equal, and the PGM /
YAML files byte-equal. ``_so3_exp`` within 1e-6. The k-NN order is exact
(the same indices as ``jax.lax.top_k``, ties included). Normals within
1e-5: the same neighbours, f32 covariances summed in another order, then
the same fixed-sweep Jacobi. ICP's R and t within 1e-5 and the inlier
fraction exact: f32 products in another order over the same nearest
neighbours. The rmse is the root of a mean of expanded squared
distances |p|^2 + |q|^2 - 2 p.q, which near convergence is round-off of
|x|^2: its square is held to 16 f32 ulps of the largest |x|^2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop_closure
from test_occupancy import _scene as occupancy_scene
from test_streaming import make_surface, rotz
from txr.fusion import occupancy as jocc
from txr.geometry import appearance as japp
from txr.geometry import icp as jicp
from txr.geometry import pose_graph as jpg
from txr_torch.fusion import occupancy as tocc
from txr_torch.geometry import appearance as tapp
from txr_torch.geometry import icp as ticp
from txr_torch.geometry import pose_graph as tpg

torch.set_num_threads(1)

NORMAL_ATOL = 1e-5
ICP_ATOL = 1e-5
RMSE_SQ_ULPS = 2.0 ** -20   # 16 f32 ulps of the largest |x|^2


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- ICP

@pytest.mark.parametrize("w", [[0.0, 0.0, 0.0], [0.0, 0.0, 0.3],
                               [1e-5, -2e-5, 3e-5], [0.4, -1.1, 0.7]])
def test_so3_exp_equal_txr(w):
    w = np.asarray(w, np.float32)
    got = ticp._so3_exp(T(w)).numpy()
    want = np.asarray(jicp._so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_top_k_smallest_keeps_top_k_order_on_ties():
    """Lattice points: many equal distances, negative zeros and round-off
    negatives; the indices of ``top_k(-d2, k)``, ties in index order."""
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32) * 0.1
    sq = (g * g).sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * g @ g.T
    d2[0, 5] = -0.0
    d2[1, 2] = -1e-9
    want = np.asarray(jax.lax.top_k(-jnp.asarray(d2), 8)[1])
    got = ticp.top_k_smallest(T(d2), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["plane", "surface_half_masked",
                                  "fewer_set_than_k"])
def test_estimate_normals_equal_txr(rng, case):
    if case == "plane":
        pts = np.column_stack([rng.uniform(-1, 1, (500, 2)),
                               np.zeros(500)]).astype(np.float32)
        mask = np.ones(500, bool)
    elif case == "surface_half_masked":
        pts = make_surface(rng, 2000)
        mask = np.ones(2000, bool)
        mask[1000:] = False
    else:   # the dense route over every row: masked rows among the nearest
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        mask = np.zeros(100, bool)
        mask[[3, 40, 77]] = True
    want = np.asarray(jicp.estimate_normals(jnp.asarray(pts),
                                            jnp.asarray(mask)))
    got = ticp.estimate_normals(T(pts), T(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=NORMAL_ATOL)
    assert (got[~mask] == 0).all()


def _icp_both(src, smask, tgt, tmask, iterations, max_corr):
    nj = jicp.estimate_normals(jnp.asarray(tgt), jnp.asarray(tmask))
    want = jicp.icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), nj,
        jnp.asarray(tmask), jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), iterations=iterations,
        max_correspondence=max_corr)
    nt = ticp.estimate_normals(T(tgt), T(tmask))
    got = ticp.icp_point_to_plane(
        T(src), T(smask), T(tgt), nt, T(tmask), torch.eye(3),
        torch.zeros(3), iterations=iterations, max_correspondence=max_corr)
    return [np.asarray(a) for a in want], [a.numpy() for a in got]


@pytest.mark.parametrize("case", ["small_transform", "identity",
                                  "masked_rows"])
def test_icp_point_to_plane_equal_txr(rng, case):
    if case == "identity":
        tgt = make_surface(rng, 800)
        src, iters, corr = tgt, 5, 0.1
    else:
        tgt = make_surface(rng)
        R_true = rotz(0.05)
        t_true = np.array([0.03, -0.02, 0.01], np.float32)
        src = (tgt - t_true) @ R_true
        iters, corr = 15, 0.2
    smask = np.ones(len(src), bool)
    tmask = np.ones(len(tgt), bool)
    if case == "masked_rows":
        smask[::7] = False
        tmask[::5] = False
        src = src[:1500]            # not a multiple of the 1024-row chunk
        smask = smask[:1500]
    (Rj, tj, rj, fj), (Rt, tt, rt, ft) = _icp_both(src, smask, tgt, tmask,
                                                    iters, corr)
    np.testing.assert_allclose(Rt, Rj, atol=ICP_ATOL)
    np.testing.assert_allclose(tt, tj, atol=ICP_ATOL)
    # rmse is the root of mean |p|^2 + |q|^2 - 2 p.q: near convergence
    # that expansion is f32 round-off of |x|^2, so its squares agree to
    # a few ulps of the largest |x|^2
    sq_max = float(max((src * src).sum(-1).max(), (tgt * tgt).sum(-1).max()))
    assert abs(float(rt) ** 2 - float(rj) ** 2) <= RMSE_SQ_ULPS * sq_max
    assert float(ft) == float(fj)
    if case != "identity":
        np.testing.assert_allclose(Rt, rotz(0.05), atol=5e-3)


# ------------------------------------------------------------- pose graph

def test_se3_functions_bit_equal(rng):
    for _ in range(20):
        xi = rng.normal(size=6) * 0.8
        Tm = jpg.se3_exp(xi)
        np.testing.assert_array_equal(tpg.se3_exp(xi), Tm)
        np.testing.assert_array_equal(tpg.se3_log(Tm), jpg.se3_log(Tm))
        np.testing.assert_array_equal(tpg.so3_exp(xi[3:]),
                                      jpg.so3_exp(xi[3:]))
    for th in (np.pi - 1e-7, np.pi, 1e-10):
        axis = np.array([0.3, -0.7, 0.648])
        R = jpg.so3_exp(axis / np.linalg.norm(axis) * th)
        np.testing.assert_array_equal(tpg.so3_log(R), jpg.so3_log(R))


@pytest.mark.parametrize("noise", [0.02, 0.0])
def test_optimize_pose_graph_bit_equal(rng, noise):
    gt, est, meas = test_loop_closure.TestPoseGraph()._circle_problem(
        rng, noise=noise)
    want = jpg.optimize_pose_graph(est, meas, fixed=0)
    got = tpg.optimize_pose_graph(est, meas, fixed=0)
    assert len(got) == len(want)
    for (Rg, tg), (Rw, tw) in zip(got, want):
        np.testing.assert_array_equal(Rg, Rw)
        np.testing.assert_array_equal(tg, tw)
        assert Rg.dtype == Rw.dtype == np.float32


# ------------------------------------------------------------- appearance

def test_appearance_sketch_and_scores_bit_equal(rng):
    sketches_t, sketches_j = [], []
    for n in (300, 40, 0):
        desc = np.abs(rng.normal(size=(512, 128))).astype(np.float32) * 50
        mask = np.zeros(512, bool)
        mask[:n] = True
        want = japp.appearance_sketch(desc, mask)
        got_np = tapp.appearance_sketch(desc, mask)
        got_t = tapp.appearance_sketch(T(desc), T(mask))
        np.testing.assert_array_equal(got_np, want)
        np.testing.assert_array_equal(got_t, want)
        assert got_t.dtype == want.dtype == np.float32
        sketches_t.append(got_t)
        sketches_j.append(want)
    q = sketches_j[0]
    np.testing.assert_array_equal(
        tapp.appearance_scores(np.stack(sketches_t), q),
        japp.appearance_scores(np.stack(sketches_j), q))
    assert tapp.appearance_scores(np.zeros((0, 2048)), q).shape == (0,)
    assert tapp.sketch_dim(128) == japp.sketch_dim(128)


# -------------------------------------------------------------- occupancy

@pytest.mark.parametrize("case", ["scene", "no_centers", "empty"])
def test_occupancy_grid_and_files_equal_txr(tmp_path, case):
    xyz, centers = occupancy_scene()
    if case == "no_centers":
        centers = None
    elif case == "empty":
        xyz = np.zeros((0, 3))
    kw = dict(camera_centers=centers, cell_size=0.1, range_max=5.0)
    gw, ow = jocc.occupancy_grid(xyz, **kw)
    gt, ot = tocc.occupancy_grid(xyz, **kw)
    np.testing.assert_array_equal(gt, gw)
    assert gt.dtype == gw.dtype and ot == ow
    pj = jocc.write_occupancy_map(str(tmp_path / "txr"), gw, ow, 0.1)
    pt = tocc.write_occupancy_map(str(tmp_path / "port"), gt, ot, 0.1)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    yj = (tmp_path / "txr.yaml").read_text().replace("txr.pgm", "X")
    yt = (tmp_path / "port.yaml").read_text().replace("port.pgm", "X")
    assert yt == yj
