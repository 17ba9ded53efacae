"""The fusion CLI on the port, against ``txr`` on the CPU: dense
back-projection, the merges (single pass, chunked, host clouds),
``DepthToReconstructionPipeline`` on two synthetic scenes, its routes and
narration, the reference-named facades and ``depth_to_reconstruction_torch.py``.

Both packages take OpenCV's SIFT (the ``cv2`` backend: the same keypoints);
the port is fed the RANSAC priorities ``txr`` draws from its key stream
(``jax.random.PRNGKey(0)``, one split per pair, an essential and a
homography key per pair), so both run the same hypotheses.

Tolerances: poses within 1e-4, scales within 1e-4 relative, the fused cloud
within a chamfer distance of 1e-3 of the scene's depth from ``txr``'s;
dense points within 1e-5; the golden scene at ``tests/test_golden.py``'s
device-backend bar (1 % of the scene's scale, its 85th-percentile z within
1 %).
"""

import argparse
import contextlib
import importlib.util
import io
import os
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

cv2 = pytest.importorskip("cv2")

from test_fusion_pipeline import CX as PCX, CY as PCY  # noqa: E402
from test_fusion_pipeline import FX as PFX, FY as PFY  # noqa: E402
from test_fusion_pipeline import REL_SCALE, _render, _texture  # noqa: E402
from test_golden import CX as GCX, CY as GCY  # noqa: E402
from test_golden import FX as GFX, FY as GFY  # noqa: E402
from test_golden import GOLDEN, build_scene  # noqa: E402
from txr.core.config import ReconstructionConfig as JConfig  # noqa: E402
from txr.core.types import PointSet as JPointSet  # noqa: E402
from txr.fusion import chunked_merge as jcm  # noqa: E402
from txr.fusion import pointcloud as jpc  # noqa: E402
from txr.geometry import homography as jh  # noqa: E402
from txr.ops import voxel as jvox  # noqa: E402
from txr.io.ply import read_ply  # noqa: E402
from txr.pipelines import fusion_pipeline as jfp  # noqa: E402
from txr.utils.chamfer import chamfer_distance  # noqa: E402
from txr_torch.core.config import ReconstructionConfig  # noqa: E402
from txr_torch.core.types import PointSet  # noqa: E402
from txr_torch.fusion import chunked_merge as pcm  # noqa: E402
from txr_torch.fusion import pointcloud as ppc  # noqa: E402
from txr_torch.geometry import homography as th  # noqa: E402
from txr_torch.geometry.epipolar import sample_indices  # noqa: E402
from txr_torch.ops import voxel as pvox  # noqa: E402
from txr_torch.pipelines import fusion_pipeline as tfp  # noqa: E402
from test_torch_io import private_txr_native  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
HYP = 1024
ROWS = 4096                   # the pipelines' feature capacity


@pytest.fixture(scope="module", autouse=True)
def txr_native_of_this_worker(tmp_path_factory):
    """``txr``'s native library, built for this module alone: ``txr``'s
    in-place build (``txr/_native/__init__.py:44-58``) races other test
    workers (see ``test_torch_io.py:private_txr_native``)."""
    with private_txr_native(tmp_path_factory.mktemp("txr_native")):
        yield


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def txr_priorities(pairs: int, rows: int) -> torch.Tensor:
    """The RANSAC priorities txr's pipeline draws: PRNGKey(0) split once
    per pair, each pair's key split into the essential and homography
    keys, HYP x rows uniforms from each."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(pairs):
        key, sub = jax.random.split(key)
        out.append([np.asarray(jax.random.uniform(k, (HYP, rows)))
                    for k in jax.random.split(sub)])
    return torch.from_numpy(np.asarray(out))


def homography_winners(pairs_out: tuple, cfg: dict,
                       prio: torch.Tensor) -> list:
    """Per pair, both packages' homography RANSAC on the rows the port's
    ``_pairs_batch`` matched (its output ``pairs_out``) and the draws
    ``prio``; the pairs whose winners differ."""
    c = ReconstructionConfig(**cfg)
    rows = []
    thr = 2.0 * max(c.ransac_threshold, 3.0) ** 2
    for p in range(prio.shape[0]):
        u1, u2, ok = (a[p] for a in pairs_out[6:9])
        idx = sample_indices(ok, 4, HYP, None, prio[p, 1])
        Ht = th.homography_dlt(u1[idx], u2[idx])
        et = th.transfer_error(Ht, u1, u2).numpy()
        Hj = jax.vmap(jh.homography_dlt)(jnp.asarray(u1.numpy())[idx.numpy()],
                                         jnp.asarray(u2.numpy())[idx.numpy()])
        ej = np.asarray(jax.vmap(jh.transfer_error, in_axes=(0, None, None))(
            Hj, jnp.asarray(u1.numpy()), jnp.asarray(u2.numpy())))
        okn = ok.numpy()
        cnt_t = ((et < thr) & okn).sum(-1)
        cnt_j = ((ej < thr) & okn).sum(-1)
        bt, bj = int(cnt_t.argmax()), int(cnt_j.argmax())
        if bt == bj:
            continue
        diff = np.flatnonzero(((et[bt] < thr) != (ej[bt] < thr)) & okn)
        a = Ht[bt].numpy() / Ht[bt].numpy()[2, 2]
        b = np.asarray(Hj[bt]) / np.asarray(Hj[bt])[2, 2]
        rows.append({"pair": [p, p + 1], "winner_port": bt,
                     "winner_txr": bj,
                     "inliers_port": [int(cnt_t[bt]), int(cnt_t[bj])],
                     "inliers_txr": [int(cnt_j[bt]), int(cnt_j[bj])],
                     "rows_differing": diff.tolist(),
                     "transfer_err_port": et[bt][diff].tolist(),
                     "transfer_err_txr": ej[bt][diff].tolist(),
                     "threshold": thr,
                     "H_rel_diff_of_port_winner": float(np.abs(a - b).max())})
    return rows



# ---------------------------------------------------------------- dense ops

def _views(rng, n=5, h=24, w=32):
    depths = rng.uniform(1.0, 3.0, (n, h, w)).astype(np.float32)
    depths[:, :2] = 0.0                       # invalid rows
    bgrs = rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8)
    Rs = np.stack([cv2.Rodrigues(rng.normal(0, 0.05, 3))[0]
                   for _ in range(n)]).astype(np.float32)
    ts = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.8, 1.2, n).astype(np.float32)
    keep = np.arange(n) != 1                  # view 1 skipped
    return depths, bgrs, Rs, ts, scales, keep


CAM = dict(fx=30.0, fy=30.0, cx=16.0, cy=12.0, min_depth=0.1, max_depth=50.0)


def _f64_means(xyz, rgb, vs, origin=None):
    """float64 per-voxel means of (xyz, rgb) rows, in ascending voxel
    order, keyed as both packages key them (f32 (xyz - origin) / vs)."""
    o = xyz.min(0) if origin is None else origin
    keys = np.floor((xyz - o) / np.float32(vs)).astype(np.int32)
    uk, inv = np.unique(keys, axis=0, return_inverse=True)
    sums = np.zeros((len(uk), 7))
    np.add.at(sums, inv.reshape(-1),
              np.concatenate([xyz, rgb, np.ones((len(xyz), 1))], 1))
    return sums[:, :6] / sums[:, 6:]


def _hold_to_budget(got, want, ref):
    """The port within 1e-5 of the float64 reduce; txr within its own
    cumulative-sum error of it, and the port within that of txr."""
    assert np.abs(got - ref).max() <= 1e-5
    budget = np.abs(want - ref).max()
    assert np.abs(got - want).max() <= budget + 1e-5
    return budget


def test_depth_to_pointcloud_matches_txr():
    rng = np.random.default_rng(0)
    depths, bgrs, Rs, ts, *_ = _views(rng, n=1)
    args = (depths[0], bgrs[0], Rs[0], ts[0], 30.0, 30.0, 16.0, 12.0)
    want = jpc.depth_to_pointcloud(*args, scale=1.5, subsample=2)
    got = ppc.depth_to_pointcloud(*args, scale=1.5, subsample=2,
                                  device="cpu")
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                               atol=1e-6)


@pytest.mark.parametrize("chunk_views", [1, 2, 8])
def test_chunked_merge_matches_txr_and_the_single_pass(chunk_views):
    rng = np.random.default_rng(1)
    views = _views(rng)
    kw = dict(CAM, subsample=1, voxel_size=0.1, chunk_views=chunk_views)
    got, counts = pcm.chunked_dense_voxel_merge(*views, device="cpu", **kw)
    want, jcounts = jcm.chunked_dense_voxel_merge(*views, **kw)
    np.testing.assert_array_equal(counts, jcounts)
    m = got.mask.numpy()
    jm = np.asarray(want.mask)
    assert m.sum() == jm.sum() and m[:m.sum()].all()
    # the single pass over the same views, and the float64 reduce of them
    flat, c1 = ppc.backproject_views(
        *(T(a) for a in views), CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"],
        CAM["min_depth"], CAM["max_depth"], 1)
    single = pvox.voxel_downsample(flat, 0.1)
    np.testing.assert_array_equal(c1.numpy(), counts)
    s = single.mask.numpy()
    assert s.sum() == m.sum()
    fm = flat.mask.numpy()
    ref = _f64_means(flat.xyz.numpy()[fm], flat.rgb.numpy()[fm], 0.1)
    g = np.concatenate([got.xyz.numpy(), got.rgb.numpy()], 1)[m]
    j = np.concatenate([np.asarray(want.xyz), np.asarray(want.rgb)], 1)[jm]
    _hold_to_budget(g, j, ref)
    np.testing.assert_allclose(
        g, np.concatenate([single.xyz.numpy(), single.rgb.numpy()], 1)[s],
        rtol=1e-5, atol=1e-5)


def test_chunked_merge_extra_points_and_empty_views():
    rng = np.random.default_rng(2)
    depths, bgrs, Rs, ts, scales, keep = _views(rng, n=3)
    extra_xyz = rng.uniform(-1, 3, (40, 3)).astype(np.float32)
    extra_rgb = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    kw = dict(CAM, subsample=1, voxel_size=0.1, chunk_views=2)
    args = (list(depths) + [None], list(bgrs) + [None],
            np.concatenate([Rs, Rs[:1]]), np.concatenate([ts, ts[:1]]),
            np.append(scales, 1.0), np.append(keep, True))
    got, _ = pcm.chunked_dense_voxel_merge(
        *args, device="cpu",
        extra=PointSet.from_numpy(extra_xyz, extra_rgb, device="cpu"), **kw)
    want, _ = jcm.chunked_dense_voxel_merge(
        *args, extra=JPointSet.from_numpy(extra_xyz, extra_rgb), **kw)
    flat, _ = ppc.backproject_views(
        *(T(a) for a in (depths, bgrs, Rs, ts, scales, keep)), CAM["fx"],
        CAM["fy"], CAM["cx"], CAM["cy"], CAM["min_depth"], CAM["max_depth"],
        1)
    fm = flat.mask.numpy()
    rows = np.concatenate([flat.xyz.numpy()[fm], extra_xyz])
    cols = np.concatenate([flat.rgb.numpy()[fm], extra_rgb])
    ref = _f64_means(rows, cols, 0.1)
    m, jm = got.mask.numpy(), np.asarray(want.mask)
    assert m.sum() == jm.sum() == len(ref)
    _hold_to_budget(
        np.concatenate([got.xyz.numpy(), got.rgb.numpy()], 1)[m],
        np.concatenate([np.asarray(want.xyz), np.asarray(want.rgb)], 1)[jm],
        ref)
    dead, counts = pcm.chunked_dense_voxel_merge(
        np.zeros_like(depths), bgrs, Rs, ts, scales, keep, device="cpu", **kw)
    assert not dead.mask.any() and (counts == 0).all()


@pytest.mark.parametrize("rows", [3000, 140_000])
def test_merge_pointclouds_matches_txr(rows):
    """Below 2^17 rows the exact outlier pass, above it the grid pass with
    a cell of 2.5 voxels; colours out in 0..255. The voxel stage is held to
    a float64 reduce (txr to its own cumulative-sum error); above 2^17 rows
    that error moves a few borderline points across the outlier threshold,
    so there the clouds are compared by count (0.1 %) and chamfer."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1.0, (rows // 2, 3)).astype(np.float32)
    b = rng.normal(0, 1.0, (rows - rows // 2, 3)).astype(np.float32)
    ca = rng.uniform(0, 255, a.shape).astype(np.float32)
    clouds = [(a, ca), (b, np.zeros((0, 3), np.float32)),
              (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))]
    vs = 0.05 if rows < 10000 else 0.02
    gx, gc = ppc.merge_pointclouds(clouds, voxel_size=vs, device="cpu")
    jx, jc = jpc.merge_pointclouds(clouds, voxel_size=vs)
    assert gc.max() > 1.5 and len(gx) > 0
    xyz = np.concatenate([a, b])
    rgb = np.concatenate([ca / 255.0, np.zeros_like(b)])
    cap = 1 << max(10, int(np.ceil(np.log2(rows))))
    ref = _f64_means(xyz, rgb, vs)
    vg = pvox.voxel_downsample(
        PointSet.from_numpy(xyz, rgb, capacity=cap, device="cpu"), vs)
    vj = jvox.voxel_downsample(JPointSet.from_numpy(xyz, rgb, capacity=cap),
                               vs)
    budget = _hold_to_budget(
        np.concatenate([vg.xyz.numpy(), vg.rgb.numpy()], 1)[vg.mask.numpy()],
        np.concatenate([np.asarray(vj.xyz),
                        np.asarray(vj.rgb)], 1)[np.asarray(vj.mask)], ref)
    if rows < (1 << 17):
        assert len(gx) == len(jx)
        assert np.abs(gx - jx).max() <= budget + 1e-5
        assert np.abs(gc - jc).max() <= 255 * budget + 1e-3
    else:
        assert abs(len(gx) - len(jx)) <= 1e-3 * len(jx)
        d, _ = cKDTree(jx).query(gx)
        # every point but the borderline ones (0.1 %) is one of txr's
        assert (d > budget + 1e-5).mean() <= 1e-3


def test_dense_point_cloud_generator_matches_txr():
    rng = np.random.default_rng(4)
    gen = ppc.DensePointCloudGenerator(np.array([[30, 0, 16], [0, 30, 12],
                                                 [0, 0, 1]]), device="cpu")
    jgen = jpc.DensePointCloudGenerator(np.array([[30, 0, 16], [0, 30, 12],
                                                  [0, 0, 1]]))
    depth = rng.uniform(1, 2, (24, 32)).astype(np.float32)
    img = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    px, pc_ = gen.depth_to_pointcloud(depth, img, subsample=2)
    qx, qc = jgen.depth_to_pointcloud(depth, img, subsample=2)
    np.testing.assert_allclose(px, qx, rtol=1e-5, atol=1e-5)
    mx, _ = gen.merge_pointclouds([(px, pc_)], voxel_size=0.1)
    nx, _ = jgen.merge_pointclouds([(qx, qc)], voxel_size=0.1)
    np.testing.assert_allclose(mx, nx, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- pipeline

def _fusion_scene(root):
    rng = np.random.default_rng(7)
    rgb_dir, depth_dir = root / "rgb", root / "depth"
    rgb_dir.mkdir()
    depth_dir.mkdir()
    fg_tex, bg_tex = _texture(rng), _texture(rng)
    for i, tx in enumerate([0.0, 0.12, 0.24]):
        img, depth = _render(tx, fg_tex, bg_tex)
        cv2.imwrite(str(rgb_dir / f"frame_{i:03d}.png"), img)
        np.save(depth_dir / f"frame_{i:03d}_depth.npy", depth / REL_SCALE)
    return str(rgb_dir), str(depth_dir)


SCENES = {
    "fusion_pipeline": dict(
        build=_fusion_scene,
        cfg=dict(fx=PFX, fy=PFY, cx=PCX, cy=PCY,
                 voxel_size=0.05, subsample_factor=4)),
    "golden": dict(
        build=lambda root: build_scene(str(root)),
        cfg=dict(fx=GFX, fy=GFY, cx=GCX, cy=GCY, voxel_size=0.05,
                 subsample_factor=4, max_depth=60.0)),
}
SCALE_LINE = re.compile(r"Average scale: ([0-9.]+)|\(scale ([0-9.]+)\)")


@contextlib.contextmanager
def record_pairs():
    """Collects the outputs of the port's ``_pairs_batch`` calls."""
    outs, fn = [], tfp._pairs_batch

    def recorded(*args, **kwargs):
        outs.append(fn(*args, **kwargs))
        return outs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfp, "_pairs_batch", recorded)
        yield outs


@pytest.fixture(scope="module")
def scene_runs(tmp_path_factory):
    """Each scene through txr's pipeline and the port's, with txr's
    RANSAC draws; narration captured."""
    out = {}
    for name, sc in SCENES.items():
        root = tmp_path_factory.mktemp(name)
        rgb_dir, depth_dir = sc["build"](root)
        res = {}
        for side in ("txr", "port"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if side == "txr":
                    pipe = jfp.DepthToReconstructionPipeline(
                        JConfig(**sc["cfg"]), feature_capacity=ROWS,
                        feature_backend="cv2")
                    pipe.load_data(rgb_dir, depth_dir)
                    pts, cols, poses = pipe.reconstruct()
                else:
                    pipe = tfp.DepthToReconstructionPipeline(
                        ReconstructionConfig(**sc["cfg"]),
                        feature_capacity=ROWS, feature_backend="cv2",
                        device="cpu")
                    pipe.load_data(rgb_dir, depth_dir)
                    prio = txr_priorities(2, ROWS)
                    with record_pairs() as pairs_out:
                        pts, cols, poses = pipe.reconstruct(priorities=prio)
            res[side] = dict(points=pts, colors=cols, poses=poses,
                             text=buf.getvalue())
        res["homography_flips"] = homography_winners(pairs_out[0],
                                                     sc["cfg"], prio)
        res["dirs"] = (rgb_dir, depth_dir)
        out[name] = res
    return out


# Views whose pair takes another homography RANSAC winner in the two
# packages (the test asserts that these, and only these, do): on the
# test_fusion_pipeline scene, pair (1, 2)'s hypothesis 791 is a
# near-degenerate 4-point fit whose H differs by 0.45 % between the two
# eigen solvers, and one row's transfer error (17.96 / 18.02 px^2) falls on
# either side of the 18 px^2 threshold, so the port keeps that hypothesis
# (695 inliers) and txr hypothesis 9 (694). ROADMAP.md Queue 3 records it;
# that view's t and scale are held to what the measurement showed (3.2e-3,
# 1.1e-3 relative), everything else to the tolerances above.
THRESHOLD_FLIPS = {"fusion_pipeline": {2: dict(t=1e-2, scale=3e-3)}}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pipeline_matches_txr(scene_runs, scene):
    r = scene_runs[scene]
    j, p = r["txr"], r["port"]
    flips = THRESHOLD_FLIPS.get(scene, {})
    # the views held loosely are exactly those whose pair keeps another
    # homography winner, and each of those only by rows at the threshold
    flipped = r["homography_flips"]
    assert sorted(row["pair"][1] for row in flipped) == sorted(flips)
    for row in flipped:
        assert row["rows_differing"]
        for e in row["transfer_err_port"] + row["transfer_err_txr"]:
            assert abs(e / row["threshold"] - 1) < 0.01, row
    assert len(p["poses"]) == len(j["poses"]) == 3
    for i, ((Rp, tp), (Rj, tj)) in enumerate(zip(p["poses"], j["poses"])):
        np.testing.assert_allclose(Rp, Rj, atol=1e-4)
        np.testing.assert_allclose(tp, tj,
                                   atol=flips.get(i, dict(t=1e-4))["t"])
    sj = [float(a or b) for a, b in SCALE_LINE.findall(j["text"])]
    sp = [float(a or b) for a, b in SCALE_LINE.findall(p["text"])]
    assert len(sp) == len(sj) == 2          # the average, then view 2's
    np.testing.assert_allclose(sp[0], sj[0], rtol=1e-4)
    np.testing.assert_allclose(sp[1], sj[1],
                               rtol=flips.get(2, dict(scale=1e-4))["scale"])
    depth = float(np.percentile(j["points"][:, 2], 85))
    assert chamfer_distance(p["points"], j["points"]) < 1e-3 * depth
    assert abs(len(p["points"]) / len(j["points"]) - 1) < 0.01
    assert p["colors"].max() > 1.5
    # the same narration, line for line, but the header's device
    lj = [l for l in j["text"].splitlines() if "PIPELINE" not in l]
    lp = [l for l in p["text"].splitlines() if "PIPELINE" not in l]
    assert len(lp) == len(lj)
    for a, b in zip(lp, lj):
        if SCALE_LINE.search(a) or "points" in a or "detected" in a:
            continue                     # numbers compared above
        assert a == b


def test_golden_scene_against_the_committed_cloud(scene_runs):
    """The port's golden-scene cloud against tests/golden/fusion_scene.ply
    at test_golden.py's device-backend bar."""
    points = scene_runs["golden"]["port"]["points"]
    gold, _ = read_ply(GOLDEN)
    assert len(points) > 1000
    assert points[:, 2].max() - points[:, 2].min() > 15.0
    d = chamfer_distance(points, gold)
    scene = float(np.percentile(gold[:, 2], 85))
    assert d < 0.01 * scene, (d, d / scene)
    assert abs(np.percentile(points[:, 2], 85) / scene - 1) < 0.01


def _tiny_scene(root):
    """test_chunked_merge.py's three-frame 96 x 128 scene."""
    rng = np.random.default_rng(0)
    h, w = 96, 128
    rgb_dir, dep_dir = root / "rgb", root / "depth"
    rgb_dir.mkdir()
    dep_dir.mkdir()
    base = np.full((h, w, 3), 70, np.uint8)
    for _ in range(40):
        c = rng.integers(0, 255, 3).tolist()
        p = (int(rng.integers(5, w - 12)), int(rng.integers(5, h - 10)))
        cv2.rectangle(base, p, (p[0] + 6, p[1] + 5), c, -1)
    for i, dx in enumerate([0, 5, 10]):
        M = np.float32([[1, 0, dx], [0, 1, 0]])
        cv2.imwrite(str(rgb_dir / f"f_{i:02d}.png"),
                    cv2.warpAffine(base, M, (w, h)))
        np.save(str(dep_dir / f"f_{i:02d}_depth.npy"),
                (2.0 + 0.1 * rng.uniform(size=(h, w))).astype(np.float32))
    cfg = dict(fx=110.0, fy=110.0, cx=w / 2.0, cy=h / 2.0, voxel_size=0.05,
               subsample_factor=2)
    return str(rgb_dir), str(dep_dir), cfg


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny_scene(tmp_path_factory.mktemp("tiny"))


def _port_run(tiny, **pipe_kw):
    rgb_dir, dep_dir, cfg = tiny
    pipe = tfp.DepthToReconstructionPipeline(
        ReconstructionConfig(**cfg), feature_capacity=1024, verbose=False,
        device="cpu", **pipe_kw)
    pipe.load_data(rgb_dir, dep_dir)
    return pipe.reconstruct()


def test_routes_equal_the_default_route(tiny, monkeypatch):
    """TXR_SEQ_CHUNK slabs give the same result bit for bit; the chunked
    dense merge (TXR_DENSE_SINGLE_ROWS=1) the same surface and density up to
    the outlier pass's borderline points."""
    pts_a, col_a, poses_a = _port_run(tiny)
    assert pts_a is not None and len(pts_a) > 500
    monkeypatch.setenv("TXR_SEQ_CHUNK", "1")
    pts_s, col_s, poses_s = _port_run(tiny)
    np.testing.assert_array_equal(pts_s, pts_a)
    np.testing.assert_array_equal(col_s, col_a)
    for (Ra, ta), (Rs, ts) in zip(poses_a, poses_s):
        np.testing.assert_array_equal(Ra, Rs)
        np.testing.assert_array_equal(ta, ts)
    monkeypatch.delenv("TXR_SEQ_CHUNK")
    monkeypatch.setenv("TXR_DENSE_SINGLE_ROWS", "1")
    pts_c, _, _ = _port_run(tiny)
    assert abs(len(pts_c) - len(pts_a)) <= 0.03 * len(pts_a)
    sub = pts_c[:: max(1, len(pts_c) // 500)]
    dmin = np.sqrt(((sub[:, None] - pts_a[None]) ** 2).sum(-1)).min(1)
    assert float(np.quantile(dmin, 0.99)) < 0.05


def test_mixed_resolutions_and_too_few_images(tiny, tmp_path, capsys):
    rgb_dir, dep_dir, cfg = tiny
    mix_rgb, mix_dep = tmp_path / "rgb", tmp_path / "depth"
    mix_rgb.mkdir()
    mix_dep.mkdir()
    for name in sorted(os.listdir(rgb_dir)):
        base = os.path.splitext(name)[0]
        img = cv2.imread(os.path.join(rgb_dir, name))
        depth = np.load(os.path.join(dep_dir, base + "_depth.npy"))
        if base.endswith("02"):       # the last frame arrives larger
            img = cv2.resize(img, (160, 120), interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(str(mix_rgb / name), img)
        np.save(mix_dep / f"{base}_depth.npy", depth)
    points, _, poses = _port_run((str(mix_rgb), str(mix_dep), cfg))
    assert points is not None and len(points) > 500
    assert np.isfinite(points).all() and len(poses) == 3
    pipe = tfp.DepthToReconstructionPipeline(verbose=True, device="cpu")
    assert pipe.reconstruct() == (None, None, None)
    assert "Need at least 2 images" in capsys.readouterr().out


def test_load_data_needs_opencv_only_where_txr_does(tiny, tmp_path,
                                                    monkeypatch):
    """Without OpenCV, JPEG frames with depth of their own size load; a
    depth map of another size raises ImportError naming the resize."""
    rgb_dir, dep_dir, _ = tiny
    jpg = tmp_path / "jpg"
    jpg.mkdir()
    img = cv2.imread(os.path.join(rgb_dir, "f_00.png"))
    cv2.imwrite(str(jpg / "f_00.jpg"), img)
    pipe = tfp.DepthToReconstructionPipeline(verbose=False, device="cpu",
                                             feature_backend="device")
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert pipe.load_data(str(jpg), dep_dir) == 1
    small = tmp_path / "small"
    small.mkdir()
    np.save(small / "f_00_depth.npy", np.ones((10, 10), np.float32))
    with pytest.raises(ImportError, match="resizing a depth map"):
        pipe.load_data(str(jpg), str(small))


# ----------------------------------------------------------------- facades

def _textured(rng, shift=0):
    img = np.full((240, 320, 3), 100, np.uint8)
    for _ in range(40):
        c = rng.integers(0, 255, 3).tolist()
        p = (int(rng.integers(10, 300)), int(rng.integers(10, 220)))
        cv2.rectangle(img, p, (p[0] + 10, p[1] + 8), c, -1)
    if shift:
        M = np.float32([[1, 0, shift], [0, 1, 0]])
        img = cv2.warpAffine(img, M, (320, 240))
    return img


def test_sparse_reconstructor_facade():
    cfg = ReconstructionConfig(fx=260, fy=260, cx=160, cy=120)
    sr = tfp.SparseReconstructor(cfg, feature_capacity=4096, device="cpu")
    img1 = _textured(np.random.default_rng(0))
    img2 = _textured(np.random.default_rng(0), shift=10)
    pts1, pts2, n = sr.detect_and_match(img1, img2)
    assert n >= 8
    R, t, mask = sr.compute_pose(pts1, pts2)
    assert R is not None and R.shape == (3, 3)
    X = sr.triangulate(pts1[mask], pts2[mask], R, t)
    assert X.shape == (mask.sum(), 3)
    valid = sr.filter_points(X, pts1[mask], pts2[mask], R, t)
    assert valid.dtype == bool
    R, t, mask = sr.compute_pose(np.zeros((3, 2), np.float32),
                                 np.zeros((3, 2), np.float32))
    assert R is None


def test_dense_reconstructor_facade_matches_txr():
    rng = np.random.default_rng(1)
    kw = dict(fx=100, fy=100, cx=32, cy=24, voxel_size=0.05)
    dr = tfp.DenseReconstructor(ReconstructionConfig(**kw), device="cpu")
    jdr = jfp.DenseReconstructor(JConfig(**kw))
    depth = rng.uniform(1.8, 2.2, (48, 64)).astype(np.float32)
    color = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    pts, cols = dr.depth_to_pointcloud(depth, color, subsample=2)
    jpts, jcols = jdr.depth_to_pointcloud(depth, color, subsample=2)
    assert len(pts) == 24 * 32 and cols.max() > 1.5
    np.testing.assert_allclose(pts, jpts, rtol=1e-5, atol=1e-5)
    merged, _ = dr.merge_pointclouds([(pts, cols)], voxel_size=0.05)
    jmerged, _ = jdr.merge_pointclouds([(jpts, jcols)], voxel_size=0.05)
    assert 0 < len(merged) == len(jmerged) <= len(pts)
    ref = _f64_means(pts, cols / 255.0, 0.05)
    vj = jvox.voxel_downsample(JPointSet.from_numpy(pts, cols / 255.0), 0.05)
    budget = np.abs(np.asarray(vj.xyz)[np.asarray(vj.mask)] - ref[:, :3]).max()
    assert np.abs(merged - jmerged).max() <= budget + 1e-5
    flat = np.full((10, 10), 1.0, np.float32)
    far = np.array([[0, 0, 1e5]] * 6, np.float32)
    uv = np.array([[5, 5]] * 6, np.float32)
    assert dr.estimate_scale(far, uv, flat) == 1.0     # outside the clamp
    near = np.array([[0, 0, 2.0]] * 6, np.float32)
    assert dr.estimate_scale(near, uv, flat) == pytest.approx(
        jdr.estimate_scale(near, uv, flat))


# --------------------------------------------------------------------- CLI

def _load_cli():
    spec = importlib.util.spec_from_file_location(
        "depth_to_reconstruction_torch",
        str(ROOT / "depth_to_reconstruction_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """depth_to_reconstruction.py's parser, caught at parse_args."""
    import runpy

    caught = {}

    def fake_parse(self, args=None, namespace=None):
        caught["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", fake_parse)
    with pytest.raises(SystemExit):
        runpy.run_path(str(ROOT / "depth_to_reconstruction.py"),
                       run_name="__main__")
    monkeypatch.undo()
    return caught["parser"]


def test_cli_parser_equals_the_reference(monkeypatch):
    """The same flags, types, defaults, requirements and help; the help of
    --device-features speaks of the port (no accelerator claim)."""
    ref = _reference_parser(monkeypatch)
    ours = _load_cli().build_parser()

    def actions(p):
        return {a.dest: (tuple(a.option_strings), a.type, a.default,
                         a.required, a.nargs, a.const,
                         None if a.dest == "device_features" else a.help)
                for a in p._actions}

    assert actions(ours) == actions(ref)
    assert ours.description == ref.description
    argv = ["--rgb-folder", "rgb/", "--depth-folder", "depth/", "--output",
            "out.ply", "--fx", "1719", "--fy", "1719", "--cx", "540", "--cy",
            "960", "--voxel-size", "0.005", "--subsample", "2", "--no-vis",
            "--device-features"]
    assert vars(ours.parse_args(argv)) == vars(ref.parse_args(argv))
    for bad in ([], ["--rgb-folder", "x"]):
        with pytest.raises(SystemExit):
            ours.parse_args(bad)


def test_cli_main_writes_a_ply_on_the_cpu(tiny, tmp_path, capsys):
    rgb_dir, dep_dir, cfg = tiny
    out = tmp_path / "out" / "reco.ply"
    cli = _load_cli()
    rc = cli.main(["--rgb-folder", rgb_dir, "--depth-folder", dep_dir,
                   "--output", str(out), "--fx", "110", "--fy", "110",
                   "--cx", "64", "--cy", "48", "--voxel-size", "0.05",
                   "--no-vis"], device="cpu")
    assert rc == 0 and out.is_file()
    pts, _ = read_ply(str(out))
    assert len(pts) > 500 and np.isfinite(pts).all()
    assert f"Saved to {out}" in capsys.readouterr().out
    rc = cli.main(["--rgb-folder", str(tmp_path), "--depth-folder", dep_dir,
                   "--no-vis"], device="cpu")
    assert rc == 0 and "Failed to load sufficient data" in \
        capsys.readouterr().out


def test_device_none_needs_cuda(tiny, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rgb_dir, dep_dir, _ = tiny
    rc = _load_cli().main(["--rgb-folder", rgb_dir, "--depth-folder",
                           dep_dir, "--no-vis"])
    assert rc == 1 and "CUDA" in capsys.readouterr().err
    for make in (lambda: tfp.DepthToReconstructionPipeline(),
                 lambda: tfp.SparseReconstructor(),
                 lambda: tfp.DenseReconstructor(),
                 lambda: ppc.DensePointCloudGenerator(np.eye(3))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
