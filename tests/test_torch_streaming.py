"""The streaming reconstruction on the port against ``txr``'s stepwise
``StreamingReconstructor`` on the CPU, and ``reconstruction_torch.py``.

Scenes: the three-frame shift of ``tests/test_streaming.py`` (metric
depth 2 m, ICP off and on) and the 17-frame ping-pong replay of
``tests/test_loop_closure.py`` with loop closure on, at that test's
settings and a working set of 4 keyframes (every loop candidate is then a
keyframe spilled to the host). Both sides get the same frames, the same
duck-typed depth model and the same RANSAC draws: the port's
``priorities=`` hook replays ``txr``'s key stream (``PRNGKey(0)``, one
split per odometry pair and per chunk of loop candidates). Both run at a
feature capacity of 512 (the frames give at most 263 SIFT features; the
default 4096 would make each of ``txr``'s pairs 8 times dearer on the CPU).

How the two are held together. ``pair_step`` and the loop verification
are held call by call: the port's result on the port's inputs against the
one ``txr`` recorded on the same inputs (equal inputs, R and t within
1e-4, the same inlier count and valid rows, scales within 1e-5 relative).
On a planar scene ``txr``'s Gauss-Newton pose polish (``refine_pose``)
keeps a step only when it lowers an f32 cost that a step there changes by
less than the cost's round-off, so the two packages may stop one step
apart (a flip of that accept test, not of a RANSAC threshold). Such a pair
is kept only with its cause shown: both poses' Sampson costs, in float64
over the rows both call valid, within 1e-4 relative of each other
(``FLIP_COST_RTOL``: the f32 cost's own round-off, a few ulps of each
product in a residual that cancels to ~1e-4 of its terms). The stream
then goes on with ``txr``'s recorded result, so that everything after the
pair (scale, ICP, chaining, keyframes, the pose graph, the map) is held to
``txr``'s: poses per frame within 1e-4, the scale within 1e-6 relative,
the same loops and loop keyframes, the same voxels, offsets and colours
within one quantum (``test_torch_fusion.assert_maps_agree``).
"""

import argparse
import importlib.util
import logging
import pathlib

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_loop_closure import FakeDepthModel, _pingpong_frames  # noqa: E402
from test_torch_fusion import assert_maps_agree  # noqa: E402
from test_torch_io import private_txr_native  # noqa: E402
from txr.core.config import StreamingConfig as JConfig  # noqa: E402
from txr.core.intrinsics import CameraIntrinsics as JIntr  # noqa: E402
from txr.fusion.offset_map import offset_map_size as j_size  # noqa: E402
from txr.io.ply import read_ply as j_read_ply  # noqa: E402
from txr.pipelines import streaming as jst  # noqa: E402
from txr_torch.core.config import StreamingConfig  # noqa: E402
from txr_torch.core.intrinsics import CameraIntrinsics  # noqa: E402
from txr_torch.core.types import PointSet  # noqa: E402
from txr_torch.fusion.offset_map import offset_map_size  # noqa: E402
from txr_torch.geometry.pose_graph import so3_exp  # noqa: E402
from txr_torch.io.ply import read_ply  # noqa: E402
from txr_torch.ops.matching import match_l2_ratio  # noqa: E402
from txr_torch.pipelines import streaming as tst  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
CAP = 512                     # feature capacity of both reconstructors
POSE_ATOL = 1e-4
SCALE_RTOL = 1e-6
FLIP_COST_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def txr_native_of_this_worker(tmp_path_factory):
    """``txr``'s native library (its ``save``), built for this module alone
    (see ``test_torch_io.py:private_txr_native``)."""
    with private_txr_native(tmp_path_factory.mktemp("txr_native")):
        yield


class TxrDraws:
    """``priorities=`` for the port: the uniforms ``txr`` draws from its
    key stream, in its order (``streaming.py:_next_key``; ``pair_step``
    splits a key into the essential and the homography key; a loop chunk
    splits its key into one per candidate)."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, count, hypotheses, rows):
        self.key, sub = jax.random.split(self.key)
        keys = [sub] if count is None else list(jax.random.split(sub, count))
        out = np.asarray([[np.asarray(jax.random.uniform(k, (hypotheses,
                                                             rows)))
                           for k in jax.random.split(kk)] for kk in keys])
        return torch.from_numpy(out[0] if count is None else out)


def three_frames():
    """tests/test_streaming.py::test_stream_fuses_frames' frames (its rng
    fixture's seed)."""
    rng = np.random.default_rng(0)
    W, H = 160, 120
    base = np.full((H, W, 3), 90, np.uint8)
    for _ in range(40):
        c = rng.integers(0, 255, 3).tolist()
        p = (int(rng.integers(5, W - 5)), int(rng.integers(5, H - 5)))
        cv2.rectangle(base, p, (p[0] + 6, p[1] + 5), c, -1)
    return [cv2.warpAffine(base, np.float32([[1, 0, dx], [0, 1, 0]]),
                           (W, H)) for dx in (0, 5, 10)]


class ConstantDepth:
    def infer(self, img, intr=None):
        return np.full(img.shape[:2], 2.0, np.float32)


def _intr(frames, f):
    h, w = frames[0].shape[:2]
    return dict(fx=f, fy=f, cx=w / 2.0, cy=h / 2.0, width=w, height=h)


SCENES = {
    "three_icp_off": dict(
        frames=three_frames, f=130.0, model=ConstantDepth, use_icp=False,
        metric=True, cfg=dict(voxel_size=0.05, max_map_points=1 << 15,
                              subsample_factor=2, max_depth=10.0)),
    "three_icp_on": dict(
        frames=three_frames, f=130.0, model=ConstantDepth, use_icp=True,
        metric=True, cfg=dict(voxel_size=0.05, max_map_points=1 << 15,
                              subsample_factor=2, max_depth=10.0)),
    "pingpong_closure": dict(
        frames=lambda: _pingpong_frames(np.random.default_rng(0)), f=160.0,
        model=FakeDepthModel, use_icp=False, metric=False,
        cfg=dict(voxel_size=0.05, max_map_points=1 << 17,
                 subsample_factor=4, keyframe_every=2, loop_closure=True,
                 loop_min_separation=4, loop_stride=1, loop_inliers=25,
                 kf_cloud_points=4096, kf_working_set=4)),
}


def run_txr(scene: dict, frames: list):
    """txr's stepwise stream, recording each pair_step's inputs and
    outputs, each loop-verification chunk's outputs and each closed loop's
    old keyframe."""
    rec = jst.StreamingReconstructor(
        JIntr(**_intr(frames, scene["f"])), depth_model=scene["model"](),
        config=JConfig(**scene["cfg"]), use_icp=scene["use_icp"],
        metric_depth=scene["metric"], feature_capacity=CAP, verbose=False)
    log = {"pairs": [], "verify": [], "closed": []}
    orig_pair = jst.pair_step

    def pair(uv1, uv2, mask, *a, **k):
        out = orig_pair(uv1, uv2, mask, *a, **k)
        log["pairs"].append(([np.asarray(x) for x in (uv1, uv2, mask)],
                             [np.asarray(x) for x in out]))
        return out

    pair.__wrapped__ = orig_pair.__wrapped__
    orig_verify, orig_close = rec._loop_verify, rec._close_loop

    def verify():
        fn = orig_verify()

        def run(*a):
            out = jax.device_get(fn(*a))
            log["verify"].append([np.asarray(x) for x in out])
            return out
        return run

    def close(ki, R, t):
        log["closed"].append(ki)
        return orig_close(ki, R, t)

    rec._loop_verify, rec._close_loop = verify, close
    jst.pair_step = pair
    try:
        for i, f in enumerate(frames):
            rec.process_frame(f, float(i), str(i))
    finally:
        jst.pair_step = orig_pair
    return rec, log


def sampson_errors(R, t, uv1, uv2, K) -> np.ndarray:
    """Squared Sampson error of each row under the essential matrix
    [t]x R, in float64 normalised coordinates."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    t = t / np.linalg.norm(t)
    Ki = np.linalg.inv(np.asarray(K, np.float64))
    p1 = np.c_[uv1, np.ones(len(uv1))] @ Ki.T
    p2 = np.c_[uv2, np.ones(len(uv2))] @ Ki.T
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                  [-t[1], t[0], 0]]) @ R
    Ex1, Etx2 = p1 @ E.T, p2 @ E
    num = (p2 * Ex1).sum(-1)
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num ** 2 / den


def sampson_cost(R, t, uv1, uv2, K, rows) -> float:
    """Mean squared Sampson error over ``rows``."""
    return float(sampson_errors(R, t, uv1, uv2, K)[rows].mean())


def pair_difference(got, want, uv1, uv2, K) -> dict:
    """None when the port's pair_step result agrees with txr's, else what
    differs and both poses' costs."""
    Rg, tg, _, vg, ng = (a.numpy() for a in got)
    Rw, tw, _, vw, nw = want
    dR, dt = float(np.abs(Rg - Rw).max()), float(np.abs(tg - tw).max())
    if (int(ng) == int(nw) and (vg == vw).all() and dR <= POSE_ATOL
            and dt <= POSE_ATOL):
        return None
    rows = vg & vw
    return {"R_diff": dR, "t_diff": dt, "n_inliers": [int(ng), int(nw)],
            "valid_rows_differing": int((vg != vw).sum()),
            "rows_compared": int(rows.sum()),
            "cost_port": sampson_cost(Rg, tg, uv1, uv2, K, rows),
            "cost_txr": sampson_cost(Rw, tw, uv1, uv2, K, rows)}


def run_port(scene: dict, frames: list, log: dict):
    """The port's stream with the RANSAC draws of txr; each pair_step and
    loop verification checked against txr's record, then continued with
    txr's result."""
    intr = CameraIntrinsics(**_intr(frames, scene["f"]))
    rec = tst.StreamingReconstructor(
        intr, depth_model=scene["model"](),
        config=StreamingConfig(**scene["cfg"]), use_icp=scene["use_icp"],
        metric_depth=scene["metric"], feature_capacity=CAP, verbose=False,
        device="cpu", priorities=TxrDraws())
    K = intr.to_matrix()
    report = {"pairs": 0, "pair_flips": [], "verify": 0, "verify_flips": []}
    pairs, chunks = iter(log["pairs"]), iter(log["verify"])
    chunk = {}
    orig_pair, orig_draw = tst.pair_step, rec._draw
    orig_verify = rec._loop_verify

    def pair(uv1, uv2, mask, *a, **k):
        got = orig_pair(uv1, uv2, mask, *a, **k)
        if k.get("num_hypotheses", 1024) != 1024:   # a loop verification
            return got
        (wu1, wu2, wm), want = next(pairs)
        for g, w in zip((uv1, uv2, mask), (wu1, wu2, wm)):
            np.testing.assert_array_equal(g.numpy(), w)
        report["pairs"] += 1
        diff = pair_difference(got, want, wu1, wu2, K)
        if diff is not None:
            report["pair_flips"].append(diff)
        return tuple(torch.from_numpy(np.array(w)) for w in want)

    def draw(count, hypotheses, rows):
        if count is not None:
            chunk["outs"], chunk["j"] = next(chunks), 0
        return orig_draw(count, hypotheses, rows)

    def verify(cand, feats, depth, prio):
        got = [a.numpy() for a in orig_verify(cand, feats, depth, prio)]
        want = [a[chunk["j"]] for a in chunk["outs"]]
        chunk["j"] += 1
        report["verify"] += 1
        ng, ig, vg, Rg, tg, sg = got
        nw, iw, vw, Rw, tw, sw = want
        assert int(ng) == int(nw)                   # ratio-test matches
        dR, dt = float(np.abs(Rg - Rw).max()), float(np.abs(tg - tw).max())
        if (int(ig) != int(iw) or int(vg) != int(vw) or dR > POSE_ATOL
                or dt > POSE_ATOL or abs(sg / sw - 1) > 1e-5):
            # the rows within the pair's 2 px RANSAC threshold under
            # txr's pose (the verification reports counts, not its rows)
            idx2, ok = match_l2_ratio(cand.desc, feats.desc, cand.mask,
                                      feats.mask, 0.75)
            u1, u2 = cand.uv.numpy(), feats.uv[idx2].numpy()
            thr = (2.0 / ((K[0, 0] + K[1, 1]) / 2.0)) ** 2
            rows = ok.numpy() & (sampson_errors(Rw, tw, u1, u2, K) < thr)
            report["verify_flips"].append({
                "R_diff": dR, "t_diff": dt, "n_inliers": [int(ig), int(iw)],
                "n_valid": [int(vg), int(vw)], "scale": [float(sg),
                                                         float(sw)],
                "rows_compared": int(rows.sum()),
                "cost_port": sampson_cost(Rg, tg, u1, u2, K, rows),
                "cost_txr": sampson_cost(Rw, tw, u1, u2, K, rows)})
        return tuple(torch.from_numpy(np.array(w)) for w in want)

    rec._draw, rec._loop_verify = draw, verify
    tst.pair_step = pair
    try:
        for i, f in enumerate(frames):
            rec.process_frame(f, float(i), str(i))
    finally:
        tst.pair_step = orig_pair
    assert next(pairs, None) is None and next(chunks, None) is None
    return rec, report


_runs: dict = {}


@pytest.fixture(scope="module")
def runs():
    def get(name):
        if name not in _runs:
            scene = SCENES[name]
            frames = scene["frames"]()
            jrec, log = run_txr(scene, frames)
            trec, report = run_port(scene, frames, log)
            _runs[name] = (jrec, log, trec, report)
        return _runs[name]
    return get


def assert_flips_have_their_cause(report: dict):
    for flip in report["pair_flips"] + report["verify_flips"]:
        assert flip["rows_compared"] >= 8, flip
        gap = abs(flip["cost_port"] - flip["cost_txr"])
        assert gap <= FLIP_COST_RTOL * flip["cost_txr"], flip


def assert_streams_agree(jrec, trec):
    assert trec.frames_processed == jrec.frames_processed
    assert trec.frames_skipped == jrec.frames_skipped
    assert len(trec.poses) == len(jrec.poses)
    for k, ((Rt, tt), (Rj, tj)) in enumerate(zip(trec.poses, jrec.poses)):
        assert Rt.dtype == np.float32 and tt.dtype == np.float32
        np.testing.assert_allclose(Rt, Rj, atol=POSE_ATOL, err_msg=str(k))
        np.testing.assert_allclose(tt, tj, atol=POSE_ATOL, err_msg=str(k))
    assert abs(trec.scale / jrec.scale - 1) <= SCALE_RTOL
    assert int(offset_map_size(trec.map)) == int(j_size(jrec.map))
    assert_maps_agree(trec.map, jrec.map)


@pytest.mark.parametrize("name", ["three_icp_off", "three_icp_on"])
def test_three_frames_match_txr(runs, name):
    jrec, log, trec, report = runs(name)
    assert trec.frames_processed == 3 and report["pairs"] == 2
    assert_flips_have_their_cause(report)
    assert_streams_agree(jrec, trec)
    assert int(offset_map_size(trec.map)) > 100
    if SCENES[name]["use_icp"]:
        assert trec.icp_accepted >= 1


def test_pingpong_closure_matches_txr(runs):
    jrec, log, trec, report = runs("pingpong_closure")
    assert report["pairs"] == 16 and report["verify"] >= 1
    assert_flips_have_their_cause(report)
    assert_streams_agree(jrec, trec)
    assert trec.loops_closed == jrec.loops_closed >= 1
    assert [old for old, _ in trec.loop_edges] == log["closed"]
    assert len(trec.keyframes) == len(jrec.keyframes)
    for kt, kj in zip(trec.keyframes, jrec.keyframes):
        assert kt["pose_idx"] == kj["pose_idx"]
        np.testing.assert_array_equal(kt["sketch"], kj["sketch"])


def test_pingpong_spills_old_keyframes(runs):
    """Working set 4 < loop_min_separation 4 + 1: every candidate was
    spilled to host numpy, came back to verify, and closures still
    fired."""
    _, _, trec, _ = runs("pingpong_closure")
    ws = trec.cfg.kf_working_set
    assert len(trec.keyframes) > ws
    for kf in trec.keyframes[:-ws]:
        assert kf["spilled"]
        assert isinstance(kf["features"].desc, np.ndarray)
        assert isinstance(kf["cloud"].xyz, np.ndarray)
    for kf in trec.keyframes[-ws:]:
        assert not kf.get("spilled")
        assert isinstance(kf["features"].desc, torch.Tensor)
    assert trec.loops_closed >= 1
    assert all(old < len(trec.keyframes) - ws for old, _ in trec.loop_edges)
    assert trec.map.khi.shape[0] == 1 << 17


def test_save_and_grid_match_txr(runs, tmp_path):
    jrec, _, trec, _ = runs("pingpong_closure")
    n_t = trec.save(str(tmp_path / "port.ply"))
    n_j = jrec.save(str(tmp_path / "txr.ply"))
    assert n_t == n_j == int(offset_map_size(trec.map)) > 100
    xt, ct = read_ply(str(tmp_path / "port.ply"))
    xj, cj = j_read_ply(str(tmp_path / "txr.ply"))
    voxel = trec.cfg.voxel_size
    np.testing.assert_allclose(xt, xj, rtol=0, atol=voxel / 1024 * 1.01)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1.01 / 256)
    gt = trec.save_grid(str(tmp_path / "port_grid"))
    gj = jrec.save_grid(str(tmp_path / "txr_grid"))
    np.testing.assert_array_equal(gt, gj)
    assert (tmp_path / "port_grid.pgm").read_bytes() == \
        (tmp_path / "txr_grid.pgm").read_bytes()
    assert (tmp_path / "port_grid.yaml").read_text().replace("port", "x") \
        == (tmp_path / "txr_grid.yaml").read_text().replace("txr", "x")


def test_segment_moves_rigidly_with_keyframe(rng, monkeypatch):
    """tests/test_loop_closure.py's propagation check on the port: every
    frame keeps its pose relative to its keyframe through a closure."""
    intr = CameraIntrinsics(fx=100.0, fy=100.0, cx=50.0, cy=50.0,
                            width=100, height=100)
    rec = tst.StreamingReconstructor(
        intr, depth_model=FakeDepthModel(), device="cpu", use_icp=False,
        config=StreamingConfig(voxel_size=0.05, max_map_points=1 << 12,
                               loop_closure=True), verbose=False)
    old = [(so3_exp(rng.normal(size=3) * 0.4).astype(np.float32),
            rng.normal(size=3).astype(np.float32)) for _ in range(6)]
    rec.poses = [(R.copy(), t.copy()) for R, t in old]
    cloud = PointSet(torch.from_numpy(rng.normal(size=(8, 3)).astype(
        np.float32)), torch.zeros(8, 3), torch.ones(8, dtype=torch.bool))
    kf_idx = (0, 2, 4)
    rec.keyframes = [{"pose_idx": i, "features": None, "cloud": cloud}
                     for i in kf_idx]
    new = [(so3_exp(rng.normal(size=3) * 0.5), rng.normal(size=3))
           for _ in kf_idx]
    monkeypatch.setattr(tst, "optimize_pose_graph",
                        lambda nodes, edges, fixed=0: new)
    monkeypatch.setattr(rec, "_refine_loop_edge",
                        lambda ki, R, t: (R, t))
    rec._close_loop(0, np.eye(3), np.zeros(3))

    def T(pose):
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = pose[0], np.asarray(pose[1]).reshape(3)
        return M

    for a, ki in enumerate(kf_idx):
        np.testing.assert_allclose(rec.poses[ki][0], new[a][0], atol=1e-5)
        np.testing.assert_allclose(rec.poses[ki][1], new[a][1], atol=1e-5)
        hi = kf_idx[a + 1] if a + 1 < len(kf_idx) else len(rec.poses)
        for p in range(ki, hi):
            rel_old = T(old[p]) @ np.linalg.inv(T(old[ki]))
            rel_new = T(rec.poses[p]) @ np.linalg.inv(T(rec.poses[ki]))
            np.testing.assert_allclose(rel_new, rel_old, atol=1e-4)
    assert rec.loops_closed == 1 and rec.loop_edges == [(0, 2)]


# ------------------------------------------------------------------- CLI

def _load(script):
    spec = importlib.util.spec_from_file_location(
        f"cli_{script.replace('.', '_')}", str(ROOT / script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _surface(parser):
    return [(g.title, [(a.option_strings, a.dest, a.default, a.choices,
                        a.type, a.nargs, a.required, a.help,
                        type(a).__name__) for a in g._group_actions])
            for g in parser._action_groups]


def test_cli_parser_surface_equal_reconstruction_py(monkeypatch):
    """reconstruction.py builds its parser inside main(); catch it at
    parse_args, before anything runs."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed):
        _load("reconstruction.py").main()
    monkeypatch.undo()
    got = _load("reconstruction_torch.py").build_parser()
    assert _surface(got) == _surface(seen["parser"])
    assert got.description == seen["parser"].description
    args = got.parse_args(["--no-fused", "--mode", "camera", "--camera", "1"])
    assert args.no_fused and args.camera == 1


def test_cli_main_writes_ply_and_grid(tmp_path, monkeypatch, caplog):
    """main(argv, device="cpu") at the CLI's defaults (v2 vits, seeded
    random weights; the model at input size 70 and ICP on 512 points to
    keep the CPU run short) over three JPEG frames, then with --no-fused: the defaults take
    the batched fused step and --no-fused the stepwise loop; each PLY holds
    its map's voxels and each grid reads back."""
    from txr_torch.models import depth_anything

    frames = tmp_path / "frames"
    frames.mkdir()
    for i, f in enumerate(three_frames()):
        cv2.imwrite(str(frames / f"f{i}.jpg"), f)
    built = {}

    class SmallModel(depth_anything.DepthAnythingModel):
        def __init__(self, **kw):
            super().__init__(input_size=70, **kw)
            built["model"] = kw

    class Recorded(tst.StreamingReconstructor):
        def __init__(self, *a, **kw):
            # ICP on 512 sources and 2,048 map samples (4,096 and 16,384 by
            # default): the fused step runs ICP's dense masked search on
            # every frame, which is slow on the CPU
            super().__init__(*a, icp_sample=512, **kw)
            built["rec"] = self

    monkeypatch.setattr(depth_anything, "DepthAnythingModel", SmallModel)
    monkeypatch.setattr(tst, "StreamingReconstructor", Recorded)
    recs = {}
    for name, extra, log in (
            ("fused", [], "Streaming fused: one step per 8 frames"),
            ("stepwise", ["--no-fused"], "Streaming stepwise")):
        out = tmp_path / name / "scene.ply"
        out.parent.mkdir()
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=tst.__name__):
            rc = _load("reconstruction_torch.py").main(
                ["--input", str(frames), "--output", str(out), *extra],
                device="cpu")
        assert rc == 0
        assert built["model"]["encoder"] == "vits"
        rec = recs[name] = built["rec"]
        assert rec.fused == (name == "fused")
        assert rec.route == ("fused_batched" if name == "fused"
                             else "stepwise")
        assert any(log in r.getMessage() for r in caplog.records)
        assert rec.frames_processed == 3
        xyz, _ = read_ply(str(out))
        assert len(xyz) == int(offset_map_size(rec.map))
        pgm = (out.parent / "scene_grid.pgm").read_bytes()
        assert pgm.startswith(b"P5\n# txr occupancy grid\n")
        yaml = (out.parent / "scene_grid.yaml").read_text()
        assert yaml.startswith("image: scene_grid.pgm\nresolution: 0.05\n")
        cols, rows = map(int, pgm.split(b"\n")[2].split())
        assert len(pgm) == len(pgm.rsplit(b"255\n", 1)[0]) + 4 + rows * cols
    # the routes' SIFT differ here (the stepwise route's "auto" backend is
    # OpenCV's on the CPU; the fused step always runs the device SIFT), so
    # their poses are held together in test_torch_stream_step.py instead
    assert recs["fused"].drains == 1 and recs["stepwise"].drains == 0
