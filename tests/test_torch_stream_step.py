"""The fused streaming step on the port (``txr_torch/pipelines/
stream_step.py`` and ``StreamingReconstructor``'s fused runners) on the
CPU, where each step runs eagerly: the plain version of the CUDA graph the
card replays.

Scenes: ``tests/test_stream_step.py``'s five frames (a textured patch
shifted 3 px a frame), its skip frames and its out-and-back loop, at its
settings (metric depth, 0.02 voxels, feature capacity 1024, ICP sample
512). The model is that test's: ``txr``'s v2 vits at input size 70, seed 0,
carried into the port with ``from_txr_params`` and run in f32, so that the
model is not the difference.

Held here, port against port on the same draws (the reconstructor's
generator, seeded 0 on both routes):
- the per-frame fused step against the stepwise path, ICP off, on, and at
  a radius at which ICP is accepted: the same fused and skipped counts and
  ICP decisions, poses within ``POSE_ATOL`` (measured: equal to the bit),
  maps bit-equal (measured), or, where ICP moved a frame, within one
  quantum of the map built from the same poses through the stepwise path's
  second back-projection (the fused step moves the points instead);
- a skip without ICP, fused then stepwise then fused (the resync), and the
  fused loop closure, each against the stepwise path;
- the map the fused steps carry, per frame and batched, keeps its rows in
  key order (the next insert sorts only its batch and merges it in);
- the step reads nothing back to the host (no ``.item()``, ``nonzero`` or
  boolean-mask gather dispatched inside it, the insert's CPU reduce aside:
  on the card that is the fused-reduce kernel);
- ``appearance_sketch_device`` against ``txr``'s ``appearance_sketch_jax``
  and the host sketch (1e-5); ICP's masked route against its compacted one
  (``test_torch_stream_ops.py``'s cases, bit-equal, measured).
``tests/test_torch_stream_step_txr.py`` holds the fused runs against
``txr``'s.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_streaming import make_surface, rotz  # noqa: E402
from txr.geometry import appearance as japp  # noqa: E402
from txr.models.depth_anything import \
    DepthAnythingModel as TxrModel  # noqa: E402
from txr_torch.core.config import StreamingConfig  # noqa: E402
from txr_torch.core.intrinsics import CameraIntrinsics  # noqa: E402
from txr_torch.fusion import offset_map as pom  # noqa: E402
from txr_torch.geometry import appearance as tapp  # noqa: E402
from txr_torch.geometry import icp as ticp  # noqa: E402
from txr_torch.models.convert import from_txr_params  # noqa: E402
from txr_torch.models.depth_anything import DepthAnythingModel  # noqa: E402
from txr_torch.ops.merge import row_keys  # noqa: E402
from txr_torch.pipelines import stream_step as tss  # noqa: E402
from txr_torch.pipelines import streaming as tst  # noqa: E402

torch.set_num_threads(1)

W, H = 160, 128
POSE_ATOL = 1e-4
SKETCH_ATOL = 1e-5
MOVED_ATOL = 1e-5   # a moved point against its second back-projection
# the radius at which ICP is accepted on these frames (the default 0.1
# keeps no frame)
ICP_WIDE = 0.5


class ListSource:
    def __init__(self, frames):
        self.frames = frames

    def __iter__(self):
        for i, f in enumerate(self.frames):
            yield f, float(i), f"f{i}"


def shifted_frames(seed=0, shifts=(0, 3, 6, 9, 12)):
    """tests/test_stream_step.py's frames fixture (and, with seed 1 and
    one shift, the base frame of its skip test)."""
    rng = np.random.default_rng(seed)
    base = np.full((H, W, 3), 90, np.uint8)
    for _ in range(60):
        c = rng.integers(0, 255, 3).tolist()
        p = (int(rng.integers(5, W - 12)), int(rng.integers(5, H - 12)))
        cv2.rectangle(base, p, (p[0] + 7, p[1] + 6), c, -1)
    return [cv2.warpAffine(base, np.float32([[1, 0, dx], [0, 1, 0]]), (W, H))
            for dx in shifts]


def tiny_models():
    """txr's tiny model of tests/test_stream_step.py and the port's with
    the same weights in f32."""
    jm = TxrModel(version="v2", encoder="vits", input_size=70, seed=0)
    pm = DepthAnythingModel(version="v2", encoder="vits", input_size=70,
                            param_dtype=torch.float32, device="cpu")
    pm.model.load_state_dict(from_txr_params(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    return jm, pm


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def frames():
    return shifted_frames()


def intrinsics():
    return CameraIntrinsics(130.0, 130.0, W / 2, H / 2, W, H)


def config(**kw):
    return StreamingConfig(**dict(dict(
        voxel_size=0.02, max_map_points=1 << 14, subsample_factor=2,
        max_depth=1e6, min_depth=1e-6, loop_closure=False), **kw))


def port_rec(model, fused, use_icp=True, priorities=None, **cfg):
    rec = tst.StreamingReconstructor(
        intrinsics(), depth_model=model, config=config(**cfg),
        use_icp=use_icp, metric_depth=True, verbose=False, fused=fused,
        feature_capacity=1024, icp_sample=512, device="cpu",
        priorities=priorities)
    rec.detector.backend = "device"   # the stepwise oracle on the same SIFT
    return rec


def port_run(model, frames, fused, **kw):
    rec = port_rec(model, fused, **kw)
    rec.run(ListSource(frames))
    return rec


def map_arrays(vm):
    return [np.asarray(a) for a in vm[:pom.NCOLS]]


def assert_same_stream(got, want):
    assert got.frames_processed == want.frames_processed
    assert got.frames_skipped == want.frames_skipped
    assert got.icp_frames == want.icp_frames
    assert got.loop_edges == want.loop_edges
    assert len(got.poses) == len(want.poses)
    for k, ((Rg, tg), (Rw, tw)) in enumerate(zip(got.poses, want.poses)):
        assert Rg.dtype == np.float32 and tg.dtype == np.float32
        np.testing.assert_allclose(Rg, Rw, atol=POSE_ATOL, err_msg=str(k))
        np.testing.assert_allclose(tg, tw, atol=POSE_ATOL, err_msg=str(k))
    assert got.scale == want.scale


def assert_maps_within_quantum(got, want):
    """The same voxels and weights; offsets and colours within one
    quantum."""
    g, w = map_arrays(got), map_arrays(want)
    np.testing.assert_array_equal(g[0], w[0])
    np.testing.assert_array_equal(g[1] >> 10, w[1] >> 10)
    np.testing.assert_array_equal(g[2] & 0x7FF, w[2] & 0x7FF)
    gu = [a.astype(np.int64) & 0xFFFFFFFF for a in g]
    wu = [a.astype(np.int64) & 0xFFFFFFFF for a in w]
    for col, shifts, width in ((1, (0,), 0x3FF), (2, (21, 11), 0x3FF),
                               (3, (16, 8, 0), 0xFF)):
        for s in shifts:
            d = ((gu[col] >> s) & width) - ((wu[col] >> s) & width)
            assert np.abs(d).max(initial=0) <= 1


class Inserts:
    """Records the points of every map insert of one module's calls."""

    def __init__(self, module, monkeypatch):
        self.points = []
        fn = module.offset_map_insert

        def insert(vm, ps):
            self.points.append((ps.xyz.clone(), ps.mask.clone()))
            return fn(vm, ps)

        monkeypatch.setattr(module, "offset_map_insert", insert)


def assert_differences_at_voxel_faces(fused, step, voxel, fused_map,
                                      step_map):
    """Where ICP moved a frame, the fused step moved its points and the
    stepwise path back-projected them again: the same rows within
    ``MOVED_ATOL``, and each point that lands in another voxel lies within
    that distance of a voxel face (round-off at a face, the cause of each
    voxel that differs). The maps differ by at most two voxels for each
    such point."""
    crossing = 0
    assert len(fused.points) == len(step.points)
    for (xf, mf), (xs, ms) in zip(fused.points, step.points):
        assert torch.equal(mf, ms)
        d = (xf - xs)[mf].abs().max() if mf.any() else torch.zeros(())
        assert float(d) <= MOVED_ATOL
        kf = torch.floor(xf[mf] / voxel)
        ks = torch.floor(xs[mf] / voxel)
        moved = (kf != ks).any(dim=1)
        g = xs[mf][moved] / voxel
        face = torch.minimum(g - torch.floor(g), torch.ceil(g) - g) * voxel
        assert bool((face.min(dim=1).values <= MOVED_ATOL).all())
        crossing += int(moved.sum())
    gk, sk = set(map_arrays(fused_map)[0]), set(map_arrays(step_map)[0])
    assert len(gk ^ sk) <= 2 * crossing


# ----------------------------------------------------- fused == stepwise

@pytest.mark.parametrize("icp", ["off", "on", "wide"])
def test_fused_step_matches_stepwise(models, frames, icp, monkeypatch):
    kw = dict(use_icp=icp != "off")
    if icp == "wide":
        kw["icp_max_correspondence"] = ICP_WIDE
    ins_f, ins_s = Inserts(tss, monkeypatch), Inserts(tst, monkeypatch)
    fused = port_run(models[1], frames, True, stream_batch=1, **kw)
    step = port_run(models[1], frames, False, **kw)
    assert fused.route == "fused_per_frame" and step.route == "stepwise"
    assert fused.frames_processed == len(frames)
    assert_same_stream(fused, step)
    assert int(pom.offset_map_size(fused.map)) > 100
    if icp != "wide":
        assert fused.icp_frames == []
        for a, b in zip(map_arrays(fused.map), map_arrays(step.map)):
            np.testing.assert_array_equal(a, b)
    else:
        assert len(fused.icp_frames) >= 1
        assert_differences_at_voxel_faces(ins_f, ins_s, fused.cfg.voxel_size,
                                          fused.map, step.map)


def test_fused_skip_without_icp(models):
    """tests/test_stream_step.py::test_fused_skip_without_icp's frames: a
    featureless frame is skipped, not fused, with ICP off."""
    base = shifted_frames(seed=1, shifts=(0,))[0]
    flat = np.full((H, W, 3), 120, np.uint8)
    seq = [base, flat, base]
    fused = port_run(models[1], seq, True, use_icp=False, stream_batch=1)
    step = port_run(models[1], seq, False, use_icp=False)
    assert fused.frames_skipped >= 1
    assert fused.frames_processed < 3
    assert_same_stream(fused, step)
    for a, b in zip(map_arrays(fused.map), map_arrays(step.map)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stream_batch", [1, 2])
def test_fused_state_map_is_key_ordered(models, frames, stream_batch):
    """The map the fused steps carry, per frame and batched, keeps its rows
    in key order, which the next insert relies on (it sorts only its batch
    and merges it into the map's rows: ``txr_torch/ops/merge.py``)."""
    rec = port_run(models[1], frames, True, use_icp=False,
                   stream_batch=stream_batch)
    assert rec.route == ("fused_per_frame" if stream_batch == 1
                         else "fused_batched")
    assert int(pom.offset_map_size(rec.map)) > 100
    key = row_keys(rec.map.khi, rec.map.klo_x)
    assert bool((key[1:] >= key[:-1]).all())


def test_fused_then_stepwise_then_fused(models, frames):
    """process_frame after a fused run, then a fused run again: the resync
    carries the map, pose, scale, count and features across, so the mix
    equals the stepwise stream (txr's process_frame after a fused run has
    no previous features and takes frame 2 at constant position)."""
    mixed = port_rec(models[1], True, stream_batch=1)
    mixed.run(ListSource(frames[:2]))
    size_a = int(pom.offset_map_size(mixed.map))
    assert mixed.process_frame(frames[2], 2.0, "f2")
    assert mixed._fused_state.vm is mixed.map       # resynced
    assert int(mixed._fused_state.n_fused) == 3
    mixed.run(ListSource(frames[3:]))
    assert mixed.frames_processed == len(mixed.poses) == len(frames)
    assert int(pom.offset_map_size(mixed.map)) >= size_a
    step = port_run(models[1], frames, False)
    assert_same_stream(mixed, step)
    for a, b in zip(map_arrays(mixed.map), map_arrays(step.map)):
        np.testing.assert_array_equal(a, b)


def test_fused_loop_closure_against_stepwise(models, frames):
    """tests/test_stream_step.py::test_fused_loop_closure_smoke's
    out-and-back frames and settings: keyframes on chunk-final frames, the
    device sketch, the closures and the resync, against the stepwise path
    on the same draws."""
    loop = frames + frames[-2::-1]
    kw = dict(loop_closure=True, keyframe_every=2, loop_min_separation=1,
              loop_stride=1, loop_inliers=15, stream_batch=1)
    fused = port_run(models[1], loop, True, **kw)
    step = port_run(models[1], loop, False, **kw)
    assert fused.frames_processed == len(loop)
    assert len(fused.keyframes) >= 3
    assert fused.loops_closed >= 1
    assert_same_stream(fused, step)
    for kf, ks in zip(fused.keyframes, step.keyframes):
        assert kf["pose_idx"] == ks["pose_idx"]
        np.testing.assert_allclose(kf["sketch"], ks["sketch"],
                                   atol=SKETCH_ATOL)
    assert_maps_within_quantum(fused.map, step.map)


# ------------------------------------------------------- no host reads

class HostReads(TorchDispatchMode):
    """Records the ops that read a tensor back to the host (a sync on the
    card): a scalar read, nonzero, a boolean-mask gather."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        bool_index = (name.startswith("aten.index") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 and isinstance(
                args[1], (list, tuple)) else [])))
        if (name in ("aten._local_scalar_dense", "aten.nonzero",
                     "aten.masked_select", "aten.unique_dim",
                     "aten._unique2") or bool_index):
            import traceback
            where = [f.name for f in traceback.extract_stack()]
            if "_reduce_unfused" not in where:   # the insert's CPU reduce
                self.seen.append((name, where[-6:]))
        return func(*args, **(kwargs or {}))


def test_steps_read_nothing_back(models, frames):
    """The per-frame step and each program of the batched step, ICP on,
    on a second frame (pair_step, scale and ICP all run)."""
    rec = port_rec(models[1], True, stream_batch=1)
    rec.run(ListSource(frames[:1]))
    st = rec._fused_state
    step = rec._fused_step_for(H, W)
    frame = torch.from_numpy(frames[1])
    with HostReads() as reads:
        step(st, frame, rec._pair_priorities())
    assert reads.seen == []
    batch = rec._fused_batch_step_for(H, W, 2)
    stack = torch.from_numpy(np.stack(frames[1:3]))
    with HostReads() as reads:
        batch(st, stack, 2, rec._pair_priorities, first=False)
    assert reads.seen == []


def test_priorities_are_the_stepwise_draws(models):
    """The fused runner's draw of one pair equals what pair_step draws from
    the generator (essential, then homography)."""
    a = port_rec(models[1], True)
    b = port_rec(models[1], True)
    got = a._pair_priorities()
    cap = a.detector.capacity
    want = [torch.rand((1024, cap), generator=b.generator)
            for _ in range(2)]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------- sketch and ICP's routes

@pytest.mark.parametrize("valid", [0.7, 0.0, 1.0])
def test_device_sketch_matches_txr_and_host(rng, valid):
    desc = (rng.random((512, 128)) * 255).astype(np.float32)
    mask = rng.random(512) < valid
    got = tapp.appearance_sketch_device(torch.from_numpy(desc),
                                        torch.from_numpy(mask)).numpy()
    want_jax = np.asarray(japp.appearance_sketch_jax(jnp.asarray(desc),
                                                     jnp.asarray(mask)))
    want_host = tapp.appearance_sketch(desc, mask)
    assert got.shape == (tapp.N_ANCHORS * 128,)
    np.testing.assert_allclose(got, want_jax, atol=SKETCH_ATOL)
    np.testing.assert_allclose(got, want_host, atol=SKETCH_ATOL)


def _clouds(rng, case):
    tgt = make_surface(rng, 800 if case == "identity" else 2000)
    src = tgt if case == "identity" else \
        (tgt - np.array([0.03, -0.02, 0.01], np.float32)) @ rotz(0.05)
    smask, tmask = np.ones(len(src), bool), np.ones(len(tgt), bool)
    if case == "masked_rows":
        smask[::7] = False
        tmask[::5] = False
        src, smask = src[:1500], smask[:1500]
    if case == "fewer_set_than_k":
        tmask[:] = False
        tmask[[3, 40, 77]] = True
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (src, smask, tgt, tmask)]


@pytest.mark.parametrize("case", ["small_transform", "identity",
                                  "masked_rows", "fewer_set_than_k"])
def test_icp_masked_route_equals_compacted(rng, case):
    src, smask, tgt, tmask = _clouds(rng, case)
    n_c = ticp.estimate_normals(tgt, tmask, 8)
    n_m = ticp.estimate_normals(tgt, tmask, 8, compact=False)
    assert torch.equal(n_c, n_m)
    args = (src, smask, tgt, n_c, tmask, torch.eye(3), torch.zeros(3), 10,
            0.2)
    for a, b in zip(ticp.icp_point_to_plane(*args),
                    ticp.icp_point_to_plane(*args, compact=False)):
        assert torch.equal(a, b)
