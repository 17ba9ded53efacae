"""The depth pipeline through ``txr`` and through the port, on one folder of
twelve seeded 48x64 JPEG frames: ``DepthProcessor`` in every mode, at batch
1 and 8 (12 = 8 + 4), relative and metric heads, without raw depth, and a
V3 model with its focal scale.

The model is ``tests/test_depth_pipeline.py``'s tiny one (hidden 32, 2
layers, input 70), built and initialised in ``txr`` and carried into the
port with ``from_txr_params``, in f32 on ``device="cpu"``. The two runs
must write the same files:

- npy depth within the model's f32 tolerance (1e-4, as
  ``tests/test_torch_model.py``);
- 16-bit PNG depth within 1 mm (the uint16 cast truncates, so depths
  1e-4 apart may straddle a millimetre);
- PLY: the same points, positions within the depth tolerance and colours
  equal, except a point whose depth lies within the tolerance of
  ``min_depth`` / ``max_depth``, which one side may keep and the other
  drop. Points are matched by the pixel they came from, recovered from
  x / z and y / z.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import txr.io.sources as tsrc
from txr.models.depth_anything import DepthAnythingFlax
from txr.models.depth_anything import DepthAnythingModel as TModel
from txr.models.dpt import DPTConfig as TDPTConfig
from txr.models.vit import ViTConfig as TViTConfig
from txr.pipelines import depth_pipeline as tpipe

import txr_torch.io.sources as psrc
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.io.ply import read_ply
from txr_torch.models.convert import from_txr_params
from txr_torch.models.depth_anything import DepthAnything, DepthAnythingModel
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.pipelines import depth_pipeline as ppipe

torch.set_num_threads(1)

H, W, FRAMES = 48, 64, 12
VIT = dict(hidden_size=32, num_layers=2, num_heads=2, pos_embed_size=5,
           out_layers=(0, 0, 1, 1), use_flash=False)
DPT = dict(features=16, out_channels=(8, 8, 16, 16), head_hidden=8)
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(version, metric, max_depth):
    """The tiny model in ``txr`` (f32 parameters) and the same weights in
    the port."""
    tm = TModel.__new__(TModel)
    tm.version, tm.encoder, tm.metric, tm.dataset = (version, "vits", metric,
                                                     "hypersim")
    tm.input_size, tm.focal_length_ref, tm.max_depth = 70, 300.0, max_depth
    tm.model = DepthAnythingFlax(
        vit=TViTConfig(**VIT),
        dpt=TDPTConfig(metric=metric, max_depth=max_depth, **DPT))
    params = jax.tree_util.tree_map(np.asarray, tm.model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 70, 70, 3)))["params"])
    if not metric:
        # lift the final ReLU's input so that most pixels carry a depth
        params["head"]["head_conv3"]["bias"] = \
            params["head"]["head_conv3"]["bias"] + 1.0
    tm.params = jax.tree_util.tree_map(jnp.asarray, params)
    tm._jitted = {}

    pm = DepthAnythingModel.__new__(DepthAnythingModel)
    pm.device = torch.device("cpu")
    pm.version, pm.encoder, pm.metric, pm.dataset = (version, "vits", metric,
                                                     "hypersim")
    pm.input_size, pm.focal_length_ref, pm.max_depth = 70, 300.0, max_depth
    pm.param_dtype = torch.float32
    pm.vit_cfg = ViTConfig(**VIT)
    pm.dpt_cfg = DPTConfig(metric=metric, max_depth=max_depth, **DPT)
    pm.model = DepthAnything(pm.vit_cfg, pm.dpt_cfg).eval()
    pm.model.load_state_dict(from_txr_params(params))
    return tm, pm


@pytest.fixture(scope="module")
def models():
    return {"relative": _pair("v2", False, 20.0),
            "metric": _pair("v2", True, 5.0),
            "v3": _pair("v3", False, 20.0)}


@pytest.fixture(scope="module")
def frame_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i in range(FRAMES):
        img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        cv2.imwrite(str(d / f"frame_{i:04d}.jpg"), img)
    return str(d)


@pytest.fixture(scope="module")
def intrinsics_file(tmp_path_factory):
    """Focal lengths that make V3's scale (fx + fy) / 2 / 300 = 1.83."""
    p = tmp_path_factory.mktemp("intr") / "intrinsics.json"
    p.write_text(json.dumps({"fx": 600.0, "fy": 500.0, "cx": 31.5,
                             "cy": 23.5, "width": W, "height": H}))
    return str(p)


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


def _ply_pixels(path, intr):
    xyz, rgb = read_ply(str(path))
    u = np.rint(xyz[:, 0] / xyz[:, 2] * intr.fx + intr.cx).astype(np.int64)
    v = np.rint(xyz[:, 1] / xyz[:, 2] * intr.fy + intr.cy).astype(np.int64)
    assert ((u >= 0) & (u < W) & (v >= 0) & (v < H)).all()
    return v * W + u, xyz, rgb


def assert_ply_close(got_path, want_path, intr, lo, hi):
    gp, gx, gc = _ply_pixels(got_path, intr)
    wp, wx, wc = _ply_pixels(want_path, intr)
    assert len(np.unique(gp)) == len(gp) and len(np.unique(wp)) == len(wp)
    only = np.concatenate([gx[~np.isin(gp, wp), 2], wx[~np.isin(wp, gp), 2]])
    near = np.minimum(np.abs(only - lo), np.abs(only - hi))
    assert (near <= TOL["atol"] + TOL["rtol"] * max(lo, hi)).all(), only
    common, gi, wi = np.intersect1d(gp, wp, return_indices=True)
    assert len(common) > 0
    np.testing.assert_allclose(gx[gi], wx[wi], **TOL)
    np.testing.assert_array_equal(gc[gi], wc[wi])


CASES = {
    "images-b1": dict(model="relative", mode="images", batch_size=1),
    "images-b8": dict(model="relative", mode="images", batch_size=8),
    "pointcloud-b1": dict(model="metric", mode="pointcloud", batch_size=1,
                          max_depth=5.0, pointcloud_downsample=2),
    "pointcloud-b8": dict(model="metric", mode="pointcloud", batch_size=8,
                          max_depth=5.0, pointcloud_downsample=2),
    "both-b1-metric": dict(model="metric", mode="both", batch_size=1,
                           max_depth=5.0),
    "both-b8-relative": dict(model="relative", mode="both", batch_size=8),
    "no-raw-depth": dict(model="relative", mode="images", batch_size=8,
                         save_raw_depth=False),
    "v3-focal-scale": dict(model="v3", mode="both", batch_size=8,
                           intrinsics=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_processor_writes_what_txr_writes(models, frame_folder,
                                          intrinsics_file, tmp_path, case):
    kw = dict(CASES[case])
    tm, pm = models[kw.pop("model")]
    intr_path = intrinsics_file if kw.pop("intrinsics", False) else None
    want_src = tsrc.FolderSource(frame_folder, intr_path)
    got_src = psrc.FolderSource(frame_folder, intr_path)
    assert tpipe.DepthProcessor(tm, want_src, str(tmp_path / "txr"),
                                **kw).process() == FRAMES
    assert ppipe.DepthProcessor(pm, got_src, str(tmp_path / "port"),
                                **kw).process() == FRAMES

    got, want = tmp_path / "port", tmp_path / "txr"
    assert _tree(got) == _tree(want)
    names = _tree(want)
    mode = kw["mode"]
    n_npy = sum(n.endswith(".npy") for n in names)
    n_ply = sum(n.endswith(".ply") for n in names)
    raw = kw.get("save_raw_depth", True) and mode != "pointcloud"
    assert n_npy == (FRAMES if raw else 0)
    assert n_ply == (FRAMES if mode != "images" else 0)
    lo, hi = 0.1, kw.get("max_depth", 100.0)
    intr = CameraIntrinsics(**dataclasses.asdict(got_src.intrinsics))
    for name in names:
        g, w = got / name, want / name
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(g), np.load(w), **TOL)
        elif name.endswith("_depth.png"):
            a = cv2.imread(str(g), cv2.IMREAD_ANYDEPTH).astype(np.int64)
            b = cv2.imread(str(w), cv2.IMREAD_ANYDEPTH).astype(np.int64)
            assert np.abs(a - b).max() <= 1
        elif name.endswith("_vis.png"):
            a, b = cv2.imread(str(g)), cv2.imread(str(w))
            # one colormap level may flip where depth / max_depth * 255
            # lies within the tolerance of an integer
            assert a.shape == b.shape
            assert (a != b).any(axis=-1).mean() <= 0.01
        elif name.endswith(".ply"):
            assert_ply_close(g, w, intr, lo, hi)


def test_batched_runs_two_device_batches(models, frame_folder, tmp_path):
    """12 frames at batch 8: two device batches (8 and 4, no padding)."""
    _, pm = models["relative"]
    proc = ppipe.DepthProcessor(pm, psrc.FolderSource(frame_folder),
                                str(tmp_path), mode="pointcloud",
                                batch_size=8)
    seen = []
    device_batch = proc._device_batch

    def record(images):
        depth, ps = device_batch(images)
        seen.append((images.shape[0], depth.device.type, ps.xyz.shape))
        return depth, ps

    proc._device_batch = record
    assert proc.process() == FRAMES
    assert seen == [(8, "cpu", (8, H * W, 3)), (4, "cpu", (4, H * W, 3))]


def test_without_cv2_images_mode_fails_where_txr_fails(models, frame_folder,
                                                       tmp_path,
                                                       monkeypatch):
    tm, pm = models["relative"]
    monkeypatch.setattr(tpipe, "cv2", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(AttributeError):
        tpipe.DepthProcessor(tm, tsrc.FolderSource(frame_folder),
                             str(tmp_path / "txr"), mode="images",
                             batch_size=8).process()
    with pytest.raises(ImportError, match="OpenCV"):
        ppipe.DepthProcessor(pm, psrc.FolderSource(frame_folder),
                             str(tmp_path / "port"), mode="images",
                             batch_size=8).process()
    # both wrote the first frame's raw depth, then stopped at the colormap
    assert _tree(tmp_path / "port") == _tree(tmp_path / "txr")
    assert "depth_images/frame_0000_depth.npy" in _tree(tmp_path / "port")
    assert not list((tmp_path / "port" / "visualizations").iterdir())


class _Stub:
    """A model wrapper with infer() only: the sequential loop runs."""

    version = "v2"

    def __init__(self, device=None):
        if device is not None:
            self.device = torch.device(device)

    def infer(self, image, intrinsics=None):
        g = image.astype(np.float32).mean(axis=-1) / 255.0
        return 0.05 + 4.0 * g


def test_stub_model_runs_the_sequential_loop_like_txr(frame_folder,
                                                      tmp_path):
    for pkg, src, out in ((tpipe, tsrc, "txr"), (ppipe, psrc, "port")):
        stub = _Stub("cpu") if pkg is ppipe else _Stub()
        proc = pkg.DepthProcessor(stub, src.FolderSource(frame_folder),
                                  str(tmp_path / out), mode="both",
                                  max_depth=3.0, batch_size=8)
        assert proc._resolve_batch() == 1
        assert proc.process() == FRAMES
    assert _tree(tmp_path / "port") == _tree(tmp_path / "txr")
    intr = psrc.FolderSource(frame_folder).intrinsics
    for name in _tree(tmp_path / "txr"):
        g, w = tmp_path / "port" / name, tmp_path / "txr" / name
        if g.is_file():
            if name.endswith(".ply"):
                assert_ply_close(g, w, intr, 0.1, 3.0)
            else:
                assert g.read_bytes() == w.read_bytes(), name


@pytest.mark.parametrize("setting", ["batch_size", "env", "camera",
                                     "prefetch", "folder"])
def test_batch_rules_equal_txr(models, frame_folder, tmp_path, monkeypatch,
                               setting):
    tm, pm = models["relative"]
    kw = {"batch_size": 3} if setting == "batch_size" else {}
    if setting == "env":
        monkeypatch.setenv("TXR_DEPTH_BATCH", "5")
    got = []
    for pkg, src, model in ((tpipe, tsrc, tm), (ppipe, psrc, pm)):
        if setting == "camera":
            source = src.CameraSource.__new__(src.CameraSource)
            source.intrinsics = CameraIntrinsics.default(W, H)
        elif setting == "prefetch":
            source = src.PrefetchSource(src.FolderSource(frame_folder))
        else:
            source = src.FolderSource(frame_folder)
        proc = pkg.DepthProcessor(model, source, str(tmp_path), mode="images",
                                  **kw)
        got.append(proc._resolve_batch())
        if setting == "prefetch":
            source.close()
    assert got[0] == got[1] == {"batch_size": 3, "env": 5, "camera": 1,
                                "prefetch": 8, "folder": 8}[setting]


@pytest.mark.parametrize("stride", [1, 3])
def test_point_cloud_generator_equal_txr(rng, stride):
    intr = CameraIntrinsics(50.0, 52.0, 31.0, 24.5, W, H)
    depth = rng.uniform(0.0, 6.0, (H, W)).astype(np.float32)
    depth[0, :3] = [np.nan, np.inf, 5.0]
    bgr = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    got = ppipe.PointCloudGenerator(intr, stride, device="cpu").generate(
        depth, bgr, max_depth=5.0, min_depth=0.1)
    want = tpipe.PointCloudGenerator(intr, stride).generate(
        depth, bgr, max_depth=5.0, min_depth=0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1] * 255, np.rint(got[1] * 255))


def test_generator_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ppipe.PointCloudGenerator(CameraIntrinsics.default(W, H))


def test_ros2_without_rclpy_raises_like_txr(models, frame_folder, tmp_path):
    from txr_torch.ros2.publisher import ros2_available

    if ros2_available():
        pytest.skip("rclpy is installed")
    for pkg, src, model in ((tpipe, tsrc, models["relative"][0]),
                            (ppipe, psrc, models["relative"][1])):
        with pytest.raises(RuntimeError, match="rclpy"):
            pkg.DepthProcessor(model, src.FolderSource(frame_folder),
                               str(tmp_path), enable_ros2=True)
