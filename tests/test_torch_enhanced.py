"""The enhanced CLI on the port against ``txr`` on the CPU:
``DepthEnhancedReconstruction`` end to end on
``tests/test_enhanced_pipeline.py``'s scene (depth, depth with bundle
adjustment, no depth, depth on later views only; the device feature
backend) and ``depth_enhanced_reconstruction_torch.py``. The hybrid
detector, the host matching, RANSAC-F over the match capacity and bundle
adjustment are held against ``txr`` in ``tests/test_torch_hybrid_ops.py``
(the two files split the gate's time).

The end-to-end runs feed the port the RANSAC priorities ``txr`` draws from
its key chain (``jax.random.PRNGKey(0)``; per pair a fundamental key, then
a pose key split into the essential and homography keys), so both run the
same hypotheses.

Tolerances: the pipeline's poses within 1e-4, the numbers of its narration
(scales, RMS) within 1e-4 relative, its cloud within a chamfer distance of
1e-3 of the scene's depth with the same number of points within 1 %.
"""

import argparse
import contextlib
import importlib.util
import io
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_torch_io import private_txr_native  # noqa: E402
from txr.pipelines import enhanced_pipeline as jenh  # noqa: E402
from txr.utils.chamfer import chamfer_distance  # noqa: E402
from txr_torch.geometry import bundle_adjustment as tba  # noqa: E402
from txr_torch.geometry import hybrid as thy  # noqa: E402
from txr_torch.pipelines import enhanced_pipeline as tenh  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
HYP = 1024
CAP = tenh.MATCH_CAPACITY
K_SCENE = np.array([[130.0, 0, 80], [0, 130.0, 60], [0, 0, 1]])


@pytest.fixture(scope="module", autouse=True)
def txr_native_of_this_worker(tmp_path_factory):
    """``txr``'s native library, built for this module alone: ``txr``'s
    in-place build (``txr/_native/__init__.py:44-58``) races other test
    workers (see ``test_torch_io.py:private_txr_native``)."""
    with private_txr_native(tmp_path_factory.mktemp("txr_native")):
        yield


class FakeDepthModel:
    """A plane at depth 2 (``tests/test_enhanced_pipeline.py``'s)."""

    def infer(self, img, intr=None):
        return np.full(img.shape[:2], 2.0, np.float32)

    def infer_batch(self, imgs, intr=None):
        return np.full(imgs.shape[:3], 2.0, np.float32)


def _scene_frames(seed: int = 3, shifts=(0, 7, 14)) -> list:
    """``tests/test_enhanced_pipeline.py:170-215``'s frames: 35 coloured
    rectangles on grey, shifted sideways, 160 x 120."""
    rng = np.random.default_rng(seed)
    base = np.full((120, 160, 3), 90, np.uint8)
    for _ in range(35):
        c = rng.integers(0, 255, 3).tolist()
        p = (int(rng.integers(10, 150)), int(rng.integers(10, 110)))
        cv2.rectangle(base, p, (p[0] + 8, p[1] + 6), c, -1)
    return [cv2.warpAffine(base, np.float32([[1, 0, dx], [0, 1, 0]]),
                           (160, 120)) for dx in shifts]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    folder = tmp_path_factory.mktemp("enh_scene")
    for i, img in enumerate(_scene_frames()):
        cv2.imwrite(str(folder / f"im_{i}.png"), img)
    return str(folder)


def txr_priorities(pairs: int) -> torch.Tensor:
    """The draws of ``txr``'s key chain for ``pairs`` pairs that all have
    at least 8 raw matches: per pair the fundamental key, then the pose key
    split into the essential and homography keys, HYP x CAP uniforms
    each."""
    key = jax.random.PRNGKey(0)
    out = []
    for _ in range(pairs):
        key, kf = jax.random.split(key)
        key, kp = jax.random.split(key)
        out.append([np.asarray(jax.random.uniform(k, (HYP, CAP)))
                    for k in (kf, *jax.random.split(kp))])
    return torch.from_numpy(np.asarray(out))


# --------------------------------------------- DepthEnhancedReconstruction

MODES = {
    "depth": dict(),
    "depth_ba": dict(use_ba=True, ba_iterations=5),
    "no_depth": dict(use_depth=False),
    "later_views_depth": dict(depths_none=(0, 1)),
}
NUMBER = re.compile(r"[-+]?\d+\.\d+")


def _run(side: str, scene_dir: str, out_dir: str, mode: dict):
    kw = dict(mode)
    depths_none = kw.pop("depths_none", ())
    mod = jenh if side == "txr" else tenh
    extra = {} if side == "txr" else dict(device="cpu")
    rec = mod.DepthEnhancedReconstruction(
        K_SCENE, use_hybrid_features=True, depth_model=FakeDepthModel(),
        subsample=4, voxel_size=0.05, feature_backend="cv2",
        **kw, **extra)
    assert rec.load_images(scene_dir) == 3
    if depths_none:
        rec.estimate_all_depths()
        for i in depths_none:
            rec.depths[i] = None
        rec.estimate_all_depths = lambda: None
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if side == "txr":
            res = rec.reconstruct(output_dir=out_dir)
        else:
            res = rec.reconstruct(output_dir=out_dir,
                                  priorities=txr_priorities(2))
    return res, buf.getvalue(), rec


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):
    out = {}

    def get(name):
        if name not in out:
            out[name] = {side: _run(side, scene_dir,
                                    str(tmp_path_factory.mktemp(side)),
                                    MODES[name])
                         for side in ("txr", "port")}
        return out[name]

    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipeline_matches_txr(runs, mode):
    r = runs(mode)
    (wp, wc, wposes), wtext, _ = r["txr"]
    (gp, gc, gposes), gtext, grec = r["port"]
    # every pair had at least 8 raw matches, so txr_priorities drew as
    # txr's key chain did
    raw = [int(m) for m in re.findall(r"RANSAC-F inliers \(pair \d\): "
                                      r"\d+/(\d+)", wtext)]
    assert len(raw) == 2 and min(raw) >= 8
    assert len(gposes) == len(wposes) == 3
    for (Rg, tg), (Rw, tw) in zip(gposes, wposes):
        np.testing.assert_allclose(Rg, np.asarray(Rw), atol=1e-4)
        np.testing.assert_allclose(tg, np.asarray(tw), atol=1e-4)
    depth = float(np.percentile(wp[:, 2], 85))
    assert chamfer_distance(gp, wp) < 1e-3 * depth
    assert abs(len(gp) / len(wp) - 1) < 0.01
    assert gc.shape == gp.shape and gc.max() > 1.5
    # the same narration, numbers to 1e-4 relative, but the paths written
    lw = [l for l in wtext.splitlines() if "Saved to" not in l]
    lg = [l for l in gtext.splitlines() if "Saved to" not in l]
    assert len(lg) == len(lw)
    for a, b in zip(lg, lw):
        na, nb = NUMBER.findall(a), NUMBER.findall(b)
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b)
        np.testing.assert_allclose([float(x) for x in na],
                                   [float(x) for x in nb], rtol=1e-4,
                                   atol=1e-6)
    if mode == "depth_ba":
        assert "Bundle adjustment" in gtext
        h = grec.ba_history
        assert h.shape == (6,) and h[-1] <= h[0]
    if mode == "no_depth":
        assert len(gp) > 10          # the sparse pair-0 points


def test_writes_the_ply_it_returns(runs):
    from txr_torch.io.ply import read_ply

    (gp, gc, _), text, _ = runs("depth")["port"]
    path = re.search(r"Saved to (\S+)", text).group(1)
    back, rgb = read_ply(path)
    np.testing.assert_allclose(back, gp, atol=1e-6)


def test_device_backend_run(scene_dir, tmp_path, monkeypatch):
    """The device feature backend end to end: no OpenCV feature call, and
    the cloud of the cv2 run's scene (both backends see the same planar
    scene; their features and so their matches differ)."""
    for name in ("SIFT_create", "ORB_create", "createCLAHE",
                 "createLineSegmentDetector", "Canny"):
        monkeypatch.setattr(
            cv2, name, lambda *a, _n=name, **k: (_ for _ in ()).throw(
                AssertionError(f"cv2.{_n} called on the device backend")),
            raising=False)
    rec = tenh.DepthEnhancedReconstruction(
        K_SCENE, depth_model=FakeDepthModel(), verbose=False, subsample=4,
        voxel_size=0.05, feature_backend="device", device="cpu")
    rec.load_images(scene_dir)
    points, colors, poses = rec.reconstruct(output_dir=str(tmp_path))
    assert rec.detector.backend == "device" and len(poses) == 3
    assert len(points) > 100 and np.isfinite(points).all()
    # pure sideways motion: every view's translation along x
    for R, t in poses[1:]:
        np.testing.assert_allclose(R, np.eye(3), atol=2e-2)
        assert abs(t[0]) > 0.9 * np.linalg.norm(t)


def test_too_few_images(tmp_path, capsys):
    rec = tenh.DepthEnhancedReconstruction(K_SCENE, device="cpu")
    assert rec.reconstruct(output_dir=str(tmp_path)) is None
    assert "Need at least 2 images" in capsys.readouterr().out


def test_load_images_needs_opencv(scene_dir, monkeypatch):
    """Without OpenCV, reading an image raises ImportError naming the read
    (txr fails on a None module); an empty folder needs no reader."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    rec = tenh.DepthEnhancedReconstruction(K_SCENE, feature_backend="device",
                                           device="cpu", verbose=False)
    with pytest.raises(ImportError, match="reading the image im_0.png"):
        rec.load_images(scene_dir)
    assert rec.load_images(str(pathlib.Path(scene_dir) / "none")) == 0


def test_device_none_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: tenh.DepthEnhancedReconstruction(K_SCENE),
                 lambda: thy.HybridFeatureDetector(),
                 lambda: tba.build_problem([(np.eye(3), np.zeros(3))],
                                           np.zeros((1, 3)), [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# --------------------------------------------------------------------- CLI

def _load_cli():
    spec = importlib.util.spec_from_file_location(
        "depth_enhanced_reconstruction_torch",
        str(ROOT / "depth_enhanced_reconstruction_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """depth_enhanced_reconstruction.py's parser, caught at parse_args."""
    import runpy

    caught = {}

    def fake_parse(self, args=None, namespace=None):
        caught["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", fake_parse)
    with pytest.raises(SystemExit):
        runpy.run_path(str(ROOT / "depth_enhanced_reconstruction.py"),
                       run_name="__main__")
    monkeypatch.undo()
    return caught["parser"]


def test_cli_parser_equals_the_reference(monkeypatch):
    """The same flags, types, defaults and help; the help of --int8 and
    --device-features speaks of the port (no accelerator claim)."""
    ref = _reference_parser(monkeypatch)
    ours = _load_cli().build_parser()
    ported = ("int8", "device_features")

    def actions(p):
        return {a.dest: (tuple(a.option_strings), a.type, a.default,
                         a.required, a.nargs, a.const,
                         None if a.dest in ported else a.help)
                for a in p._actions}

    assert actions(ours) == actions(ref)
    assert ours.description == ref.description
    for a in ours._actions:
        if a.dest in ported:
            assert "TPU" not in a.help and "MXU" not in a.help
    argv = ["--input", "imgs/", "--output", "out/", "--fx", "1719", "--fy",
            "1719", "--cx", "540", "--cy", "960", "--no-depth",
            "--no-hybrid", "--ba", "--int8", "--device-features"]
    assert vars(ours.parse_args(argv)) == vars(ref.parse_args(argv))
    assert vars(ours.parse_args([])) == vars(ref.parse_args([]))


def test_cli_main_writes_a_ply_on_the_cpu(scene_dir, tmp_path, capsys):
    out = tmp_path / "out"
    cli = _load_cli()
    rc = cli.main(["--input", scene_dir, "--output", str(out), "--fx",
                   "130", "--fy", "130", "--cx", "80", "--cy", "60",
                   "--no-depth"], device="cpu")
    text = capsys.readouterr().out
    assert rc == 0 and (out / "reconstruction.ply").is_file(), text
    assert "Depth-Enhanced 3D Reconstruction" in text
    rc = cli.main(["--input", str(tmp_path / "empty")], device="cpu")
    assert rc == 1 and "Need at least 2 images" in capsys.readouterr().out


def test_cli_needs_cuda_without_a_device(scene_dir, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = _load_cli().main(["--input", scene_dir])
    assert rc == 1 and "CUDA" in capsys.readouterr().err
