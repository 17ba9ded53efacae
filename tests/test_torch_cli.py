"""``depth_processor_torch.py`` against ``depth_processor.py``: the same
argparse surface (groups, flags, defaults, choices; every argv of
``tests/test_cli_surface.py::TestDepthProcessorSurface`` parses to the same
namespace), a run of ``main()`` with ``--device cpu`` on a three-frame
folder, and the device choices the port refuses.
"""

import argparse
import importlib.util
import logging
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

# the argv of each test of TestDepthProcessorSurface, and the defaults
SURFACE_ARGVS = {
    "defaults": [],
    "baseline_config_images_mode": [
        "--source", "folder", "--input",
        "input_folder/exp_tunnel_set1_images_1_fps", "--mode", "images",
        "--version", "v2", "--encoder", "vits"],
    "baseline_config_v3_metric_video": [
        "--version", "v3", "--encoder", "large", "--metric", "--dataset",
        "vkitti", "--max-depth", "80", "--source", "video", "--video-path",
        "v.mp4", "--fps-mode", "custom", "--fps-percent", "50", "--mode",
        "both"],
    "readme_ros2_invocation": [
        "--source", "video", "--video-path", "video.mp4", "--fps-mode",
        "custom", "--fps-percent", "50", "--ros2", "--ros2-freq", "10",
        "--mode", "both"],
    "all_reference_flags_accepted": [
        "--version", "v2", "--encoder", "vitl", "--checkpoint", "x.pth",
        "--metric", "--max-depth", "20", "--dataset", "hypersim",
        "--input-size", "518", "--device", "auto",
        "--source", "camera", "--input", "./images", "--device-id", "1",
        "--width", "1280", "--height", "720", "--fps-mode", "1fps",
        "--fps-percent", "100", "--intrinsics", "intr.json",
        "--output", "./out", "--mode", "pointcloud",
        "--pointcloud-downsample", "2", "--min-depth", "0.1",
        "--colormap", "turbo", "--no-raw-depth",
        "--ros2", "--ros2-freq", "10",
        "--depth-topic", "/d", "--pc-topic", "/p", "--frame-id", "cam",
        "--preview", "--verbose"],
    "extensions": ["--batch", "4", "--int8", "--device", "cpu", "-v"],
    "rejects_unknown_colormap": ["--colormap", "rainbow"],
    "rejects_unknown_device": ["--device", "rocm"],
}


def _load(script):
    spec = importlib.util.spec_from_file_location(
        f"cli_{script.replace('.', '_')}", str(ROOT / script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clis():
    return _load("depth_processor.py"), _load("depth_processor_torch.py")


def _parse(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    return mod.parse_args()


def _parser(mod, monkeypatch):
    """The ArgumentParser that ``mod.parse_args`` builds."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        return orig(self, [], namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    mod.parse_args()
    monkeypatch.undo()
    return seen["parser"]


@pytest.mark.parametrize("name", list(SURFACE_ARGVS))
def test_argv_parses_to_the_same_namespace(clis, monkeypatch, name):
    argv = SURFACE_ARGVS[name]
    if name.startswith("rejects"):
        for mod in clis:
            with pytest.raises(SystemExit) as e:
                _parse(mod, argv, monkeypatch)
            assert e.value.code == 2
        return
    want, got = (vars(_parse(mod, argv, monkeypatch)) for mod in clis)
    assert got == want


def test_parser_surface_equal(clis, monkeypatch):
    def surface(parser):
        return [(g.title, [(a.option_strings, a.dest, a.default, a.choices,
                            a.type, a.nargs, a.required, type(a).__name__)
                           for a in g._group_actions])
                for g in parser._action_groups]

    want, got = (surface(_parser(mod, monkeypatch)) for mod in clis)
    assert got == want
    assert [t for t, _ in got] == ["positional arguments", "options",
                                   "Model Settings", "Input Settings",
                                   "Output Settings", "ROS2 Settings"]


@pytest.fixture(scope="module")
def three_frames(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("three")
    rng = np.random.default_rng(3)
    for i in range(3):
        cv2.imwrite(str(d / f"f{i}.jpg"),
                    rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    return str(d)


SMALL = ["--encoder", "vits", "--input-size", "70"]


@pytest.mark.parametrize("extra", [["--batch", "2"], ["--batch", "1",
                                                       "--int8"]],
                         ids=["batch2", "batch1_int8"])
def test_main_on_the_cpu_writes_the_artifacts(clis, three_frames, tmp_path,
                                              monkeypatch, extra):
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", ["prog", "--device", "cpu", "--input",
                                      three_frames, "--output", str(out)]
                        + SMALL + extra)
    clis[1].main()
    files = sorted(str(p.relative_to(out)) for p in out.rglob("*.*"))
    stems = ("f0", "f1", "f2")
    assert files == sorted(
        [f"depth_images/{s}_depth.npy" for s in stems]
        + [f"depth_images/{s}_depth.png" for s in stems]
        + [f"visualizations/{s}_depth_vis.png" for s in stems]
        + [f"pointclouds/{s}.ply" for s in stems])
    depth = np.load(out / "depth_images" / "f0_depth.npy")
    assert depth.shape == (48, 64) and np.isfinite(depth).all()


def _exit(clis, monkeypatch, caplog, argv):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    with caplog.at_level(logging.ERROR), pytest.raises(SystemExit) as e:
        clis[1].main()
    return e.value.code, caplog.text


@pytest.mark.parametrize("device", ["auto", "cuda"])
def test_without_cuda_the_gpu_choices_stop(clis, monkeypatch, caplog,
                                           three_frames, device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    code, log = _exit(clis, monkeypatch, caplog,
                      ["--device", device, "--input", three_frames] + SMALL)
    assert code not in (0, None) and "CUDA" in log


@pytest.mark.parametrize("device", ["mps", "tpu"])
def test_unsupported_devices_are_refused_by_name(clis, monkeypatch, caplog,
                                                 device):
    code, log = _exit(clis, monkeypatch, caplog, ["--device", device])
    assert code == 2 and f"--device {device}" in log


def test_ros2_without_rclpy_exits(clis, monkeypatch, caplog):
    from txr_torch.ros2.publisher import ros2_available

    if ros2_available():
        pytest.skip("rclpy is installed")
    code, log = _exit(clis, monkeypatch, caplog, ["--device", "cpu",
                                                  "--ros2"])
    assert code == 1 and "ROS2" in log


def test_missing_input_folder_exits(clis, monkeypatch, caplog, tmp_path):
    code, log = _exit(clis, monkeypatch, caplog,
                      ["--device", "cpu", "--input", str(tmp_path / "none")]
                      + SMALL)
    assert code == 1 and "No images found" in log
