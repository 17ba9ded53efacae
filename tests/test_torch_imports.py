"""The port stands alone: it imports without JAX, flax or ``txr``, builds
nothing at import, and runs on the CPU only when asked to.

The import checks run in a subprocess, because the test process itself has
JAX loaded (``tests/conftest.py`` imports it).
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "txr_torch"

MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_package_has_the_slice_modules():
    want = {"txr_torch", "txr_torch._cuda", "txr_torch.core.types",
            "txr_torch.core.intrinsics", "txr_torch.ops.resize",
            "txr_torch.ops.attention", "txr_torch.ops.dpt_tail",
            "txr_torch.ops.scan", "txr_torch.ops.segment",
            "txr_torch.ops.backproject", "txr_torch.models.vit",
            "txr_torch.models.dpt", "txr_torch.models.depth_anything",
            "txr_torch.models.convert", "txr_torch.fusion.keys",
            "txr_torch.fusion.offset_map", "txr_torch.core.derived",
            "txr_torch.ops.quant", "txr_torch.ops.quant_fused",
            "txr_torch.ops.conv_stripe", "txr_torch.models.checkpoint",
            "txr_torch._native", "txr_torch.core.config", "txr_torch.io",
            "txr_torch.io.ply", "txr_torch.io.depth_io",
            "txr_torch.io.sources", "txr_torch.io.rtabmap_db",
            "txr_torch.io.opencv", "txr_torch.ros2",
            "txr_torch.ros2.publisher", "txr_torch.pipelines",
            "txr_torch.pipelines.depth_pipeline",
            "txr_torch.core.precision", "txr_torch.ops.eigsmall",
            "txr_torch.ops.matching", "txr_torch.ops.clahe",
            "txr_torch.ops.sift", "txr_torch.geometry",
            "txr_torch.geometry.features", "txr_torch.geometry.triangulate",
            "txr_torch.geometry.epipolar", "txr_torch.geometry.pose",
            "txr_torch.geometry.homography", "txr_torch.geometry.refine",
            "txr_torch.geometry.scale", "txr_torch.pipelines.fusion_pipeline",
            "txr_torch.ops.voxel", "txr_torch.ops.outlier",
            "txr_torch.ops.grid_knn", "txr_torch.fusion.pointcloud",
            "txr_torch.fusion.chunked_merge", "txr_torch.utils",
            "txr_torch.utils.visualize", "txr_torch.ops.canny",
            "txr_torch.ops.orb", "txr_torch.ops.lsd",
            "txr_torch.geometry.hybrid",
            "txr_torch.geometry.bundle_adjustment",
            "txr_torch.pipelines.enhanced_pipeline",
            "txr_torch.geometry.icp", "txr_torch.geometry.pose_graph",
            "txr_torch.geometry.appearance", "txr_torch.fusion.occupancy",
            "txr_torch.pipelines.streaming",
            "txr_torch.pipelines.stream_step", "txr_torch.train",
            "txr_torch.parallel", "txr_torch.parallel.mesh",
            "txr_torch.parallel.pipeline", "txr_torch.parallel.launch",
            "txr_torch.utils.chamfer", "txr_torch.utils.profiling",
            "txr_torch.ros2.nodes"}
    assert want <= set(MODULES)
    assert {p.name for p in (PKG / "csrc").glob("*.cu")} >= {
        "attention.cu", "dpt_tail.cu", "segscan.cu", "int8_linear.cu",
        "conv3x3.cu", "merge.cu"}
    assert (PKG / "_native" / "txr_native.cpp").is_file()


def test_import_leaves_jax_flax_txr_out():
    code = (
        "import importlib, sys\n"
        f"mods = {MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'txr'))\n"
        "assert not bad, bad\n"
        "print('imported', len(mods))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert f"imported {len(MODULES)}" in r.stdout


def test_import_builds_nothing_and_needs_no_cuda():
    code = (
        "import sys, pathlib\n"
        "import txr_torch._cuda as k\n"
        "import txr_torch._native as n\n"
        f"mods = {MODULES!r}\n"
        "import importlib\n"
        "[importlib.import_module(m) for m in mods]\n"
        "assert k._lib is None and not k.build_log\n"
        "assert n._lib is None and not n._tried\n"
        "assert 'triton' not in sys.modules\n"
        "for m in ('safetensors', 'transformers', 'cv2'):\n"
        "    assert m not in sys.modules, m\n"
        "print('clean')\n")
    before = set((ROOT / "build").rglob("*")) if (ROOT / "build").exists() \
        else set()
    r = _run(code)
    assert r.returncode == 0, r.stderr
    after = set((ROOT / "build").rglob("*")) if (ROOT / "build").exists() \
        else set()
    assert after == before


def test_depth_cli_imports_the_port_alone():
    """Importing the CLI (and parsing its flags) loads neither JAX nor
    ``txr`` and builds no native library."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('cli', "
        "'depth_processor_torch.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "sys.argv = ['cli', '--device', 'cpu']\n"
        "mod.parse_args()\n"
        "import txr_torch._native as n, txr_torch.pipelines.depth_pipeline\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'txr'))\n"
        "assert not bad, bad\n"
        "assert n._lib is None and not n._tried\n"
        "print('clean')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_fusion_cli_imports_the_port_alone():
    """Importing the fusion CLI and parsing its flags loads neither JAX,
    ``txr``, OpenCV nor Plotly, and builds nothing."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('cli', "
        "'depth_to_reconstruction_torch.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "mod.build_parser().parse_args(['--rgb-folder', 'a', "
        "'--depth-folder', 'b'])\n"
        "import txr_torch._cuda as k, txr_torch._native as n\n"
        "import txr_torch.pipelines.fusion_pipeline, txr_torch.utils\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'txr', 'cv2', 'plotly'))\n"
        "assert not bad, bad\n"
        "assert k._lib is None and n._lib is None and not n._tried\n"
        "print('clean')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_enhanced_cli_imports_the_port_alone():
    """Importing the enhanced CLI, parsing its flags and importing its
    pipeline loads neither JAX, ``txr``, OpenCV nor Plotly, and builds
    nothing."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('cli', "
        "'depth_enhanced_reconstruction_torch.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "mod.build_parser().parse_args(['--ba', '--device-features'])\n"
        "import txr_torch._cuda as k, txr_torch._native as n\n"
        "import txr_torch.pipelines.enhanced_pipeline, txr_torch.utils\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'txr', 'cv2', 'plotly'))\n"
        "assert not bad, bad\n"
        "assert k._lib is None and n._lib is None and not n._tried\n"
        "print('clean')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_stream_cli_imports_the_port_alone():
    """Importing the streaming CLI, parsing its flags and importing its
    pipeline loads neither JAX, ``txr``, OpenCV nor Plotly, and builds
    nothing."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('cli', "
        "'reconstruction_torch.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "mod.build_parser().parse_args(['--no-fused', '--mode', 'camera'])\n"
        "import txr_torch._cuda as k, txr_torch._native as n\n"
        "import txr_torch.pipelines.streaming\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'txr', 'cv2', 'plotly'))\n"
        "assert not bad, bad\n"
        "assert k._lib is None and n._lib is None and not n._tried\n"
        "print('clean')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


ROS2_SHELLS = [ROOT / "ros2_ws/src/txr_slam/txr_slam" / name for name in
               ("depth_node_torch.py", "db_player_node_torch.py")]


@pytest.mark.parametrize("script", ["multichip_torch.py", "db_info_torch.py",
                                    "get_calibration_torch.py"])
def test_root_script_imports_the_port_alone(script):
    """Importing the script and the port modules it reaches loads neither
    JAX nor ``txr`` and builds nothing."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('s', {script!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "import txr_torch.train, txr_torch.parallel.pipeline\n"
        "import txr_torch.parallel.launch, txr_torch.io.rtabmap_db\n"
        "import txr_torch.ros2.nodes, txr_torch.utils.chamfer\n"
        "import txr_torch._cuda as k\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'txr'))\n"
        "assert not bad, bad\n"
        "assert k._lib is None\n"
        "print('clean')\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def test_ros2_shells_reach_the_port_only():
    """The port's nodes (rclpy is not importable here) name ``txr_torch``
    and log the card, not the TPU."""
    for path in ROS2_SHELLS:
        text = path.read_text()
        assert "txr_torch." in text and "TPU" not in text, path
    assert "Depth model ready on {model.device}" in ROS2_SHELLS[0].read_text()


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "depth_processor_torch.py",
       ROOT / "depth_to_reconstruction_torch.py",
       ROOT / "depth_enhanced_reconstruction_torch.py",
       ROOT / "reconstruction_torch.py", ROOT / "multichip_torch.py",
       ROOT / "db_info_torch.py", ROOT / "get_calibration_torch.py"]
    + ROS2_SHELLS))
def test_source_imports_no_jax_flax_txr(path):
    text = (ROOT / path).read_text()
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|txr)(?:[.\s]|$)",
                     re.M)
    assert not pat.findall(text), path


def test_sources_keep_library_calls_off_the_kernel_path():
    """No fused library operator or compiler stands in for a kernel."""
    for p in PKG.rglob("*.py"):
        text = p.read_text()
        assert "scaled_dot_product_attention" not in text, p
        assert "torch.compile" not in text, p
    # the library's int8 product belongs to the "int8" policy alone, and
    # the library's conv appears beside the conv kernel only as its plain
    # version
    for name in ("quant_fused.py", "conv_stripe.py", "attention.py"):
        assert "_int_mm" not in (PKG / "ops" / name).read_text(), name
    text = (PKG / "ops" / "conv_stripe.py").read_text()
    launch = text[text.index("def _launch"):text.index("class _Conv3x3Stripe")]
    assert "F.conv2d" not in launch and "conv3x3_reference" not in launch


def test_every_kernel_has_a_launch_count():
    import txr_torch._cuda as k

    assert set(k.launches) == {"attention", "attention_boundmax",
                               "attention_key_norm", "attention_bhsd",
                               "attention_cached", "dpt_tail", "segscan",
                               "offset_reduce", "int8_linear", "conv3x3",
                               "qk_prep", "merge_sorted", "residual_norm",
                               "upsample"}
    k.launches["conv3x3"] += 2
    k.reset_launches()
    assert not any(k.launches.values())


@pytest.mark.parametrize("call", ["int8_linear", "conv3x3", "attention_bhsd",
                                  "attention_boundmax", "offset_map_insert",
                                  "voxel_downsample", "lsd_lines",
                                  "qk_prep", "merge_sorted",
                                  "attention_cached", "residual_norm",
                                  "upsample"])
def test_cpu_tensors_never_reach_a_kernel(call):
    """On a CPU tensor a wrapper runs its plain version and counts no
    launch."""
    import txr_torch._cuda as k
    from txr_torch.core.types import PointSet
    from txr_torch.fusion.offset_map import (create_offset_map,
                                             offset_map_insert)
    from txr_torch.ops.attention import attention_flash, fused_attention
    from txr_torch.ops.conv_stripe import conv3x3_stripe
    from txr_torch.ops.quant_fused import int8_linear

    k.reset_launches()
    if call == "attention_boundmax":
        fused_attention(torch.ones(1, 4, 3 * 2 * 64), 2, 64,
                        score_mode="boundmax")
    elif call == "offset_map_insert":
        offset_map_insert(create_offset_map(8, 0.1, device="cpu"),
                          PointSet.from_numpy(np.ones((3, 3), np.float32),
                                              device="cpu"))
    elif call == "int8_linear":
        int8_linear(torch.ones(4, 16), torch.ones(16, 8))
    elif call == "voxel_downsample":
        from txr_torch.ops.voxel import voxel_downsample

        voxel_downsample(PointSet.from_numpy(np.eye(3, dtype=np.float32),
                                             device="cpu"), 0.5)
    elif call == "lsd_lines":
        from txr_torch.ops.lsd import lsd_lines

        lsd_lines(torch.zeros((12, 16), dtype=torch.uint8))
    elif call == "conv3x3":
        conv3x3_stripe(torch.ones(1, 4, 4, 8), torch.ones(3, 3, 8, 8),
                       torch.ones(8))
    elif call == "qk_prep":
        from txr_torch.ops.qk_prep import qk_prep, rope_tables

        norm = torch.nn.LayerNorm(64).to(torch.bfloat16)
        qk_prep(torch.ones(1, 7, 3 * 2 * 64, dtype=torch.bfloat16), 2, norm,
                norm, rope_tables(2, 3, 64, 100.0, "cpu"))
    elif call == "attention_cached":
        from txr_torch.ops.attention import cached_attention

        cached_attention(torch.ones(1, 3, 3 * 2 * 64),
                         torch.ones(8, 2 * 2 * 64), 2, 64, 4, 1)
    elif call == "residual_norm":
        from txr_torch.ops.residual_norm import residual_norm

        x = torch.ones(3, 64, dtype=torch.bfloat16)
        residual_norm(x, x, x[0], torch.nn.LayerNorm(64).to(torch.bfloat16))
    elif call == "upsample":
        from txr_torch.ops.upsample import upsample_bilinear

        upsample_bilinear(torch.ones(1, 8, 3, 4, dtype=torch.bfloat16).to(
            memory_format=torch.channels_last), (6, 8), True)
    elif call == "merge_sorted":
        from txr_torch.ops.merge import merge_sorted

        key = torch.arange(3, dtype=torch.int64)
        merge_sorted(torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32), key, key)
    else:
        q = torch.ones(1, 3, 4, 64)
        attention_flash(q, q, q)
    assert not any(k.launches.values()) and k._lib is None


def test_device_none_means_cuda_and_raises_without_it():
    from txr_torch import resolve_device
    from txr_torch.core.types import PointSet
    from txr_torch.fusion.offset_map import create_offset_map
    from txr_torch.models.depth_anything import (DepthAnythingModel,
                                                 build_model)

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for call in (lambda: resolve_device(None),
                 lambda: create_offset_map(16, 0.1),
                 lambda: PointSet.empty(4),
                 lambda: build_model("v2", "vits"),
                 lambda: DepthAnythingModel("v2", "vits"),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    vm = create_offset_map(16, 0.1, device="cpu")
    assert vm.khi.device.type == "cpu" and vm.khi.shape == (16,)
    assert PointSet.empty(4, device="cpu").capacity == 4


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=str(ROOT), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
