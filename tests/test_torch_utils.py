"""The port's last modules against ``txr`` on the CPU: the chamfer metric
and profiling helpers (``txr_torch/utils``), the RTAB-Map database scripts
(``db_info_torch.py``, ``get_calibration_torch.py``), the ROS2 nodes' logic
(``txr_torch/ros2/nodes.py``) and ``PixelShuffleUp``."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rtabmap_db import rtabmap_db  # noqa: F401  (the fixture)
from txr.utils.chamfer import chamfer_distance as txr_chamfer

from txr_torch.io.ply import write_ply
from txr_torch.models.convert import from_txr_params
from txr_torch.models.dpt import PixelShuffleUp
from txr_torch.utils.chamfer import chamfer_between_plys, chamfer_distance
from txr_torch.models.vit import ViTConfig, ViTEncoder
from txr_torch.utils.profiling import maybe_trace

torch.set_num_threads(1)

# f32 on both sides; the nearest neighbour is the same point, its distance
# is a subtraction and a norm, and the means add in another order
CHAMFER_RTOL = 1e-5


def _cloud(case: str):
    """``tests/test_utils.py``'s cases, from its seed."""
    rng = np.random.default_rng(0)
    if case == "identical":
        a = rng.normal(size=(500, 3)).astype(np.float32)
        return a, a, 0.0
    if case == "known_offset":
        a = rng.uniform(0, 10, (200, 3)).astype(np.float32)
        a[:, 0] = np.arange(200) * 5.0
        return a, a + np.array([0.01, 0, 0], np.float32), 0.01
    if case == "asymmetric":
        a = rng.normal(size=(300, 3)).astype(np.float32)
        return a, a[:100], None
    if case == "large_coordinates":
        a = rng.uniform(0, 1000, (300, 3)).astype(np.float32)
        return a, a + np.array([0.01, 0, 0], np.float32), 0.01
    if case == "chunks_and_subsample":     # 3 chunks, then max_points
        a = rng.uniform(0, 4, (2500, 3)).astype(np.float32)
        b = rng.uniform(0, 4, (2100, 3)).astype(np.float32)
        return a, b, None
    raise ValueError(case)


@pytest.mark.parametrize("case", ["identical", "known_offset", "asymmetric",
                                  "large_coordinates",
                                  "chunks_and_subsample"])
def test_chamfer_equals_txr(case):
    a, b, truth = _cloud(case)
    kw = {"max_points": 2000} if case == "chunks_and_subsample" else {}
    got = chamfer_distance(a, b, device="cpu", **kw)
    want = txr_chamfer(a, b, **kw)
    assert got == pytest.approx(want, rel=CHAMFER_RTOL, abs=1e-7)
    if not kw:      # a subsample draws from the first cloud first
        assert chamfer_distance(b, a, device="cpu") == pytest.approx(
            got, rel=CHAMFER_RTOL)
    if truth is not None:
        # test_utils.py's bounds: 1e-3 of the offset, 5e-3 at coordinates
        # of 1000 (the two-pass distance keeps them)
        rel = 5e-3 if case == "large_coordinates" else 1e-3
        assert got == pytest.approx(truth, rel=rel, abs=1e-6)


def test_chamfer_empty_and_plys(tmp_path):
    assert chamfer_distance(np.zeros((0, 3)), np.ones((5, 3)),
                            device="cpu") == float("inf")
    a, b, _ = _cloud("known_offset")
    pa, pb = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    write_ply(pa, a)
    write_ply(pb, b)
    assert chamfer_between_plys(pa, pb, device="cpu") == pytest.approx(
        txr_chamfer(a, b), rel=CHAMFER_RTOL)


def test_chamfer_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        chamfer_distance(np.ones((3, 3)), np.ones((3, 3)))


def test_maybe_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("TXR_TRACE_DIR", raising=False)
    with maybe_trace("off"):
        torch.ones(3).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("TXR_TRACE_DIR", str(tmp_path))
    encoder = ViTEncoder(ViTConfig(hidden_size=32, num_layers=1,
                                   num_heads=2, pos_embed_size=2,
                                   out_layers=(0,)))
    with maybe_trace("step"), torch.no_grad():
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        encoder(torch.zeros(1, 28, 42, 3))
    trace = json.loads((tmp_path / "step" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names
    assert {"txr.models.encoder", "txr.models.encoder.attention"} <= names
    # the position embedding's lookup has counters and no span of its own
    assert "txr.models.encoder.pos_embed" not in names


def _run_main(module, argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", argv)
    module.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("script,extra", [
    ("db_info", ["-o", "OUT"]), ("get_calibration", ["--raw"]),
    ("get_calibration", [])])
def test_db_scripts_print_what_txr_prints(script, extra, rtabmap_db,  # noqa: F811
                                          tmp_path, monkeypatch, capsys):
    import importlib

    theirs = importlib.import_module(script)
    ours = importlib.import_module(script + "_torch")
    outs = []
    for mod, name in ((theirs, "txr"), (ours, "port")):
        args = [a.replace("OUT", str(tmp_path / f"{name}.txt"))
                for a in extra]
        text = _run_main(mod, [script, rtabmap_db, *args], monkeypatch,
                         capsys)
        outs.append(text.replace(str(tmp_path / f"{name}.txt"), "OUT"))
    assert outs[0] == outs[1]
    assert "Data" in outs[1] or "Calibration blob" in outs[1]
    if extra[:1] == ["-o"]:
        assert ((tmp_path / "port.txt").read_text()
                == (tmp_path / "txr.txt").read_text())


def test_replay_tick_equals_txr_source(rtabmap_db):  # noqa: F811
    from txr.io.rtabmap_db import RTABMapDBSource as TxrSource

    from txr_torch.io.rtabmap_db import RTABMapDBSource
    from txr_torch.ros2.nodes import replay_tick

    ours, theirs = RTABMapDBSource(rtabmap_db), TxrSource(rtabmap_db)
    n = 0
    while True:
        frame = replay_tick(ours)
        try:
            bgr, _, _ = next(theirs)
        except StopIteration:
            assert frame is None
            break
        intr = theirs.intrinsics
        np.testing.assert_array_equal(frame.bgr, bgr)
        assert (frame.width, frame.height) == (bgr.shape[1], bgr.shape[0])
        assert (frame.fx, frame.fy, frame.cx, frame.cy) == (
            intr.fx, intr.fy, intr.cx, intr.cy)
        n += 1
    assert n == 5
    ours.close()
    theirs.close()


@pytest.fixture(scope="module")
def depth_pair():
    """``txr``'s DepthAnythingModel and the port's on one weight set (a
    narrow v2 'vits' registry entry, as tests/test_torch_model.py makes),
    both at the node's operating size (518)."""
    import txr.models.depth_anything as jda
    from txr.models.vit import ViTConfig as TxrViTConfig

    import txr_torch.models.depth_anything as pda
    from txr_torch.models.vit import ViTConfig

    mp = pytest.MonkeyPatch()
    mp.setitem(jda.VIT_PRESETS, "vits", TxrViTConfig(
        hidden_size=32, num_layers=2, num_heads=2, out_layers=(0, 0, 1, 1),
        use_flash=False))
    mp.setitem(pda.VIT_PRESETS, "vits", ViTConfig(
        hidden_size=32, num_layers=2, num_heads=2, out_layers=(0, 0, 1, 1)))
    for module in (jda, pda):
        mp.setitem(module.MODEL_CONFIGS["v2"], "vits",
                   {"encoder": "vits", "features": 16,
                    "out_channels": [8, 12, 16, 16]})
    models = {}
    for metric in (False, True):
        jm = jda.DepthAnythingModel(version="v2", encoder="vits",
                                    metric=metric, max_depth=20.0,
                                    param_dtype=jnp.float32, seed=0)
        rng = np.random.default_rng(5)
        jm.params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
                a.shape).astype(np.float32)), jm.params)
        from txr_torch.ros2.nodes import load_depth_model

        pm = load_depth_model("v2", "vits", metric=metric, max_depth=20.0,
                              device="cpu")
        pm.param_dtype = torch.float32
        pm.model.float()
        pm.model.load_state_dict(from_txr_params(
            jax.tree_util.tree_map(np.asarray, jm.params)))
        models[metric] = (jm, pm)
    yield models
    mp.undo()


@pytest.mark.parametrize("metric", [False, True], ids=["relative", "metric"])
@pytest.mark.parametrize("encoding", ["bgr8", "rgb8"])
def test_depth_callback_equals_the_node_on_txr(depth_pair, metric, encoding):
    """The depth node's callback (``depth_node.py:61-81``) on ``txr``'s
    ``infer`` against ``DepthCallback`` on the port's model: the frame as
    the encoding says, the heuristic or the metric head, 0 past
    max_depth."""
    from txr_torch.ros2.nodes import DepthCallback

    jm, pm = depth_pair[metric]
    image = np.random.default_rng(7).integers(0, 256, (60, 80, 3),
                                              dtype=np.uint8)
    max_depth, scale = (12.0 if metric else 6.0), 20.0
    bgr = image[..., ::-1] if encoding == "rgb8" else image
    rel = jm.infer(np.ascontiguousarray(bgr))
    want = rel if metric else scale / np.maximum(rel, 1e-3)
    want = np.where(want > max_depth, 0.0, want).astype(np.float32)
    got = DepthCallback(pm, metric=metric, max_depth=max_depth,
                        scale_factor=scale)(image, encoding)
    assert got.dtype == np.float32 and got.shape == (60, 80)
    # the models agree within 2e-4 (tests/test_torch_model.py); a pixel
    # that close to max_depth may fall on either side of it
    near = np.abs((rel if metric else scale / np.maximum(rel, 1e-3))
                  - max_depth) < 1e-3 * max_depth
    np.testing.assert_allclose(got[~near], want[~near], rtol=2e-4, atol=2e-4)
    assert 0 < (want == 0).sum() < want.size or metric


def test_load_depth_model_keeps_the_node_rule():
    from txr_torch.ros2.nodes import load_depth_model

    rel = load_depth_model("v2", "vits", metric=False, max_depth=3.5,
                           device="cpu")
    met = load_depth_model("v2", "vits", metric=True, max_depth=3.5,
                           device="cpu")
    assert (rel.metric, rel.max_depth) == (False, 20.0)
    assert (met.metric, met.max_depth) == (True, 3.5)
    assert rel.device == torch.device("cpu")


@pytest.mark.parametrize("k", [2, 4])
def test_pixel_shuffle_matches_convtranspose(k):
    """As ``tests/test_models.py::test_pixel_shuffle_matches_convtranspose``:
    against ``nn.ConvTranspose2d`` on its own weights, and against
    ``txr``'s ``PixelShuffleUp`` on ``txr``'s tree carried across."""
    import flax.linen as nn
    from txr.models.dpt import PixelShuffleUp as TxrPixelShuffleUp

    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 5, 6, 7)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ct = torch.nn.ConvTranspose2d(7, 9, k, stride=k)
    ps = PixelShuffleUp(7, 9, k)
    ps.load_state_dict(ct.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(ps(xt), ct(xt), rtol=1e-5, atol=1e-5)

    p = nn.ConvTranspose(9, (k, k), strides=(k, k), padding="VALID").init(
        jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = np.asarray(TxrPixelShuffleUp(9, k).apply({"params": p},
                                                    jnp.asarray(x)))
    sd = from_txr_params({"resize_0": jax.tree_util.tree_map(np.asarray, p)})
    ps.load_state_dict({k_.split(".", 1)[1]: v for k_, v in sd.items()})
    with torch.no_grad():
        got = ps(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
