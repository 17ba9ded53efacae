"""The StreamVGGT configuration and its architecture: VGGT-1B's published
widths with the stream's keys and what ``check_config`` refuses, the leaves
against the model's state dict, the operation counts by hand at a submap of
128 frames of 294 x 518 (global attention under the frame-causal mask, the
share of its pairs that read the cache, the cache's bytes) and against
PyTorch's count of the reference's products, the two new metric readers,
and a tiny cell run on the CPU to ``correct`` with its control not."""

import copy
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.lib import check, spec, weights

CFG = spec.load_json(spec.BENCH_DIR / "configs" / "streamvggt-1b.json")
VGGT = spec.load_json(spec.BENCH_DIR / "configs" / "vggt-1b.json")
ARCH = spec.architecture(CFG)
TINY = dict(CFG, hidden_size=64, num_attention_heads=4, front_layers=2,
            aa_pairs=2, out_indices=[0, 1, 1, 1], features=16,
            out_channels=[8, 16, 32, 32], pos_embed_grid=4, camera_layers=2,
            camera_iterations=2, stream_chunk_frames=3, cache_frames=8)
CELL = "streamvggt-submap128-c32"


def test_the_configuration_is_vggt_1b_with_a_stream():
    assert CFG["architecture"] == "streamvggt" and CFG["reduced"] == []
    own = {"name", "architecture", "source", "source_entry", "assumed"}
    assert {k: v for k, v in CFG.items() if k in VGGT and k not in own} \
        == {k: v for k, v in VGGT.items() if k not in own}
    assert {k: CFG[k] for k in set(CFG) - set(VGGT)} == {
        "causal": "frame", "stream_chunk_frames": 32, "cache_frames": 128}
    assert set(CFG["assumed"]) >= set(VGGT["assumed"]) | {"causal", "cache"}
    ARCH.check_config(CFG)
    for bad in (dict(CFG, causal="token"), dict(CFG, stream_chunk_frames=0),
                dict(CFG, stream_chunk_frames=129),
                dict(CFG, rope_freq=10000.0)):
        with pytest.raises(ValueError):
            ARCH.check_config(bad)


def test_leaves_are_the_models_state_dict():
    from txr_torch.models.vggt import StreamVGGT

    for cfg in (CFG, TINY):
        with torch.device("meta"):
            model = StreamVGGT(ARCH.model_config(cfg))
        got = {n: s for n, s, _, _ in ARCH.leaves(cfg)}
        assert {n: tuple(t.shape) for n, t in
                model.state_dict().items()} == got
    assert model.cfg.stream_chunk_frames == 3 and model.cfg.cache_frames == 8
    with torch.device("meta"):
        big = StreamVGGT(ARCH.model_config(CFG))
    assert len(ARCH.attention_modules(big)) == 72
    assert big.camera_head.block_0.attn.cfg.use_flash is False


def test_streamvggt_1b_by_hand():
    """A submap of 128 frames of 782 tokens: 24 global layers of 4 P^2 D
    for each frame against itself and every earlier frame (496.3 TFLOP,
    67 % of the step); the rest is VGGT's 1.879 TFLOP a frame but for the
    camera trunk's causal attention; 74.4 % of the global pairs read the
    cache in chunks of 32; the cache holds 9.84 GB."""
    p, d, n, hw = 782, 1024, 128, (294, 518)
    vggt = spec.architecture(VGGT)
    assert ARCH.attention_calls(CFG) == 288 == 4 * 72
    glob = 24 * 4 * p * p * d * (n * (n + 1) // 2)
    assert ARCH.cached_attention_flops(CFG, hw, n) == glob
    assert glob == pytest.approx(496.3e12, rel=1e-4)
    assert ARCH.attention_flops(CFG, hw, n) == glob + 48 * 4 * n * p * p * d
    step = ARCH.step_flops(CFG, hw, n)
    assert glob / step == pytest.approx(0.67, abs=0.005)
    rest = vggt.step_flops(VGGT, hw, 32) - 24 * 4 * (32 * p) ** 2 * d
    assert rest / 32 == pytest.approx(1.879e12, rel=1e-3)
    # the camera head once over the submap, its trunk causal
    w = 2 * d
    camera = 4 * (2 * n * 9 * w + 2 * n * w * 3 * w
                  + 4 * (2 * n * w * 12 * w + 4 * w * n * (n + 1) // 2)
                  + 2 * n * (w * w // 2 + w // 2 * 9))
    assert step - glob == pytest.approx(
        4 * (rest - vggt.camera_flops(VGGT, 32)) + camera, rel=1e-12)
    # a chunk of 32 frames: its rows against the 32 c frames cached before
    # it, and frame f of the chunk against the chunk's frames 0 ... f
    cached = sum(32 * p * 32 * c * p for c in range(4))
    fresh = 4 * p * p * (32 * 33 // 2)
    assert 100 * cached / (cached + fresh) == pytest.approx(74.42, abs=0.01)
    # k and v of every global layer for 128 frames, bf16
    assert 24 * 128 * p * 2 * d * 2 == pytest.approx(9.84e9, rel=1e-3)


@pytest.mark.parametrize("frames", [1, 3])
def test_counts_match_the_reference_products(frames):
    from port_bench.reference import streamvggt as ref

    w = weights.make_weights(ARCH, TINY, 1, "cpu", torch.float32)
    x = torch.zeros((frames, 3, 56, 84))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.outputs(x, w, TINY)
    assert counter.get_total_flops() == pytest.approx(
        ARCH.step_flops(TINY, (56, 84), frames), rel=1e-9)


def test_the_readers_of_the_new_metrics(monkeypatch):
    """``models.kv_cache_pair_share.offline`` from the program's counters;
    ``cached_attention_roofline.offline`` from the cached kernel's device
    time by name and the architecture's count of the traced steps."""
    share = spec.metric_reader("models.kv_cache_pair_share.offline")
    roof = spec.metric_reader("cached_attention_roofline.offline")
    rec = {"trace": {"frames": 256, "by_name": [
        ["void (anonymous namespace)::attention_cached_kernel(CUtensorMap"
         "_st, CUtensorMap_st, __nv_bfloat16*, ...)", 1.25],
        ["void (anonymous namespace)::attention_fwd_kernel<false>(...)",
         0.5]]},
        "config": CFG, "model_hw": [294, 518], "frames_per_step": 128,
        "peak_flops": 989e12}
    assert roof(rec) == pytest.approx(
        100 * 2 * 496.3e12 / 989e12 / 1.25, rel=1e-4)
    assert roof(dict(rec, trace={"frames": 256, "by_name": [
        ["attention_fwd_kernel", 1.0]]})) is None
    monkeypatch.setitem(share.__globals__, "program_counters", lambda: {
        "models.kv_pairs_cached": 3, "models.kv_pairs_fresh": 1})
    assert share(rec) == 75.0
    assert share({"trace": {}}) is None


def test_a_tiny_streamvggt_cell_is_correct_and_its_control_is_not():
    """The new cell's files at a CPU size (2 front blocks and 2 pairs of
    64, a submap of 8 frames of 168 x 280 in chunks of 3 at 56 x 84, a map
    of 2^12): ``Run``, the window and ``check.judge`` against the
    frame-causal reference give ``correct``; the int8 control fails a
    limit."""
    from port_bench.lib.bench import Run

    c = spec.load_cell(CELL)
    c.config = dict(TINY, input_size=84)
    trf = copy.deepcopy(c.traffic)
    trf.update(frame_hw=[168, 280], pool_frames=16, check_first_steps=2,
               frames_per_step=8)
    trf["map"]["capacity_log2"] = 12
    c.traffic = trf
    verdicts = []
    for quant in ("none", c.arch.CONTROL):
        run = Run(c, "cpu", quant=quant)
        run.prepare(2 ** 31 + 26)
        res = run.window(0.3, False)
        run.release()
        numbers = check.judge(run, res["checked"], control=quant != "none")
        verdicts.append(check.verdict(numbers, c.limits)[0])
    assert verdicts == [True, False]


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch, port_bench.reference.streamvggt\n"
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'txr', 'txr_torch', 'jax', 'jaxlib', 'flax'}))"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(spec.ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
