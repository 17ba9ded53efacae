"""The DPT head's bilinear resize (``txr_torch/ops/upsample.py``).

On the CPU: the plain version is ``F.interpolate``, and the wrapper sends a
CPU tensor to it; the kernel's argument checks, which are pure and run on
CPU tensors (the cells' launches, the vector width from the channels and
the address, the output's dtype, refusals); the autograd Function's
gradients against ``F.interpolate``'s; the DPT head's resizes, each one the
kernel takes, and the counters ``_bilinear`` keeps; the head's output
unchanged.

On the card (``chip``; skips without one; this file imports no JAX, so run
it without the suite's conftest: ``python -m pytest
tests/test_torch_upsample.py -q -m chip --noconftest``): the kernel against
``F.interpolate`` by ``chip_smoke.py``'s comparison at the cells' shapes,
ragged ones and under autocast, and a CUDA graph's replay.
"""

from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from txr_torch.models import dpt
from txr_torch.models.dpt import DPTConfig, DPTHead, FeatureFusionBlock
from txr_torch.ops.upsample import (IN_F32, OUT_F32, SEGMENT_CHUNKS,
                                    THREADS, _Upsample,
                                    require_upsample_operands,
                                    upsample_bilinear, upsample_bilinear_plain)
from txr_torch.utils import profiling

# a vits-class head: the widths of Depth Anything's ViT-S
VITS_DPT = dict(features=64, out_channels=(48, 96, 192, 384))
VITS_HIDDEN = 384


def nhwc(n, c, h, w, dtype=torch.bfloat16, seed=29, offset=0):
    """A seeded (n, c, h, w) map in channels_last memory, ``offset``
    values into its storage."""
    g = torch.Generator().manual_seed(seed)
    flat = (torch.randn(n * h * w * c + offset, generator=g) * 2).to(dtype)
    return flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("align", [True, False], ids=["corners", "centres"])
@pytest.mark.parametrize("shape, size", [
    ((2, 16, 5, 7), (10, 14)), ((1, 3, 9, 4), (4, 11)),
    ((2, 8, 1, 1), (3, 2)), ((1, 12, 6, 6), (6, 6))], ids=str)
def test_plain_is_f_interpolate(shape, size, align, dtype):
    """The plain version and the wrapper on a CPU tensor are
    ``F.interpolate`` bit for bit, in its dtype and memory format."""
    x = nhwc(*shape, dtype)
    want = F.interpolate(x, size=size, mode="bilinear", align_corners=align)
    for got in (upsample_bilinear_plain(x, size, align),
                upsample_bilinear(x, list(size), align)):
        assert got.dtype == dtype and torch.equal(got, want)
        assert got.stride() == want.stride()


@pytest.mark.parametrize("frames, grids", [
    (8, (((19, 33), (37, 66)), ((37, 66), (74, 132)),
         ((74, 132), (148, 264)), ((148, 264), (296, 528)))),
    (32, (((11, 19), (21, 37)), ((21, 37), (42, 74)),
          ((42, 74), (84, 148)), ((84, 148), (168, 296))))],
    ids=["DA2", "VGGT"])
def test_checks_plan_the_cells_launches(frames, grids):
    """DA2's four fusion blocks at 8 frames and VGGT's at 32 views, bf16
    maps of 256 channels: chunks of 8 channels (16 bytes), a row cut into
    balanced segments of at most SEGMENT_CHUNKS chunks, a block of
    THREADS threads a segment, bf16 out."""
    for (h, w), (ho, wo) in grids:
        x = torch.empty(frames, 256, h, w, dtype=torch.bfloat16,
                        memory_format=torch.channels_last)
        plan = require_upsample_operands(x, (ho, wo), True)
        segments = -(-wo * 32 // SEGMENT_CHUNKS)
        assert {k: plan[k] for k in ("n", "c", "h", "w", "out_h", "out_w",
                                     "vec", "segments", "blocks", "threads",
                                     "dtypes")} == {
            "n": frames, "c": 256, "h": h, "w": w, "out_h": ho,
            "out_w": wo, "vec": 8, "segments": segments,
            "blocks": frames * ho * segments, "threads": THREADS,
            "dtypes": 0}
        assert plan["out_dtype"] == torch.bfloat16
        assert plan["align_corners"] is True


@pytest.mark.parametrize("dtype, channels, offset, vec", [
    (torch.bfloat16, 256, 0, 8), (torch.bfloat16, 100, 0, 4),
    (torch.bfloat16, 12, 0, 4), (torch.bfloat16, 6, 0, 2),
    (torch.bfloat16, 3, 0, 1), (torch.bfloat16, 256, 1, 1),
    (torch.bfloat16, 256, 2, 2), (torch.float32, 256, 0, 4),
    (torch.float32, 100, 0, 4), (torch.float32, 6, 0, 2),
    (torch.float32, 3, 0, 1), (torch.float32, 64, 1, 1)], ids=str)
def test_checks_pick_the_widest_chunk(dtype, channels, offset, vec):
    """The chunk is the most channels, at most 16 bytes, that divide the
    channel count and whose bytes divide the input's address."""
    x = nhwc(2, channels, 3, 5, dtype, offset=offset)
    assert require_upsample_operands(x, (6, 10), False)["vec"] == vec


@pytest.mark.parametrize("dtype, autocast, bits, out", [
    (torch.bfloat16, False, 0, torch.bfloat16),
    (torch.float32, False, IN_F32 | OUT_F32, torch.float32),
    (torch.bfloat16, True, OUT_F32, torch.float32),
    (torch.float32, True, IN_F32 | OUT_F32, torch.float32)],
    ids=["bf16", "f32", "bf16-autocast", "f32-autocast"])
def test_checks_plan_the_dtype_f_interpolate_gives(dtype, autocast, bits,
                                                   out):
    """x's dtype, or float32 under CUDA's autocast, whose policy runs the
    resize in float32 (the flag is set by hand: this machine has no
    card)."""
    x = nhwc(2, 16, 3, 4, dtype)
    was = torch.is_autocast_enabled("cuda")
    torch.set_autocast_enabled("cuda", autocast)
    try:
        plan = require_upsample_operands(x, (6, 8), True)
    finally:
        torch.set_autocast_enabled("cuda", was)
    assert (plan["dtypes"], plan["out_dtype"]) == (bits, out)


@pytest.mark.parametrize("x, size, error", [
    (lambda: nhwc(2, 16, 3, 4).half(), (6, 8), TypeError),
    (lambda: nhwc(2, 16, 3, 4).double(), (6, 8), TypeError),
    (lambda: torch.zeros(16, 3, 4, dtype=torch.bfloat16), (6, 8),
     ValueError),
    (lambda: torch.zeros(2, 16, 3, 4, dtype=torch.bfloat16), (6, 8),
     ValueError),
    (lambda: nhwc(2, 16, 3, 4)[:, :, :, 1:], (6, 8), ValueError),
    (lambda: nhwc(2, 16, 3, 4), (0, 8), ValueError),
    (lambda: nhwc(2, 16, 3, 4), (6, 2 ** 31 // 16), ValueError)],
    ids=["half", "double", "3-d", "nchw", "a-view", "empty-size",
         "too-wide"])
def test_checks_refuse_what_the_kernel_does_not_take(x, size, error):
    with pytest.raises(error):
        require_upsample_operands(x(), size, True)


@pytest.mark.parametrize("align", [True, False], ids=["corners", "centres"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_function_gradients_are_f_interpolates(dtype, align):
    """The autograd Function (the plain version forward on the CPU): the
    output and x's gradient bit-equal to ``F.interpolate``'s."""
    x = nhwc(2, 16, 5, 7, dtype)
    g = torch.Generator().manual_seed(3)
    cot = torch.randn(2, 16, 9, 12, generator=g).to(dtype)
    runs = []
    for route in ("function", "plain"):
        leaf = x.detach().requires_grad_()
        out = (_Upsample.apply(leaf, (9, 12), align, None)
               if route == "function"
               else F.interpolate(leaf, size=(9, 12), mode="bilinear",
                                  align_corners=align))
        out.backward(cot)
        runs.append((out.detach(), leaf.grad))
    (out_f, grad_f), (out_p, grad_p) = runs
    assert torch.equal(out_f, out_p)
    assert grad_f is not None and torch.equal(grad_f, grad_p)


def _head(seed=29, **cfg):
    torch.manual_seed(seed)
    return DPTHead(DPTConfig(**VITS_DPT, **cfg), VITS_HIDDEN).to(
        torch.bfloat16, memory_format=torch.channels_last).eval()


def _hidden(b=2, ph=4, pw=6, seed=30):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, 1 + ph * pw, VITS_HIDDEN, generator=g).to(
        torch.bfloat16) for _ in range(4)]


@pytest.mark.parametrize("cfg, calls", [
    ({}, 4), ({"dual": True}, 8), ({"fused_head": False}, 5)],
    ids=["depth", "dual", "unfused-tail"])
def test_head_hands_the_kernel_every_resize(monkeypatch, cfg, calls):
    """A vits-class head's forward on the CPU: each resize it makes goes
    through ``_bilinear`` on a map that the kernel's checks take (bf16,
    channels_last, chunks of 16 bytes), four a fusion stack and one for the
    unfused tail; a profiled forward counts as many
    ``models.upsample_plain_calls`` and no kernel call; the output is the
    same bytes as with ``F.interpolate`` called directly."""
    head = _head(**cfg)
    hidden = _hidden()
    with torch.no_grad():
        direct = head(hidden, 4, 6)
    plans = []

    def spy(x, size, align_corners):
        plans.append(require_upsample_operands(x, size, align_corners))
        return upsample_bilinear(x, size, align_corners)

    monkeypatch.setattr(dpt, "upsample_bilinear", spy)
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]), \
                torch.no_grad():
            got = head(hidden, 4, 6)
        counted = profiling.counters()
    finally:
        profiling.reset_counters()
    assert len(plans) == calls
    assert all(p["vec"] == 8 and p["dtypes"] == 0 for p in plans)
    assert counted.get("models.upsample_plain_calls") == calls
    assert "models.upsample_kernel_calls" not in counted
    monkeypatch.setattr(dpt, "upsample_bilinear",
                        lambda x, size, align_corners: F.interpolate(
                            x, size=tuple(size), mode="bilinear",
                            align_corners=align_corners))
    with torch.no_grad():
        want = head(hidden, 4, 6)
    outs = ([(direct, got, want)] if not cfg.get("dual") else
            [(direct[k], got[k], want[k]) for k in want])
    for a, b, c in outs:
        assert torch.equal(a, c) and torch.equal(b, c)


def test_fusion_block_resizes_a_residual_of_another_grid():
    """A residual on another grid than the block's input is resized with
    align_corners=False, then the block's output with align_corners=True:
    both through the wrapper, the same bytes as ``F.interpolate``'s."""
    torch.manual_seed(31)
    block = FeatureFusionBlock(32).to(torch.bfloat16,
                                      memory_format=torch.channels_last)
    x, res = nhwc(2, 32, 9, 11), nhwc(2, 32, 10, 12, seed=32)
    seen = []
    real = dpt.upsample_bilinear

    def spy(t, size, align_corners):
        seen.append((tuple(t.shape[2:]), tuple(size), align_corners))
        return real(t, size, align_corners)

    with torch.no_grad():
        dpt.upsample_bilinear = spy
        try:
            got = block(x, res, size=(17, 21))
        finally:
            dpt.upsample_bilinear = real
        r = F.interpolate(res, size=(9, 11), mode="bilinear",
                          align_corners=False)
        y = block.rcu2(x + block.rcu1(r))
        want = block.project(F.interpolate(y, size=(17, 21), mode="bilinear",
                                           align_corners=True))
    assert seen == [((10, 12), (9, 11), False), ((9, 11), (17, 21), True)]
    assert torch.equal(got, want)


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def smoke(card):
    """``chip_smoke.py``, for its operands and its comparison."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    s = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@pytest.mark.chip
@pytest.mark.parametrize("dtype, autocast", [
    (torch.bfloat16, False), (torch.float32, False),
    (torch.bfloat16, True)], ids=["bf16", "f32", "bf16-autocast"])
@pytest.mark.parametrize("align", [True, False], ids=["corners", "centres"])
def test_kernel_matches_f_interpolate_on_the_card(smoke, align, dtype,
                                                  autocast):
    """Every cell's fusion-block shape, the unfused tail's and the ragged
    ones: within one ulp of the terms of ``F.interpolate``'s channels-last
    kernel (``chip_smoke.compare_upsample``, which reports the bit-equal
    share; ``chip_smoke.interpolate_channels_last``); one launch a
    call."""
    from txr_torch import _cuda

    gen = torch.Generator(device="cuda").manual_seed(2 ** 31 + 29)
    shapes = [(n, c, hw, size) for _, n, c, hw, size in smoke.UP_CELLS]
    for n, c, hw, size in shapes + list(smoke.UP_RAGGED):
        x = smoke.upsample_operand(n, c, hw, gen, dtype)
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                             enabled=autocast):
            launches = _cuda.launches["upsample"]
            got = upsample_bilinear(x, size, align)
            assert _cuda.launches["upsample"] == launches + 1
            line = smoke.compare_upsample(
                f"{n}x{c}x{hw} -> {size}", got,
                smoke.interpolate_channels_last(x, size, align), x, size,
                align)
        assert line["ok"]


@pytest.mark.chip
def test_graph_replays_the_kernel(smoke):
    """Captured in a CUDA graph and replayed on new input, as the fused
    stream's graphs run it: equal to ``F.interpolate``."""
    smoke.check_upsample_graph(
        torch.Generator(device="cuda").manual_seed(2 ** 31 + 30))
