"""The ViT block's residual update and the LayerNorm after it
(``txr_torch/ops/residual_norm.py``).

On the CPU: the plain version against the block's own operators at every
width of the port's blocks; the kernel's argument checks, which are pure
and run on CPU tensors; the autograd Function's gradients against the
plain composition's; the counters ``Block`` keeps and the benchmark's
reader of them.

On the card (``chip``; skips without one; this file imports no JAX, so run
it without the suite's conftest: ``python -m pytest
tests/test_torch_residual_norm.py -q -m chip --noconftest``): the kernel
against the plain version by ``chip_smoke.py``'s comparison, x' bit for bit
and h within one bf16 ulp of the LayerNorm's terms.
"""

from pathlib import Path

import pytest
import torch
import torch.nn as nn

from port_bench.lib import spec
from txr_torch.models.vit import ViTConfig, ViTEncoder
from txr_torch.ops.residual_norm import (BRANCH_F32, H_F32, PARAMS_F32,
                                         X_F32, _ResidualNorm,
                                         require_residual_norm_operands,
                                         residual_norm, residual_norm_plain)
from txr_torch.utils import profiling

READER = spec.metric_reader("models.residual_norm_kernel_share.offline")
TRACED = {"trace": {"frames": 1}}


def operands(rows=6, width=1024, dtypes=(torch.bfloat16,) * 3, seed=27):
    """Seeded x, branch, LayerScale gamma and a LayerNorm of the given
    (x, branch, parameter) dtypes."""
    g = torch.Generator().manual_seed(seed)
    xd, bd, pd = dtypes
    x = (torch.randn(rows, width, generator=g) * 2.0 + 0.5).to(xd)
    branch = torch.randn(rows, width, generator=g).to(bd)
    gamma = (torch.rand(width, generator=g) * 1.99 + 0.01).to(pd)
    ln = nn.LayerNorm(width, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(torch.randn(width, generator=g) * 0.3 + 1.0)
        ln.bias.copy_(torch.randn(width, generator=g) * 0.1)
    return x, branch, gamma, ln.to(pd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("width", [384, 768, 1024, 2048])
def test_plain_is_the_blocks_operators(width, dtype):
    """x' bit-equal to ``x + branch * gamma`` and h to ``nn.LayerNorm`` of
    it; the CPU takes the plain version."""
    x, branch, gamma, ln = operands(5, width, (dtype,) * 3)
    with torch.no_grad():
        out, h = residual_norm_plain(x, branch, gamma, ln)
        want = x + branch * gamma
        assert out.dtype == dtype and torch.equal(out, want)
        assert torch.equal(h, ln(want))
        assert torch.equal(residual_norm_plain(x, branch, gamma), want)
        got, got_h = residual_norm(x, branch, gamma, ln)
        assert torch.equal(got, want) and torch.equal(got_h, h)
        assert torch.equal(residual_norm(x, branch, gamma), want)


def test_checks_pass_the_cells_launches():
    """DA2's 8-frame step (19,544 rows of 1024), VGGT's 32 views: a warp a
    row, 4 rows a block of 128 threads; all bf16, no dtype bit set."""
    for b, s in ((8, 2443), (32, 782)):
        rows = b * s
        x = torch.empty(b, s, 1024, dtype=torch.bfloat16)
        _, _, gamma, ln = operands()
        plan = require_residual_norm_operands(x, x.clone(), gamma, ln)
        assert {k: plan[k] for k in ("rows", "width", "blocks", "threads",
                                     "dtypes")} == {
            "rows": rows, "width": 1024, "blocks": -(-rows // 4),
            "threads": 128, "dtypes": 0}
        assert plan["out_dtype"] == plan["h_dtype"] == torch.bfloat16


@pytest.mark.parametrize("dtypes, autocast, bits, out, h", [
    ((torch.float32,) * 3, False, X_F32 | BRANCH_F32 | PARAMS_F32 | H_F32,
     torch.float32, torch.float32),
    ((torch.bfloat16, torch.bfloat16, torch.float32), True,
     PARAMS_F32 | H_F32, torch.float32, torch.float32),
    ((torch.float32, torch.bfloat16, torch.float32), True,
     X_F32 | PARAMS_F32 | H_F32, torch.float32, torch.float32),
    ((torch.bfloat16,) * 3, True, 0, torch.bfloat16, torch.bfloat16)],
    ids=["f32", "autocast-first-block", "autocast", "bf16-autocast"])
def test_checks_plan_the_dtypes_the_plain_version_gives(dtypes, autocast,
                                                        bits, out, h):
    """A float32 model's and bf16 autocast's operands: the dtype bits, and
    x' and h in the dtypes the plain version gives them. (CUDA's autocast
    runs a bf16 model's LayerNorm in float32, the CPU's in bf16: the plan
    sets H_F32 for it on the card, where ``chip_smoke.py`` holds it.)"""
    args = operands(dtypes=dtypes)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        plan = require_residual_norm_operands(*args)
        want_out, want_h = residual_norm_plain(*args)
    assert plan["dtypes"] == bits
    assert (plan["out_dtype"], plan["h_dtype"]) == (out, h)
    assert (want_out.dtype, want_h.dtype) == (out, h)


def _half(args):
    args[0] = args[0].half()


def _double_gamma(args):
    args[2] = args[2].double()


def _width_12(args):
    args[:3] = [args[0][:, :12].contiguous(), args[1][:, :12].contiguous(),
                args[2][:12]]


def _width_4096(args):
    args[:3] = [args[0].repeat(1, 4), args[1].repeat(1, 4),
                args[2].repeat(4)]


def _noncontiguous(args):
    args[0] = args[0].t().contiguous().t()


def _shapes(args):
    args[1] = args[1][:-1]


def _device(args):
    args[2] = args[2].to("meta")


def _no_affine(args):
    args[3] = nn.LayerNorm(args[0].shape[-1], elementwise_affine=False)


def _norm_dtype(args):
    args[3] = args[3].float()


def _misaligned(args):
    flat = torch.zeros(args[0].numel() + 1, dtype=args[0].dtype)
    args[0] = flat[1:].view(args[0].shape)


@pytest.mark.parametrize("fault, error", [
    (_half, TypeError), (_double_gamma, TypeError), (_width_12, ValueError),
    (_width_4096, ValueError), (_noncontiguous, ValueError),
    (_shapes, ValueError), (_device, ValueError), (_no_affine, ValueError),
    (_norm_dtype, ValueError), (_misaligned, ValueError)],
    ids=lambda p: p.__name__.strip("_") if callable(p) else p.__name__)
def test_checks_refuse_what_the_kernel_does_not_take(fault, error):
    args = list(operands())
    require_residual_norm_operands(*args)
    fault(args)
    with pytest.raises(error):
        require_residual_norm_operands(*args)


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "alone"])
@pytest.mark.parametrize("dtypes", [
    (torch.float32,) * 3, (torch.bfloat16,) * 3,
    (torch.float32, torch.bfloat16, torch.float32)],
    ids=["f32", "bf16", "mixed"])
def test_function_gradients_are_the_plain_compositions(dtypes, norm):
    """The autograd Function (the plain version forward on the CPU): x',
    h and the gradients of x, branch, gamma, weight and bias bit-equal to
    the plain composition's."""
    x, branch, gamma, ln = operands(4, 384, dtypes)
    leaves = [t.detach().requires_grad_() for t in (x, branch, gamma)]
    g = torch.Generator().manual_seed(3)
    cot = [torch.randn(x.shape, generator=g) for _ in range(2)]
    params = [ln.weight, ln.bias] if norm else []
    runs = []
    for route in ("function", "plain"):
        for t in leaves + params:
            t.grad = None
        if route == "function":
            out = _ResidualNorm.apply(
                *leaves, *(params if norm else (None, None)),
                ln.eps if norm else 0.0, None)
        else:
            out = residual_norm_plain(*leaves, ln if norm else None)
        outs = out if norm else (out,)
        torch.autograd.backward(outs, [c.to(o.dtype)
                                       for c, o in zip(cot, outs)])
        runs.append(([o.detach() for o in outs],
                     [t.grad for t in leaves + params]))
    (outs_f, grads_f), (outs_p, grads_p) = runs
    assert all(torch.equal(a, b) for a, b in zip(outs_f, outs_p))
    assert len(grads_f) == len(grads_p) == 3 + 2 * norm
    assert all(a is not None and torch.equal(a, b)
               for a, b in zip(grads_f, grads_p))


def test_encoder_counts_a_plain_call_per_residual():
    """A profiled CPU forward of a 2-block encoder counts two
    ``models.residual_norm_plain_calls`` a block, and the benchmark's
    reader reads 0 % through the kernel."""
    torch.manual_seed(27)
    enc = ViTEncoder(ViTConfig(hidden_size=128, num_layers=2, num_heads=2,
                               pos_embed_size=4, out_layers=(0, 1))).eval()
    x = torch.randn(2, 28, 42, 3)
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]), \
                torch.no_grad():
            enc(x)
        got = profiling.counters()
        assert got.get("models.residual_norm_plain_calls") == 4
        assert "models.residual_norm_kernel_calls" not in got
        assert READER(TRACED) == 0.0
    finally:
        profiling.reset_counters()


@pytest.mark.parametrize("counts, share", [
    ({}, None), ({"models.residual_norm_kernel_calls": 48}, 100.0),
    ({"models.residual_norm_kernel_calls": 3,
      "models.residual_norm_plain_calls": 1}, 75.0)])
def test_reader(counts, share):
    """The reader's share, and None where the program kept neither counter
    (a program without them) or the run was not traced."""
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for name, n in counts.items():
                profiling.count(name, n)
        assert READER(TRACED) == share
        assert READER({"trace": None}) is None
    finally:
        profiling.reset_counters()


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
@pytest.mark.parametrize("rows, width", [(8 * 2443, 1024), (5, 1024),
                                         (1001, 384), (37, 2048)], ids=str)
def test_kernel_matches_plain_on_the_card(smoke, rows, width):
    """x' bit for bit and h within one bf16 ulp of the LayerNorm's terms
    of the plain version's (``chip_smoke.compare_residual_norm``); x' alone
    bit for bit; one launch a call."""
    from txr_torch import _cuda

    gen = torch.Generator(device="cuda").manual_seed(2 ** 31 + rows)
    args = smoke.residual_norm_operands(rows, width, gen)
    with torch.no_grad():
        launches = _cuda.launches["residual_norm"]
        got = residual_norm(*args)
        assert _cuda.launches["residual_norm"] == launches + 1
        line = smoke.compare_residual_norm(f"{rows} x {width}", got,
                                           residual_norm_plain(*args),
                                           args[3])
        assert line["ok"] and line["x_out_bit_equal"]
        x, branch, gamma, _ = args
        assert torch.equal(residual_norm(x, branch, gamma),
                           x + branch * gamma)
