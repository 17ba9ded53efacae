"""Depth Anything 3's QK-norm + 2-D RoPE (``txr_torch/ops/qk_prep.py``).

On the CPU: the plain version against the float32 reference
``port_bench/reference/depth_anything_3.py`` at DA3's head width; the
kernel's argument checks, which are pure and run on CPU tensors; the
counters ``QKPrep`` keeps and the benchmark's reader of them.

On the card (``chip``; skips without one; this file imports no JAX, so run
it without the suite's conftest: ``python -m pytest
tests/test_torch_qk_prep.py -q -m chip --noconftest``): the kernel, which
updates the fused qkv in place, against the plain version on the same bf16
qkv by ``chip_smoke.py``'s comparison: at least 99 % of q and k bit-equal,
every value within one bf16 ulp of the rotation's terms, v and the memory
around the tensor untouched.
"""

from pathlib import Path

import pytest
import torch
import torch.nn as nn

from port_bench.lib import spec
from port_bench.reference import depth_anything_3 as ref
from txr_torch.models.vit import ViTConfig, ViTEncoder
from txr_torch.ops.qk_prep import (HEAD_DIM, qk_prep, qk_prep_plain,
                                   require_qk_prep_operands, rope_tables)
from txr_torch.utils import profiling

READER = spec.metric_reader("models.qk_prep_kernel_share.offline")
TRACED = {"trace": {"frames": 1}}


def norms(generator, dtype=torch.float32, device="cpu"):
    """q_norm and k_norm with seeded weights and biases."""
    out = []
    for _ in range(2):
        ln = nn.LayerNorm(HEAD_DIM, eps=1e-6)
        with torch.no_grad():
            ln.weight.copy_(torch.randn(HEAD_DIM, generator=generator) * 0.3
                            + 1.0)
            ln.bias.copy_(torch.randn(HEAD_DIM, generator=generator) * 0.1)
        out.append(ln.to(device=device, dtype=dtype))
    return out


def test_plain_matches_the_reference_at_da3_width():
    """16 heads of 64 on a 3 x 5 grid, two views: q and k against the
    reference's ``_ln`` + ``rope_2d``, v bit-equal."""
    b, heads, ph, pw = 2, 16, 3, 5
    s = 1 + ph * pw
    g = torch.Generator().manual_seed(21)
    qkv = torch.randn(b, s, 3 * heads * HEAD_DIM, generator=g) * 2.0 + 0.5
    q_norm, k_norm = norms(g)
    w = {f"{n}.{p}": getattr(ln, p).detach()
         for n, ln in (("q_norm", q_norm), ("k_norm", k_norm))
         for p in ("weight", "bias")}
    with torch.no_grad():
        got = qk_prep_plain(qkv, heads, q_norm, k_norm,
                            rope_tables(ph, pw, HEAD_DIM, 100.0, "cpu"))
    q, k, v = qkv.reshape(b, s, 3, heads, HEAD_DIM).permute(2, 0, 3, 1, 4)
    want = [ref.rope_2d(ref._ln(t, w, n), ph, pw, 100.0)
            for t, n in ((q, "q_norm"), (k, "k_norm"))]
    want = torch.stack(want + [v], dim=2)              # (B, H, 3, S, D)
    want = want.permute(0, 3, 2, 1, 4).reshape(b, s, -1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    c = heads * HEAD_DIM
    assert torch.equal(got[..., 2 * c:], qkv[..., 2 * c:])
    # the CPU takes the plain version and leaves its input as it was
    before = qkv.clone()
    with torch.no_grad():
        again = qk_prep(qkv, heads, q_norm, k_norm,
                        rope_tables(ph, pw, HEAD_DIM, 100.0, "cpu"))
    assert again is not qkv and torch.equal(again, got)
    assert torch.equal(qkv, before)


def operands(b=2, s=16, heads=4, dtype=torch.bfloat16):
    """Operands the kernel takes, on the CPU (a 3 x 5 grid)."""
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn(b, s, 3 * heads * HEAD_DIM, generator=g).to(dtype)
    q_norm, k_norm = norms(g, torch.bfloat16)
    return qkv, heads, q_norm, k_norm, rope_tables(3, 5, HEAD_DIM, 100.0,
                                                   "cpu")


def test_checks_pass_the_da3_launch():
    """The 16-view step's call: 2 x 16 x 2443 x 16 rows of q and k, 32 a
    block of 256 threads."""
    qkv = torch.empty(16, 2443, 3 * 16 * HEAD_DIM, dtype=torch.bfloat16)
    _, _, q_norm, k_norm, _ = operands()
    cos, sin = rope_tables(37, 66, HEAD_DIM, 100.0, "cpu")
    plan = require_qk_prep_operands(qkv, 16, q_norm, k_norm, (cos, sin))
    assert plan == {"rows": 1_250_816, "blocks": 39_088, "threads": 256}
    plan = require_qk_prep_operands(*operands(b=3, s=16, heads=5))
    assert plan == {"rows": 480, "blocks": 15, "threads": 256}


def _float_qkv(args):
    args[0] = args[0].float()


def _head_dim_32(args):
    args[0] = args[0].reshape(2, 16, -1)[..., : 3 * 4 * 32].contiguous()


def _noncontiguous(args):
    args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)


def _table_rows(args):
    args[4] = tuple(t[:-1] for t in args[4])


def _float_table(args):
    args[4] = (args[4][0].double(), args[4][1])


def _float_norm(args):
    args[2] = args[2].float()


def _grad(args):
    args[0] = args[0].clone().requires_grad_()


def _eps(args):
    args[3].eps = 1e-5


def _misaligned(args):
    flat = torch.zeros(args[0].numel() + 1, dtype=args[0].dtype)
    args[0] = flat[1:].view(args[0].shape)


@pytest.mark.parametrize("fault, error", [
    (_float_qkv, TypeError), (_head_dim_32, ValueError),
    (_noncontiguous, ValueError), (_table_rows, ValueError),
    (_float_table, ValueError), (_float_norm, ValueError),
    (_grad, RuntimeError), (_eps, ValueError), (_misaligned, ValueError)],
    ids=lambda p: p.__name__.strip("_") if callable(p) else p.__name__)
def test_checks_refuse_what_the_kernel_does_not_take(fault, error):
    args = list(operands())
    require_qk_prep_operands(*args)
    fault(args)
    with pytest.raises(error):
        require_qk_prep_operands(*args)


def test_grad_off_lets_a_leaf_through():
    """A tensor that requires grad is taken where autograd does not
    record."""
    args = list(operands())
    args[0] = args[0].clone().requires_grad_()
    with torch.no_grad():
        require_qk_prep_operands(*args)


@pytest.mark.parametrize("start, prepped", [(0, 2), (1, 1)])
def test_encoder_counts_a_plain_call_per_prepped_layer(start, prepped):
    """A profiled CPU forward of a 2-block any-view encoder counts one
    ``models.qk_prep_plain_calls`` a layer with QK-norm, and the
    benchmark's reader reads 0 % through the kernel."""
    torch.manual_seed(21)
    enc = ViTEncoder(ViTConfig(hidden_size=128, num_layers=2, num_heads=2,
                               pos_embed_size=4, out_layers=(0, 1),
                               anyview_start=start)).eval()
    x = torch.randn(2, 28, 42, 3)
    profiling.reset_counters()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]), \
                torch.no_grad():
            enc(x)
        got = profiling.counters()
        assert got.get("models.qk_prep_plain_calls") == prepped
        assert "models.qk_prep_kernel_calls" not in got
        assert READER(TRACED) == 0.0
    finally:
        profiling.reset_counters()


@pytest.mark.parametrize("counts, share", [
    ({}, None), ({"models.qk_prep_kernel_calls": 16}, 100.0),
    ({"models.qk_prep_kernel_calls": 3, "models.qk_prep_plain_calls": 1},
     75.0)])
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


# (views, tokens, heads, grid): DA3's 16-view step, an odd B x S, five heads
# and a ragged last block
CARD_SHAPES = [(16, 2443, 16, (37, 66)), (3, 1001, 16, (40, 25)),
               (2, 37, 5, (6, 6))]


@pytest.mark.chip
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_kernel_matches_plain_on_the_card(smoke, shape):
    """In place on a qkv that lies inside a larger buffer: the memory on
    both sides stays as it was, v stays bit-equal, at least 99 % of q and k
    are bit-equal to the plain version and every value lies within one
    bf16 ulp of the rotation's terms (``chip_smoke.compare_qk_prep``; where
    x cos and rot(x) sin cancel, the value's own ulp is far smaller than
    either term's rounding); a second launch gives the same bits."""
    from txr_torch import _cuda

    b, s, heads, grid = shape
    gen = torch.Generator(device="cuda").manual_seed(2 ** 31 + s)
    src, *rest = smoke.qk_prep_operands(b, s, heads, grid, gen)
    n = src.numel()
    buf = torch.randn(n + 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    buf[32:32 + n] = src.view(-1)
    before = buf.clone()
    qkv = buf[32:32 + n].view(src.shape)
    with torch.no_grad():
        want = qk_prep_plain(src, *rest)
        launches = _cuda.launches["qk_prep"]
        got = qk_prep(qkv, *rest)
        torch.cuda.synchronize()
        assert got is qkv and _cuda.launches["qk_prep"] == launches + 1
        assert torch.equal(buf[:32], before[:32])
        assert torch.equal(buf[32 + n:], before[32 + n:])
        line = smoke.compare_qk_prep(str(shape), got, want, src, *rest)
        assert line["ok"]
        again = src.clone()
        qk_prep(again, *rest)
    assert torch.equal(again, got)
