"""The attention kernel's exponentials (``txr_torch/csrc/attention.cu``:
``exp2_mufu``), on the CPU.

The kernel runs only on the card. What can be held here: every exponential
of the kernel is ``ex2.approx.ftz.f32`` on its own, never ``exp2f`` (which,
built without ``-ftz``, wraps each MUFU.EX2 in a compare and two predicated
multiplies for results below 2^-126); the build flags stay without a global
``-ftz`` or fast math, so no other kernel's arithmetic moves; and what the
flush changes, the probabilities below 2^-126 of their row's max becoming
0, leaves the kernel's result bit for bit as it was, taken through the
kernel's own steps (f32 probabilities, their f32 sum, the probabilities
rounded to bf16 for p v, one rounding of the result).
"""

import re
from pathlib import Path

import pytest
import torch

from txr_torch import _cuda
from txr_torch.ops import attention

SOURCE = Path(attention.__file__).resolve().parents[1] / "csrc" / \
    "attention.cu"


def code_of(path: Path) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_every_exponential_is_the_mufu_without_the_fixup():
    code = code_of(SOURCE)
    assert re.findall(r"asm\(\"(ex2[.a-z0-9]*) ", code) == [
        "ex2.approx.ftz.f32"]
    for call in ("exp2f", "expf", "__expf", "exp2", "__exp2f", "exp"):
        assert not re.search(rf"\b{call}\s*\(", code), call
    # the helper, then four boundmax, two rescale factors and four f32max
    # exponentials
    assert len(re.findall(r"\bexp2_mufu\(", code)) == 1 + 10


def test_build_flags_change_no_other_kernels_arithmetic():
    flags = " ".join(_cuda.NVCC_FLAGS)
    for flag in ("ftz", "fast_math", "prec-div", "prec-sqrt", "fmad=false"):
        assert flag not in flags


def kernel_steps(q, k, v, flush: bool):
    """``f32max`` as the kernel computes it, in one tile: p = 2^(s c - max
    c) in f32, their f32 sum, p rounded to bf16 for p v with f32 sums, one
    rounding of the result; with ``flush``, p below 2^-126 is 0."""
    c = q.shape[-1] ** -0.5 * 1.4426950408889634
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.exp2(s * c - s.amax(-1, keepdim=True) * c)
    if flush:
        p = torch.where(p < 2.0 ** -126, torch.zeros_like(p), p)
    acc = torch.matmul(p.to(torch.bfloat16).float(), v.float())
    return (acc / p.sum(-1, keepdim=True)).to(torch.bfloat16), p


@pytest.mark.parametrize("q_std", [30.0, 60.0])
def test_flushed_probabilities_leave_the_result_bit_for_bit(q_std):
    """Scaled logits of std 30 and 60 put many keys more than 126 binary
    orders below their row's max, where the f32 probabilities are denormal
    (non-zero) without the flush. The results agree bit for bit."""
    g = torch.Generator().manual_seed(25)
    shape = (2, 4, 512, 64)
    q = (torch.randn(shape, generator=g) * q_std).to(torch.bfloat16)
    k = torch.randn(shape, generator=g).to(torch.bfloat16)
    v = torch.randn(shape, generator=g).to(torch.bfloat16)
    kept, p = kernel_steps(q, k, v, flush=False)
    flushed, _ = kernel_steps(q, k, v, flush=True)
    assert ((p > 0) & (p < 2.0 ** -126)).sum().item() > 1000
    assert torch.equal(kept, flushed)
