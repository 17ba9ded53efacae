"""The ViT block's residual update and the LayerNorm after it: Hopper
kernel + plain PyTorch version.

x' = x + branch * gamma (LayerScale's (d,) ``gamma`` over the tokens) and,
where a LayerNorm follows at once (the block's ``norm2`` after attention),
h = LayerNorm(x') as well. The kernel (``csrc/residual_norm.cu``) replaces
no TPU kernel, because ``txr`` leaves these passes to XLA's fusion. It is
bound by bytes on this card: it reads x and the branch once and writes x'
(and h) once, in one launch, where the plain version
(:func:`residual_norm_plain`) takes three (the product on PyTorch's
unvectorised kernel, for its broadcast operand; the add; the LayerNorm),
each a pass over the residual stream.

The kernel rounds where the plain version's operators round, so x' is
bit-equal to it; h reads x' as rounded and differs from ``nn.LayerNorm``'s
only by the order of its sums (within one ulp of h's dtype).

:func:`residual_norm` takes the plain version only for tensors that lie on
the CPU. For CUDA tensors it launches the kernel, or raises
(:func:`require_residual_norm_operands`); where autograd records, through
:class:`_ResidualNorm`, whose backward differentiates the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from txr_torch import _cuda

# The kernel's geometry (csrc/residual_norm.cu; ``chip_smoke.py`` checks
# that the built library reports the same numbers).
THREADS = 128
ROWS_PER_BLOCK = 4          # a warp a row
VEC = 8                     # values a chunk: the width is a multiple of it
MAX_WIDTH = 2048
ALIGN = 16                  # bytes: every operand is read 16 bytes at a time

# the kernel's dtypes bits: which operands are float32 (else bf16)
X_F32, BRANCH_F32, PARAMS_F32, H_F32 = 1, 2, 4, 8
# (x, branch, gamma and the norm's parameters) the kernel takes: a bf16
# model, a float32 model, and bf16 autocast's mixes (the branch from a
# bf16 product, f32 master parameters, x bf16 at the first block)
_BF, _F = torch.bfloat16, torch.float32
OPERAND_DTYPES = ((_BF, _BF, _BF), (_F, _F, _F), (_BF, _BF, _F),
                  (_F, _BF, _F))

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def residual_norm_plain(x: torch.Tensor, branch: torch.Tensor,
                        gamma: torch.Tensor,
                        norm: Optional[nn.LayerNorm] = None) -> Result:
    """The plain version: x' = x + branch * gamma, and (x', norm(x'))
    where a norm is given."""
    out = x + branch * gamma
    return out if norm is None else (out, norm(out))


def require_residual_norm_operands(x: torch.Tensor, branch: torch.Tensor,
                                   gamma: torch.Tensor,
                                   norm: Optional[nn.LayerNorm] = None
                                   ) -> dict:
    """Raise unless the kernel takes these operands; return its launch
    (rows, width, blocks, threads, dtypes bits, x''s and h's dtypes). Pure:
    reads dtypes, shapes, strides and addresses only, so it runs on CPU
    tensors too. The kernel takes contiguous x and branch of one shape
    (..., d), d a multiple of 8 up to 2048; a contiguous (d,) gamma; a
    ``nn.LayerNorm`` over d with weight and bias of gamma's dtype; dtypes
    among ``OPERAND_DTYPES``; every operand 16-byte aligned on x's
    device."""
    if norm is None:
        return _plan(x, branch, gamma, None, None)
    if (norm.weight is None or norm.bias is None
            or tuple(norm.normalized_shape) != x.shape[-1:]):
        raise ValueError(f"the residual_norm kernel takes a LayerNorm over "
                         f"x's last dimension with weight and bias")
    return _plan(x, branch, gamma, norm.weight, norm.bias)


def _plan(x, branch, gamma, weight, bias) -> dict:
    # checked in the order that costs least on the host: the launch is
    # planned at every residual update, two a block
    dtypes = (x.dtype, branch.dtype, gamma.dtype)
    if dtypes not in OPERAND_DTYPES:
        raise TypeError(f"the residual_norm kernel takes x, branch and gamma "
                        f"of dtypes {OPERAND_DTYPES}, got {dtypes}")
    shape = x.shape
    if branch.shape != shape or not shape:
        raise ValueError(f"x {tuple(shape)} and branch "
                         f"{tuple(branch.shape)} must have one shape")
    width = shape[-1]
    if width % VEC or not VEC <= width <= MAX_WIDTH:
        raise ValueError(f"the residual_norm kernel takes widths that are "
                         f"multiples of {VEC} up to {MAX_WIDTH}, got {width}")
    if not (x.is_contiguous() and branch.is_contiguous()):
        raise ValueError("the residual_norm kernel needs contiguous x and "
                         "branch")
    params = (gamma,) if weight is None else (gamma, weight, bias)
    for t in params:
        if t.dtype != gamma.dtype or t.shape != (width,) \
                or not t.is_contiguous():
            raise ValueError(f"gamma and the norm's weight and bias must be "
                             f"contiguous ({width},) tensors of gamma's "
                             f"dtype {gamma.dtype}")
    rows = x.numel() // width
    if rows > 2 ** 31 - 1 - ROWS_PER_BLOCK:
        raise ValueError(f"{rows} rows: outside the kernel's int32 row "
                         f"index")
    device = x.device
    if any(t.device != device for t in (branch, *params)):
        raise ValueError(f"the operands lie on more than one device")
    ptrs = 0
    for t in (x, branch, *params):
        ptrs |= t.data_ptr()
    if ptrs % ALIGN:
        raise ValueError(f"an operand is not {ALIGN}-byte aligned")
    out_dtype = _BF if dtypes == (_BF, _BF, _BF) else _F
    # h as the plain version gives it: CUDA's autocast runs the LayerNorm
    # in float32 (the CPU's leaves a bf16 one in bf16)
    h_dtype = (_F if weight is not None and device.type == "cuda"
               and torch.is_autocast_enabled("cuda") else out_dtype)
    bits = ((X_F32 if dtypes[0] == _F else 0)
            | (BRANCH_F32 if dtypes[1] == _F else 0)
            | (PARAMS_F32 if dtypes[2] == _F else 0)
            | (H_F32 if h_dtype == _F else 0))
    return {"rows": rows, "width": width,
            "blocks": -(-rows // ROWS_PER_BLOCK), "threads": THREADS,
            "dtypes": bits, "out_dtype": out_dtype, "h_dtype": h_dtype}


def _launch(x, branch, gamma, weight, bias, eps: float, plan: dict
            ) -> Result:
    """Allocate the outputs and launch once, on operands that
    :func:`require_residual_norm_operands` planned."""
    out = torch.empty(x.shape, dtype=plan["out_dtype"], device=x.device)
    h = (None if weight is None else
         torch.empty(x.shape, dtype=plan["h_dtype"], device=x.device))
    with torch.cuda.device(x.device):
        err = _cuda.lib().txr_residual_norm_fwd(
            x.data_ptr(), branch.data_ptr(), gamma.data_ptr(),
            None if h is None else weight.data_ptr(),
            None if h is None else bias.data_ptr(),
            out.data_ptr(), None if h is None else h.data_ptr(),
            plan["rows"], plan["width"], plan["dtypes"], eps,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "residual_norm")
    _cuda.launches["residual_norm"] += 1
    return out if h is None else (out, h)


def _plain(x, branch, gamma, weight, bias, eps: float) -> Result:
    """:func:`residual_norm_plain` on the norm's parameters."""
    out = x + branch * gamma
    if weight is None:
        return out
    return out, F.layer_norm(out, out.shape[-1:], weight, bias, eps)


class _ResidualNorm(torch.autograd.Function):
    """Kernel forward (the plain version on a CPU tensor); backward
    differentiates the plain version under the forward's autocast state."""

    @staticmethod
    def forward(ctx, x, branch, gamma, weight, bias, eps, plan):
        ctx.eps = eps
        ctx.device_type = x.device.type
        ctx.autocast = (torch.is_autocast_enabled(ctx.device_type),
                        torch.get_autocast_dtype(ctx.device_type))
        ctx.save_for_backward(x, branch, gamma, weight, bias)
        if ctx.device_type == "cpu":
            return _plain(x, branch, gamma, weight, bias, eps)
        return _launch(x, branch, gamma, weight, bias, eps, plan)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        enabled, dtype = ctx.autocast
        with torch.enable_grad(), torch.autocast(ctx.device_type, dtype,
                                                 enabled):
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(saved, ctx.needs_input_grad)]
            outs = _plain(*ins, ctx.eps)
            outs = outs if isinstance(outs, tuple) else (outs,)
            wrt = [t for t in ins if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(outs, wrt, grads,
                                           allow_unused=True))
        return (*[next(got) if t is not None and t.requires_grad else None
                  for t in ins], None, None)


def residual_norm(x: torch.Tensor, branch: torch.Tensor,
                  gamma: torch.Tensor,
                  norm: Optional[nn.LayerNorm] = None) -> Result:
    """x' = x + branch * gamma, or (x', norm(x')) where ``norm`` is given.
    A CPU tensor takes :func:`residual_norm_plain`; a CUDA tensor the
    kernel, through :class:`_ResidualNorm` where autograd records."""
    if x.device.type == "cpu":
        return residual_norm_plain(x, branch, gamma, norm)
    plan = require_residual_norm_operands(x, branch, gamma, norm)
    weight, bias, eps = ((None, None, 0.0) if norm is None
                         else (norm.weight, norm.bias, norm.eps))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, branch, gamma, weight, bias)):
        return _ResidualNorm.apply(x, branch, gamma, weight, bias, eps, plan)
    return _launch(x, branch, gamma, weight, bias, eps, plan)
