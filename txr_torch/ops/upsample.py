"""Bilinear resize of a feature map (``F.interpolate``'s ``"bilinear"``
mode, either ``align_corners``): Hopper kernel + plain PyTorch version.

The DPT head's fusion blocks end in it (``models/dpt.py:_bilinear``). The
kernel (``csrc/upsample.cu``) replaces no TPU kernel: ``txr`` writes the
resize as interpolation-matrix products that XLA fuses
(``txr/ops/resize.py``). It is bound by bytes on this card: it reads the
map's NHWC rows 16 bytes at a time and writes each output chunk of 8 bf16
(4 float32) channels with one store, where PyTorch's channels-last kernel
spends a thread, four integer divisions and four 2-byte loads on each
output value. It computes PyTorch's interpolation with the FMAs PyTorch's
build contracts it into for the dtype it computes in, so its result is
``F.interpolate``'s bit for bit (``chip_smoke.py`` reports the share).

:func:`upsample_bilinear` takes the plain version
(:func:`upsample_bilinear_plain`) only for tensors that lie on the CPU. For
CUDA tensors it launches the kernel, or raises
(:func:`require_upsample_operands`); where autograd records, through
:class:`_Upsample`, whose backward differentiates the plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from txr_torch import _cuda

# The kernel's geometry (csrc/upsample.cu; ``chip_smoke.py`` checks that
# the built library reports the same numbers)
THREADS = 256
SEGMENT_CHUNKS = 2048          # chunks of a row a block takes, about
MAX_CHUNK_BYTES = 16           # the widest input load

# the kernel's dtypes bits: which operands are float32 (else bf16)
IN_F32, OUT_F32 = 1, 2
_BF, _F = torch.bfloat16, torch.float32
_INT_MAX = 2 ** 31 - 1


def upsample_bilinear_plain(x: torch.Tensor, size: Sequence[int],
                            align_corners: bool) -> torch.Tensor:
    """The plain version: ``F.interpolate(x, size, mode="bilinear")``."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


def require_upsample_operands(x: torch.Tensor, size: Sequence[int],
                              align_corners: bool) -> dict:
    """Raise unless the kernel takes ``x`` and ``size``; return its launch
    (sizes, channels a chunk, the dtypes bits and the output's dtype).
    Pure: reads dtypes, shapes, strides and the address only, so it runs
    on CPU tensors too. The kernel takes a 4-D (N, C, H, W) bf16 or
    float32 tensor in channels_last memory (contiguous NHWC) and any
    output size. Its output has the dtype ``F.interpolate`` gives: x's,
    or float32 under CUDA's autocast, whose policy runs the resize in
    float32."""
    dtype = x.dtype
    if dtype is not _BF and dtype is not _F:
        raise TypeError(f"the upsample kernel takes bf16 or float32 maps, "
                        f"got {dtype}")
    if x.dim() != 4:
        raise ValueError(f"the upsample kernel takes (N, C, H, W) maps, "
                         f"got {tuple(x.shape)}")
    n, c, h, w = x.shape
    ho, wo = size
    if min(n, c, h, w, ho, wo) < 1:
        raise ValueError(f"empty map or size: {tuple(x.shape)} to "
                         f"{(ho, wo)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("the upsample kernel takes maps in channels_last "
                         "memory (contiguous NHWC)")
    if max(n, h, w) > _INT_MAX or wo * c > _INT_MAX - THREADS:
        raise ValueError(f"{tuple(x.shape)} to {(ho, wo)}: outside the "
                         f"kernel's int32 sizes")
    # the widest chunk that divides the channels and the input's address
    itemsize = 2 if dtype is _BF else 4
    vec = MAX_CHUNK_BYTES // itemsize
    ptr = x.data_ptr()
    while c % vec or ptr % (vec * itemsize):
        vec //= 2
    chunks = wo * (c // vec)
    segments = -(-chunks // SEGMENT_CHUNKS)
    if n * ho * segments > _INT_MAX:
        raise ValueError(f"{tuple(x.shape)} to {(ho, wo)}: more blocks "
                         f"than a grid holds")
    out_dtype = (_F if dtype is _F or torch.is_autocast_enabled("cuda")
                 else _BF)
    return {"n": n, "c": c, "h": h, "w": w, "out_h": ho, "out_w": wo,
            "align_corners": bool(align_corners), "vec": vec,
            "segments": segments, "blocks": n * ho * segments,
            "threads": THREADS,
            "dtypes": (IN_F32 if dtype is _F else 0)
            | (OUT_F32 if out_dtype is _F else 0),
            "out_dtype": out_dtype}


def _launch(x: torch.Tensor, plan: dict) -> torch.Tensor:
    """Allocate the output and launch once, on an operand that
    :func:`require_upsample_operands` planned."""
    out = torch.empty((plan["n"], plan["c"], plan["out_h"], plan["out_w"]),
                      dtype=plan["out_dtype"], device=x.device,
                      memory_format=torch.channels_last)
    dev = x.device.index
    # the current stream's handle without a Stream object: this wrapper's
    # host work is paid four times a DPT branch
    args = (x.data_ptr(), out.data_ptr(), plan["n"], plan["h"], plan["w"],
            plan["c"], plan["out_h"], plan["out_w"], plan["align_corners"],
            plan["vec"], plan["dtypes"], torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch._C._cuda_getDevice():
        err = _cuda.lib().txr_upsample_bilinear_fwd(*args)
    else:
        with torch.cuda.device(dev):
            err = _cuda.lib().txr_upsample_bilinear_fwd(*args)
    _cuda.check(err, "upsample")
    _cuda.launches["upsample"] += 1
    return out


class _Upsample(torch.autograd.Function):
    """Kernel forward (the plain version on a CPU tensor); backward
    differentiates the plain version under the forward's autocast
    state."""

    @staticmethod
    def forward(ctx, x, size, align_corners, plan):
        ctx.size, ctx.align_corners = tuple(size), align_corners
        ctx.device_type = x.device.type
        ctx.autocast = (torch.is_autocast_enabled(ctx.device_type),
                        torch.get_autocast_dtype(ctx.device_type))
        ctx.save_for_backward(x)
        if ctx.device_type == "cpu":
            return upsample_bilinear_plain(x, size, align_corners)
        return _launch(x, plan)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        enabled, dtype = ctx.autocast
        with torch.enable_grad(), torch.autocast(ctx.device_type, dtype,
                                                 enabled):
            xi = x.detach().requires_grad_()
            out = upsample_bilinear_plain(xi, ctx.size, ctx.align_corners)
            gx, = torch.autograd.grad(out, xi, grad)
        return gx, None, None, None


def upsample_bilinear(x: torch.Tensor, size: Sequence[int],
                      align_corners: bool) -> torch.Tensor:
    """``F.interpolate(x, size, mode="bilinear", align_corners=...)``. A
    CPU tensor takes :func:`upsample_bilinear_plain`; a CUDA tensor the
    kernel, through :class:`_Upsample` where autograd records."""
    if x.device.type == "cpu":
        return upsample_bilinear_plain(x, size, align_corners)
    plan = require_upsample_operands(x, size, align_corners)
    if x.requires_grad and torch.is_grad_enabled():
        return _Upsample.apply(x, size, align_corners, plan)
    return _launch(x, plan)
