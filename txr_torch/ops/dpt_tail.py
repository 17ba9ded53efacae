"""Fused DPT output-head tail: Hopper kernel + plain PyTorch version.
Counterpart of ``txr/ops/dpt_tail.py``.

The head ends with

    y = conv1(y)                                   # (B, Hin, Win, C)
    y = resize_bilinear(y, H, W, align_corners=True)
    y = conv2_3x3(y); y = relu(y); y = conv3_1x1(y)   # -> (B, H, W)

and run as separate ops the resized activation (B, H, W, C) goes through
device memory twice. The kernel (``csrc/dpt_tail.cu``) replaces the TPU
kernel ``txr/ops/dpt_tail.py:_tail_kernel`` and computes the whole tail per
output tile: it is bound by conv2's operations on this card once that tensor
stays on chip, so each block lerps its tile-plus-halo of the upsampled image
into shared memory and runs conv2 there on the bf16 tensor cores. The
lerps are direct, so every resize ratio takes the same path and the wrapper
has no shape fallback (``txr``'s row window and its ``_window_covers`` guard
are TPU-shaped and are not carried over).

``fused_head_tail`` takes the plain version only for a tensor that lies on
the CPU. For a CUDA tensor it launches the kernel or raises. Its gradient
differentiates the plain version, as ``txr/models/dpt.py:_tail_fused`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from txr_torch import _cuda
from txr_torch.ops.resize import resize_bilinear

_KERNEL_FEATURES = 32                  # conv2 output width the kernel is built for
_MAX_SHARED = 227 * 1024               # shared memory one block may use


def head_tail_reference(x: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        w3: torch.Tensor, b3: torch.Tensor, out_h: int,
                        out_w: int) -> torch.Tensor:
    """Plain PyTorch version: resize -> conv2 -> relu -> conv3.

    x: (B, Hin, Win, C); w2: (3, 3, C, F); b2: (F,); w3: (1, 1, F, 1) or
    (F,); b3: (1,). Returns (B, out_h, out_w) in x's dtype.
    """
    dt = x.dtype
    y = resize_bilinear(x, out_h, out_w, align_corners=True)
    y = F.conv2d(y.permute(0, 3, 1, 2), w2.to(dt).permute(3, 2, 0, 1),
                 b2.to(dt), padding=1)
    y = F.relu(y)
    f = w3.reshape(1, -1, 1, 1).to(dt)
    out = F.conv2d(y, f)[:, 0]
    return (out + b3.reshape(-1)[0].to(dt)).to(dt)


def _launch(x, w2, b2, w3, b3, out_h: int, out_w: int) -> torch.Tensor:
    b, hin, win, c = x.shape
    feat = w2.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the DPT tail kernel takes bfloat16, got {x.dtype}")
    if feat != _KERNEL_FEATURES:
        raise ValueError(
            f"the DPT tail kernel is built for {_KERNEL_FEATURES} conv2 "
            f"features, got {feat}")
    if c % 16:
        raise ValueError(
            f"the DPT tail kernel needs a channel count that is a multiple "
            f"of 16, got {c}")
    if (9 * feat + 3 * 34) * (c + 8) * 2 > _MAX_SHARED:
        raise ValueError(
            f"{c} channels do not fit the DPT tail kernel's shared memory")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            "the DPT tail kernel needs a contiguous, 16-byte aligned NHWC x")
    if b > 65535:
        raise ValueError("batch must be below 65536")
    dev = x.device
    # (3, 3, C, F) -> (tap, feature, channel): the B operand of the kernel's
    # products wants consecutive channels side by side
    w2t = w2.to(device=dev, dtype=torch.bfloat16).permute(0, 1, 3, 2)
    w2t = w2t.contiguous()
    b2f = b2.to(device=dev, dtype=torch.float32).contiguous()
    w3f = w3.to(device=dev, dtype=torch.float32).reshape(-1)[:feat].contiguous()
    b3f = b3.to(device=dev, dtype=torch.float32).reshape(-1)[:1].contiguous()
    out = torch.empty((b, out_h, out_w), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().txr_dpt_tail_fwd(
            x.data_ptr(), w2t.data_ptr(), b2f.data_ptr(), w3f.data_ptr(),
            b3f.data_ptr(), out.data_ptr(), b, hin, win, c, out_h, out_w,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "dpt_tail")
    _cuda.launches["dpt_tail"] += 1
    return out


class _FusedHeadTail(torch.autograd.Function):
    """Kernel forward; backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, x, w2, b2, w3, b3, out_h, out_w):
        ctx.save_for_backward(x, w2, b2, w3, b3)
        ctx.size = (out_h, out_w)
        if x.device.type == "cpu":
            return head_tail_reference(x, w2, b2, w3, b3, out_h, out_w)
        return _launch(x, w2, b2, w3, b3, out_h, out_w)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            y = head_tail_reference(*leaves, *ctx.size)
            grads = torch.autograd.grad(y, leaves, grad, allow_unused=True)
        return (*grads, None, None)


def fused_head_tail(x: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    w3: torch.Tensor, b3: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Fused resize(align_corners=True) + conv2(3x3, pad 1) + ReLU +
    conv3(1x1) for the DPT output head.

    x: (B, Hin, Win, C) NHWC contiguous conv1 output.
    w2: (3, 3, C, F), b2: (F,), w3: (1, 1, F, 1) or (F,), b3: (1,).
    Returns (B, out_h, out_w) pre-activation depth in x's dtype.
    """
    if x.dim() != 4 or w2.dim() != 4 or w2.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(
            f"expected x (B, Hin, Win, C) and w2 (3, 3, C, F), got "
            f"{tuple(x.shape)} and {tuple(w2.shape)}")
    if out_h < 1 or out_w < 1:
        raise ValueError("output size must be positive")
    return _FusedHeadTail.apply(x, w2, b2, w3, b3, out_h, out_w)
