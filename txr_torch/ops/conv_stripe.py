"""3x3 convolution (NHWC, zero pad 1, optional input ReLU): Hopper kernel +
plain PyTorch version. Counterpart of ``txr/ops/conv_stripe.py``.

Used for the DPT head's residual conv units on the large maps and for the
output head's conv1 (``txr_torch/models/dpt.py``) when ``fused_convs`` is
on. The kernel (``csrc/conv3x3.cu``) replaces the TPU kernel
``txr/ops/conv_stripe.py:_conv3_kernel``. It is bound by operations on this
card, so it is an implicit matrix product on the bf16 tensor cores
(``wgmma``): a 16 x 16 pixel tile by 128 features per block, the halo patch
and the weights brought in by TMA in chunks of 64 channels and by tap, zero
padding and ragged edges both served by the zero fill of a box that reaches
outside its tensor (:func:`kernel_geometry` has the arithmetic). ``txr``'s
flat stripes, its two row-block refs and its (3, C, 3F) packed weight are
answers to the TPU's memory tiling and are not carried over; the name is
kept so that a reader finds the counterpart.

The kernel takes bf16, C and F multiples of 8, and the weight repacked as
(9, F, C) (tap, feature, channel); ``pack_weight`` makes that from HWIO.

``conv3x3_stripe`` takes the plain version only for a tensor that lies on
the CPU. For a CUDA tensor it launches the kernel or raises. Its gradient
differentiates the plain version, as ``txr/models/dpt.py:_conv3x3_fused``
does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from txr_torch import _cuda


# The kernel's tiling (csrc/conv3x3.cu; ``chip_smoke.py`` checks that the
# built library reports the same numbers).
TILE_H = 16
TILE_W = 16
BLOCK_F = 128        # features per block
CHUNK_C = 64         # channels per shared-memory chunk (128-byte rows)
W_SLOTS = 4          # weight slices in flight
MAX_SMEM_BYTES = 232448      # what one block may use on an H100


def kernel_geometry(batch: int, h: int, w: int, c: int, feat: int) -> dict:
    """Grid, depth steps, TMA boxes and shared-memory bytes of one launch
    (pure; the kernel's own arithmetic, kept here so that it can be tested
    without the card)."""
    patch_rows = (TILE_H + 2) * (TILE_W + 2)
    patch_bytes = -(-patch_rows * CHUNK_C * 2 // 1024) * 1024
    nfb = -(-feat // BLOCK_F)
    grid = (-(-w // TILE_W), -(-h // TILE_H), batch * nfb)
    return {"grid": grid, "feature_blocks": nfb,
            "chunks": -(-c // CHUNK_C), "depth_steps": -(-c // CHUNK_C) * 9,
            # innermost first: x seen as (C, W, H, B), the weight as (C, F, 9)
            "patch_box": (CHUNK_C, TILE_W + 2, TILE_H + 2, 1),
            "weight_box": (CHUNK_C, BLOCK_F, 1),
            "smem_bytes": 1024 + 2 * patch_bytes
            + W_SLOTS * BLOCK_F * CHUNK_C * 2 + 64 * 8,
            "stored_share": (h * w) / (grid[0] * TILE_W * grid[1] * TILE_H)}


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu_in: bool = False) -> torch.Tensor:
    """Plain PyTorch version with identical semantics.

    x: (B, H, W, C); w: (3, 3, C, F) HWIO; b: (F,). Returns (B, H, W, F) in
    x's dtype.
    """
    y = F.relu(x) if relu_in else x
    out = F.conv2d(y.permute(0, 3, 1, 2), w.to(y.dtype).permute(3, 2, 0, 1),
                   b.to(y.dtype), padding=1)
    return out.permute(0, 2, 3, 1)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, C, F) -> the kernel's (9, F, C) bf16, channels contiguous
    (the operand layout its products read)."""
    c, f = w.shape[2], w.shape[3]
    return w.to(torch.bfloat16).permute(0, 1, 3, 2).reshape(9, f, c
                                                            ).contiguous()


def _launch(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
            relu_in: bool) -> torch.Tensor:
    bsz, h, w_, c = x.shape
    feat = wp.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the 3x3 conv kernel takes bfloat16, got {x.dtype}")
    if c % 8 or feat % 8:
        raise ValueError(
            f"the 3x3 conv kernel needs channel and feature counts that are "
            f"multiples of 8, got C={c}, F={feat}")
    if wp.shape != (9, feat, c) or wp.dtype != torch.bfloat16:
        raise ValueError(
            f"packed weight must be (9, {feat}, {c}) bfloat16, got "
            f"{tuple(wp.shape)} {wp.dtype}")
    grid = kernel_geometry(bsz, h, w_, c, feat)["grid"]
    if grid[2] > 65535 or grid[1] > 65535:
        raise ValueError("batch x feature blocks and H / 16 must each be "
                         "below 65536")
    dev = x.device
    bias = b.to(device=dev, dtype=torch.float32).contiguous()
    for name, ten in (("x", x), ("the packed weight", wp)):
        if (ten.device != dev or not ten.is_contiguous()
                or ten.data_ptr() % 16):
            raise ValueError(
                f"the 3x3 conv kernel needs {name} contiguous, 16-byte "
                f"aligned and on {dev}")
    out = torch.empty((bsz, h, w_, feat), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _cuda.lib().txr_conv3x3_fwd(
            x.data_ptr(), wp.data_ptr(), bias.data_ptr(), out.data_ptr(),
            bsz, h, w_, c, feat, int(bool(relu_in)),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "conv3x3")
    _cuda.launches["conv3x3"] += 1
    return out


class _Conv3x3Stripe(torch.autograd.Function):
    """Kernel forward; backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, x, w, b, relu_in, packed):
        ctx.save_for_backward(x, w, b)
        ctx.relu_in = relu_in
        if x.device.type == "cpu":
            return conv3x3_reference(x, w, b, relu_in)
        wp = pack_weight(w) if packed is None else packed
        return _launch(x.contiguous(), wp, b, relu_in)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            y = conv3x3_reference(*leaves, ctx.relu_in)
            grads = torch.autograd.grad(y, leaves, grad, allow_unused=True)
        return (*grads, None, None)


def conv3x3_stripe(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   relu_in: bool = False,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 'same' conv (zero pad 1), NHWC; optionally ReLU the input first
    (the DPT residual conv unit's pre-activation).

    x: (B, H, W, C); w: (3, 3, C, F) HWIO; b: (F,). Returns (B, H, W, F) in
    x's dtype (f32 accumulation inside). ``packed`` may carry
    ``pack_weight(w)`` made earlier, which saves the repack on a CUDA call.
    """
    if (x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[3])
            or b.shape != (w.shape[3],)):
        raise ValueError(
            f"expected x (B, H, W, C), w (3, 3, C, F) and b (F,), got "
            f"{tuple(x.shape)}, {tuple(w.shape)} and {tuple(b.shape)}")
    return _Conv3x3Stripe.apply(x, w, b, relu_in, packed)
