"""Softmax attention on the fused qkv projection: Hopper kernel + plain
PyTorch version. Counterpart of ``txr/ops/attention.py``.

The kernel (``csrc/attention.cu``) replaces the TPU kernels
``txr/ops/attention.py:_fused_kernel_1pass`` (full keys) and
``:_fused_kernel`` (``kv_len < S``). It is bound by operations on this card
(4*B*H*S^2*D flop against about 12*B*S*H*D bytes), so it runs both products
on the bf16 tensor cores and streams 64-key tiles through an online softmax,
masking the ragged last tile against ``kv_len``; see the source for the
layout. What is TPU-shaped in ``txr`` (two heads per program, whole-K
residency, zero padding of S with a pad-mass correction) is not carried
over.

Contract (identical to ``txr``): qkv is ``(B, S, 3*H*D)`` component-major,
so head ``h`` has q, k, v at columns ``h*D``, ``H*D + h*D`` and
``2*H*D + h*D``; the result is ``(B, S, H*D)``. Scores and softmax
statistics are f32, the probabilities are rounded to v's dtype before the PV
product, accumulation is f32.

``fused_attention`` takes the plain version only for a tensor that lies on
the CPU. For a CUDA tensor it launches the kernel or raises. Its gradient
differentiates the plain version, as ``txr``'s custom VJP does.
"""

from __future__ import annotations

from typing import Optional

import torch

from txr_torch import _cuda

_NEG_INF = -1.0e30


def attention_reference(qkv: torch.Tensor, num_heads: int, head_dim: int,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's exact contract."""
    b, s, c = qkv.shape
    h, d = num_heads, head_dim
    if c != 3 * h * d:
        raise ValueError(f"qkv has {c} columns, expected 3*{h}*{d}")
    parts = qkv.reshape(b, s, 3, h, d)
    q, k, v = (parts[:, :, i].transpose(1, 2) for i in range(3))  # (B,H,S,D)
    # f32 products of the stored values: exact for bf16 operands, so this is
    # the f32-accumulated product the kernel computes
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * (d ** -0.5)
    if kv_len is not None and kv_len < s:
        kidx = torch.arange(s, device=qkv.device)
        logits = torch.where(kidx < kv_len, logits,
                             torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs.float(), v.float()).to(qkv.dtype)
    return o.transpose(1, 2).reshape(b, s, h * d)


def _launch(qkv: torch.Tensor, num_heads: int, head_dim: int,
            kv_len: int) -> torch.Tensor:
    b, s, c = qkv.shape
    if qkv.dtype != torch.bfloat16:
        raise TypeError(
            f"the attention kernel takes bfloat16, got {qkv.dtype}")
    if head_dim != 64:
        raise ValueError(
            f"the attention kernel is built for head_dim 64, got {head_dim}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(
            "the attention kernel needs a contiguous, 16-byte aligned qkv")
    if b > 65535 or num_heads > 65535:
        raise ValueError("batch and head count must each be below 65536")
    out = torch.empty((b, s, num_heads * head_dim), dtype=qkv.dtype,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _cuda.lib().txr_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), b, s, num_heads, kv_len,
            head_dim ** -0.5, torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "attention")
    _cuda.launches["attention"] += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """Kernel forward; backward differentiates the plain version (``txr``
    has no backward kernel either)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim, kv_len):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, head_dim, kv_len)
        if qkv.device.type == "cpu":
            return attention_reference(qkv, num_heads, head_dim, kv_len)
        return _launch(qkv, num_heads, head_dim,
                       qkv.shape[1] if kv_len is None else kv_len)

    @staticmethod
    def backward(ctx, grad):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            y = attention_reference(x, *ctx.args)
            (gx,) = torch.autograd.grad(y, x, grad)
        return gx, None, None, None


def fused_attention(qkv: torch.Tensor, num_heads: int, head_dim: int,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on (B, S, 3*H*D) -> (B, S, H*D).

    Keys at positions >= ``kv_len`` are ignored (``None``: all S keys).
    """
    if qkv.dim() != 3 or qkv.shape[2] != 3 * num_heads * head_dim:
        raise ValueError(
            f"qkv must be (B, S, 3*{num_heads}*{head_dim}), got "
            f"{tuple(qkv.shape)}")
    if kv_len is not None and not 1 <= kv_len <= qkv.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {qkv.shape[1]}]")
    return _FusedAttention.apply(qkv, num_heads, head_dim, kv_len)
