"""Softmax attention, on the fused qkv projection and on separate
(B, H, S, D) operands: Hopper kernel + plain PyTorch versions. Counterpart
of ``txr/ops/attention.py``.

The kernel (``csrc/attention.cu``) replaces the TPU kernels
``txr/ops/attention.py:_fused_kernel_1pass`` (full keys), ``:_fused_kernel``
(``kv_len < S``) and, through its second entry point, ``:_flash_kernel``
(q, k, v of shape (B, H, S, D), ``attention_flash`` here). The kernel
addresses each operand by base pointer and strides, so ``attention_flash``
takes the non-contiguous head views a ViT slices from its fused projection
without copying them. It is bound by operations on this card
(4*B*H*S^2*D flop against about 12*B*S*H*D bytes), so it runs both products
as ``wgmma`` on the bf16 tensor cores: a block of three consumer warpgroups
owns 192 query rows, a producer thread streams 128-key tiles by TMA through
a ring of shared-memory stages, and an online softmax masks the ragged last
tile against ``kv_len``; see the source for the layout. Each operand reaches
the kernel as a tensor map, which is why its strides must be multiples of 16
bytes (:func:`tma_operand_strides`). What is TPU-shaped in ``txr`` (two
heads per program, whole-K residency, zero padding of S with a pad-mass
correction) is not carried over.

Contract (identical to ``txr``): qkv is ``(B, S, 3*H*D)`` component-major,
so head ``h`` has q, k, v at columns ``h*D``, ``H*D + h*D`` and
``2*H*D + h*D``; the result is ``(B, S, H*D)``. Scores and softmax
statistics are f32, the probabilities are rounded to v's dtype before the PV
product, accumulation is f32.

``fused_attention`` and ``attention_flash`` take the plain version only for
a tensor that lies on the CPU. For a CUDA tensor they launch the kernel or
raise. Their gradients differentiate the plain versions, as ``txr``'s custom
VJPs do. ``multi_head_attention`` dispatches as ``txr``'s does:
``use_flash=False`` is the plain version everywhere.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from txr_torch import _cuda

_NEG_INF = -1.0e30

# The kernel's tiling (csrc/attention.cu; ``chip_smoke.py`` checks that the
# built library reports the same numbers).
BLOCK_Q = 192        # query rows per block: three warpgroups of 64
BLOCK_K = 128        # keys per tile
STAGES = 3           # K/V tiles in flight
HEAD_DIM = 64
MAX_SMEM_BYTES = 232448      # what one block may use on an H100


def kernel_geometry(batch: int, heads: int, s: int, kv_len: int) -> dict:
    """Grid, key tiles and shared-memory bytes of one launch (pure; the
    kernel's own arithmetic, kept here so that it can be tested without the
    card)."""
    tile = BLOCK_K * HEAD_DIM * 2
    smem = 1024 + BLOCK_Q * HEAD_DIM * 2 + 2 * STAGES * tile + 64 * 8
    return {"grid": (-(-s // BLOCK_Q), heads, batch),
            "key_tiles": -(-kv_len // BLOCK_K),
            "masked_keys_in_last_tile": -(-kv_len // BLOCK_K) * BLOCK_K
            - kv_len,
            "smem_bytes": smem, "threads": 512}


def tma_operand_strides(name: str, shape, stride, data_ptr: int) -> tuple:
    """The (batch, head, row) element strides a tensor map can be built
    from, for a (B, H, S, 64) bf16 operand, or ``ValueError``.

    A tensor map needs a 16-byte aligned base, rows of 64 contiguous values
    and every other stride a non-zero multiple of 16 bytes below 2^40. The
    stride of a dimension of size 1 is never used and is replaced by a valid
    one. Nothing is copied: what a map cannot describe is refused."""
    if len(shape) != 4 or shape[3] != HEAD_DIM:
        raise ValueError(
            f"the attention kernel is built for head_dim {HEAD_DIM}, got "
            f"{name} of shape {tuple(shape)}")
    if stride[3] != 1 or data_ptr % 16:
        raise ValueError(
            f"the attention kernel needs rows of {name} contiguous and "
            f"16-byte aligned (last stride 1), got strides {tuple(stride)}")
    out = []
    for size, st in zip(shape[:3], stride[:3]):
        if size == 1:
            st = HEAD_DIM                  # unused by any address
        if st <= 0 or st % 8 or st * 2 >= 1 << 40:
            raise ValueError(
                f"the attention kernel reads {name} through a tensor map, "
                f"whose strides must be non-zero multiples of 8 elements "
                f"(16 bytes) below 2^40 bytes, got strides {tuple(stride)}")
        out.append(st)
    return tuple(out)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch attention (``txr``'s ``attention_xla``). q, k, v:
    (B, H, S, D). Returns (B, H, S, D)."""
    d = q.shape[-1]
    s = k.shape[2]
    # f32 products of the stored values: exact for bf16 operands, so this is
    # the f32-accumulated product the kernel computes
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * (d ** -0.5)
    if kv_len is not None and kv_len < s:
        kidx = torch.arange(s, device=q.device)
        logits = torch.where(kidx < kv_len, logits,
                             torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def split_heads(qkv: torch.Tensor, num_heads: int, head_dim: int):
    """(B, S, 3*H*D) component-major -> q, k, v views of shape (B, H, S, D)
    (no copy: each is a strided slice of ``qkv``)."""
    b, s, _ = qkv.shape
    parts = qkv.reshape(b, s, 3, num_heads, head_dim)
    return tuple(parts[:, :, i].transpose(1, 2) for i in range(3))


def attention_reference(qkv: torch.Tensor, num_heads: int, head_dim: int,
                        kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version with the fused kernel's exact contract."""
    b, s, c = qkv.shape
    h, d = num_heads, head_dim
    if c != 3 * h * d:
        raise ValueError(f"qkv has {c} columns, expected 3*{h}*{d}")
    o = attention_plain(*split_heads(qkv, h, d), kv_len)
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


def _check_bhsd(q, k, v, kv_len) -> None:
    if not (q.dim() == 4 and q.shape == k.shape == v.shape):
        raise ValueError(
            f"q, k, v must share one (B, H, S, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if kv_len is not None and not 1 <= kv_len <= k.shape[2]:
        raise ValueError(f"kv_len {kv_len} outside [1, {k.shape[2]}]")


def _launch_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: int) -> torch.Tensor:
    b, h, s, d = q.shape
    for name, ten in (("q", q), ("k", k), ("v", v)):
        if ten.dtype != torch.bfloat16:
            raise TypeError(
                f"the attention kernel takes bfloat16, got {ten.dtype} "
                f"for {name}")
        if ten.device != q.device:
            raise ValueError("q, k and v must lie on one device")
    in_strides = [st for name, ten in (("q", q), ("k", k), ("v", v))
                  for st in tma_operand_strides(name, ten.shape, ten.stride(),
                                                ten.data_ptr())]
    if b > 65535 or h > 65535:
        raise ValueError("batch and head count must each be below 65536")
    # stored as (B, S, H, D) and returned as its (B, H, S, D) view: the
    # caller's transpose back to (B, S, H*D) is then free
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device
                      ).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(*in_strides, *out.stride()[:3])
    with torch.cuda.device(q.device):
        err = _cuda.lib().txr_attention_bhsd_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            s, kv_len, d ** -0.5, strides,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "attention_bhsd")
    _cuda.launches["attention_bhsd"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.kv_len = kv_len
        if q.device.type == "cpu":
            return attention_plain(q, k, v, kv_len)
        return _launch_bhsd(q, k, v, k.shape[2] if kv_len is None else kv_len)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            y = attention_plain(*leaves, ctx.kv_len)
            grads = torch.autograd.grad(y, leaves, grad)
        return (*grads, None)


def attention_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on q, k, v of shape (B, H, S, D), keys at
    positions >= ``kv_len`` ignored. The operands may be strided views as
    long as each row of D values is contiguous. Returns (B, H, S, D); on a
    CUDA tensor the result is a view of (B, S, H, D) storage."""
    _check_bhsd(q, k, v, kv_len)
    return _FlashAttention.apply(q, k, v, kv_len)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Optional[int] = None,
                         use_flash: Optional[bool] = None) -> torch.Tensor:
    """Dispatch as ``txr``'s: ``use_flash`` True or None is
    :func:`attention_flash` (the kernel on a CUDA tensor, the plain version
    on a CPU tensor); False is the plain version everywhere."""
    if use_flash is False:
        _check_bhsd(q, k, v, kv_len)
        return attention_plain(q, k, v, kv_len)
    return attention_flash(q, k, v, kv_len)
