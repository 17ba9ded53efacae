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

Score modes of the full-key route (``kv_len`` None or S), as ``txr``'s
``_fused_kernel_1pass``: ``"f32max"`` shifts each row by its max;
``"boundmax"`` by the Cauchy-Schwarz bound ``min(|q c| max_k |k|, 60)``
with ``c = scale * log2(e)``, q pre-scaled by c and rounded to the operand
dtype, ``p = 2^min(s - m, 60)`` (see :func:`attention_boundmax_plain`). A
mode of ``None`` is read from ``TXR_ATTN_SCORES`` (default ``"f32max"``) at
every call. ``kv_len < S`` and :func:`attention_flash` have no score mode,
as in ``txr``: they compute ``f32max``.

``fused_attention`` and ``attention_flash`` take the plain version only for
a tensor that lies on the CPU. For a CUDA tensor they launch the kernel or
raise. Their gradients differentiate the plain versions, as ``txr``'s custom
VJPs do. ``multi_head_attention`` dispatches as ``txr``'s does:
``use_flash=False`` is the plain version everywhere.
"""

from __future__ import annotations

import ctypes
import os
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
SCORE_MODES = ("f32max", "boundmax")
_LOG2E = 1.4426950408889634


def default_score_mode() -> str:
    """``TXR_ATTN_SCORES`` (default ``"f32max"``), read at each call as
    ``txr.ops.attention.default_score_mode`` is."""
    return os.environ.get("TXR_ATTN_SCORES", "f32max")


def resolve_score_mode(score_mode: Optional[str]) -> str:
    """``None`` -> the environment's mode; an unknown mode raises."""
    mode = score_mode or default_score_mode()
    if mode not in SCORE_MODES:
        raise ValueError(f"unknown score_mode {mode!r}; expected one of "
                         f"{SCORE_MODES}")
    return mode


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


def key_norm_plain(k: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) keys -> (B, H) f32: the largest key norm of each
    head, ``sqrt(max_k sum_d k^2)`` in f32 as ``txr``'s kernel takes it."""
    kf = k.float()
    return (kf * kf).sum(-1).amax(-1).sqrt()


def attention_boundmax_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Score mode ``"boundmax"`` of ``txr``'s ``_fused_kernel_1pass``
    (``txr/ops/attention.py:217-226``) on (B, H, S, D) operands, all keys.

    The shift of a row is a bound on its scaled logits, not their max, so
    no pass over the scores finds it: ``m = min(|q c| * max_k |k|, 60)``
    with ``c = D^-0.5 * log2(e)``, the scores ``s = round(q c) . k`` in f32
    (q rounded to its dtype after scaling), ``p = 2^min(s - m, 60)``. As in
    ``"f32max"``, the normaliser is the f32 sum of p and the product with v
    takes p rounded to v's dtype (``txr`` sums the rounded p; the two
    normalisers differ by about 2^-9 / sqrt(S) of their value). Softmax is
    shift-invariant, so this is softmax wherever the logits stay within
    about 83 nats of the bound; beyond, p saturates at 2^60 and the result
    stays finite."""
    c = q.shape[-1] ** -0.5 * _LOG2E
    qf = q.float() * c
    s = torch.matmul(qf.to(q.dtype).float(), k.float().transpose(-1, -2))
    qn = (qf * qf).sum(-1, keepdim=True).sqrt()
    m = torch.clamp(qn * key_norm_plain(k)[..., None, None], max=60.0)
    p = torch.exp2(torch.clamp(s - m, max=60.0))
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


def split_heads(qkv: torch.Tensor, num_heads: int, head_dim: int):
    """(B, S, 3*H*D) component-major -> q, k, v views of shape (B, H, S, D)
    (no copy: each is a strided slice of ``qkv``)."""
    b, s, _ = qkv.shape
    parts = qkv.reshape(b, s, 3, num_heads, head_dim)
    return tuple(parts[:, :, i].transpose(1, 2) for i in range(3))


def attention_reference(qkv: torch.Tensor, num_heads: int, head_dim: int,
                        kv_len: Optional[int] = None,
                        score_mode: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version with the fused kernel's exact contract,
    score mode included (``None``: ``TXR_ATTN_SCORES``)."""
    b, s, c = qkv.shape
    h, d = num_heads, head_dim
    if c != 3 * h * d:
        raise ValueError(f"qkv has {c} columns, expected 3*{h}*{d}")
    mode = resolve_score_mode(score_mode)
    if mode == "boundmax" and (kv_len is None or kv_len == s):
        o = attention_boundmax_plain(*split_heads(qkv, h, d))
    else:
        o = attention_plain(*split_heads(qkv, h, d), kv_len)
    return o.transpose(1, 2).reshape(b, s, h * d)


def attention_key_norm(qkv: torch.Tensor, num_heads: int,
                       head_dim: int) -> torch.Tensor:
    """(B, S, 3*H*D) -> (B, H) f32: the largest key norm of each head,
    which score mode ``"boundmax"`` bounds its logits with. The kernel on a
    CUDA tensor, :func:`key_norm_plain` on a CPU tensor."""
    if qkv.device.type == "cpu":
        return key_norm_plain(split_heads(qkv, num_heads, head_dim)[1])
    b, s, _ = qkv.shape
    _check_kernel_qkv(qkv, num_heads, head_dim)
    kn = torch.empty((b, num_heads), dtype=torch.float32, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _cuda.lib().txr_attention_key_norm(
            qkv.data_ptr(), kn.data_ptr(), b, s, num_heads,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "attention_key_norm")
    _cuda.launches["attention_key_norm"] += 1
    return kn


def _check_kernel_qkv(qkv: torch.Tensor, num_heads: int,
                      head_dim: int) -> None:
    if qkv.dtype != torch.bfloat16:
        raise TypeError(
            f"the attention kernel takes bfloat16, got {qkv.dtype}")
    if head_dim != 64:
        raise ValueError(
            f"the attention kernel is built for head_dim 64, got {head_dim}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(
            "the attention kernel needs a contiguous, 16-byte aligned qkv")
    if qkv.shape[0] > 65535 or num_heads > 65535:
        raise ValueError("batch and head count must each be below 65536")


def _launch(qkv: torch.Tensor, num_heads: int, head_dim: int,
            kv_len: int, mode: str) -> torch.Tensor:
    b, s, c = qkv.shape
    _check_kernel_qkv(qkv, num_heads, head_dim)
    kn = (attention_key_norm(qkv, num_heads, head_dim)
          if mode == "boundmax" else None)
    out = torch.empty((b, s, num_heads * head_dim), dtype=qkv.dtype,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _cuda.lib().txr_attention_fwd(
            qkv.data_ptr(), out.data_ptr(), b, s, num_heads, kv_len,
            head_dim ** -0.5, None if kn is None else kn.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    name = "attention_boundmax" if mode == "boundmax" else "attention"
    _cuda.check(err, name)
    _cuda.launches[name] += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """Kernel forward; backward differentiates the plain version (``txr``
    has no backward kernel either)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, head_dim, kv_len, mode):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, head_dim, kv_len)
        if qkv.device.type == "cpu":
            return attention_reference(qkv, num_heads, head_dim, kv_len,
                                       mode)
        return _launch(qkv, num_heads, head_dim,
                       qkv.shape[1] if kv_len is None else kv_len, mode)

    @staticmethod
    def backward(ctx, grad):
        # the f32max reference in every mode, as txr's custom VJP
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            y = attention_reference(x, *ctx.args, score_mode="f32max")
            (gx,) = torch.autograd.grad(y, x, grad)
        return gx, None, None, None, None


def fused_attention(qkv: torch.Tensor, num_heads: int, head_dim: int,
                    kv_len: Optional[int] = None,
                    score_mode: Optional[str] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v on (B, S, 3*H*D) -> (B, S, H*D).

    Keys at positions >= ``kv_len`` are ignored (``None``: all S keys).
    ``score_mode`` (``None``: ``TXR_ATTN_SCORES`` now) chooses the softmax
    shift of the full-key route; with ``kv_len < S`` it has no effect.
    """
    if qkv.dim() != 3 or qkv.shape[2] != 3 * num_heads * head_dim:
        raise ValueError(
            f"qkv must be (B, S, 3*{num_heads}*{head_dim}), got "
            f"{tuple(qkv.shape)}")
    if kv_len is not None and not 1 <= kv_len <= qkv.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [1, {qkv.shape[1]}]")
    mode = resolve_score_mode(score_mode)
    if kv_len is not None and kv_len < qkv.shape[1]:
        mode = "f32max"
    return _FusedAttention.apply(qkv, num_heads, head_dim, kv_len, mode)


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
