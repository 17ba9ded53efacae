"""Depth Anything 3's QK-norm and 2-D RoPE on the fused qkv projection:
Hopper kernel + plain PyTorch version.

For q and k of every token and head: a LayerNorm over the head's values
(one weight and bias for q, one for k), then the 2-D rotary embedding of
``rope_tables``, in float32, rounded once to the qkv's dtype; v passes
through. The kernel (``csrc/qk_prep.cu``) replaces no TPU kernel, because
Depth Anything 3 is not in ``txr``. It is bound by bytes on this card: it
reads q and k once and writes them once, in place, in one launch, where the
plain version (:func:`qk_prep_plain`) takes some twenty launches and a new
fused tensor.

:func:`qk_prep` takes the plain version only for tensors that lie on the
CPU, and returns a new tensor. For CUDA tensors it launches the kernel,
which updates ``qkv`` in place and returns it, or raises
(:func:`require_qk_prep_operands`). In place is safe where the caller owns
a fresh ``qkv`` that only attention reads next, as ``models/vit.py``'s
``QKPrep`` does; so autograd must not be recording on it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from txr_torch import _cuda

# The kernel's geometry (csrc/qk_prep.cu; ``chip_smoke.py`` checks that the
# built library reports the same numbers).
HEAD_DIM = 64
THREADS = 256
ROWS_PER_BLOCK = 32
ALIGN = 16                 # bytes: every operand is read 16 bytes at a time


def rope_tables(ph: int, pw: int, head_dim: int, base: float,
                device, specials: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin, (specials + ph*pw, 1, head_dim) float32, of the 2-D
    rotary embedding (the CroCo / VGGT convention): the first half of a
    head's dimensions turns with the token's row, the second with its
    column, each half at the frequencies ``base^(-2j / half)`` repeated
    over its two quarters. The ``specials`` tokens before the patches (Depth
    Anything 3's camera token; VGGT's camera token and four registers) sit
    at (0, 0), patch (r, c) at (r + 1, c + 1)."""
    half = head_dim // 2
    inv = base ** -(torch.arange(0, half, 2, device=device,
                                 dtype=torch.float32) / half)
    rows = torch.arange(ph, device=device, dtype=torch.float32) + 1
    cols = torch.arange(pw, device=device, dtype=torch.float32) + 1
    zero = torch.zeros(specials, device=device)
    r = torch.cat([zero, rows.repeat_interleave(pw)])[:, None] * inv
    c = torch.cat([zero, cols.repeat(ph)])[:, None] * inv
    angles = torch.cat([r, r, c, c], dim=1)[:, None]
    return angles.cos(), angles.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) turned by ``rope_tables``: x cos + rot(x) sin, with
    rot taking each half's quarters (a, b) to (-b, a)."""
    xr = x.unflatten(-1, (2, 2, x.shape[-1] // 4))
    rot = torch.stack([-xr[..., 1, :], xr[..., 0, :]], dim=-2).flatten(-3)
    return x * cos + rot * sin


def _prep(x: torch.Tensor, ln: nn.LayerNorm, tables) -> torch.Tensor:
    x = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return apply_rope(x, *tables)


def qk_prep_plain(qkv: torch.Tensor, heads: int, q_norm: nn.LayerNorm,
                  k_norm: nn.LayerNorm, tables) -> torch.Tensor:
    """The plain version: a new (B, S, 3*H*D) tensor with q and k normed
    and rotated in float32, v as it was."""
    b, s, _ = qkv.shape
    q, k, v = qkv.view(b, s, 3, heads, -1).unbind(2)
    q = _prep(q, q_norm, tables)
    k = _prep(k, k_norm, tables)
    return torch.stack([q.to(v.dtype), k.to(v.dtype), v],
                       dim=2).view(b, s, -1)


def require_qk_prep_operands(qkv: torch.Tensor, heads: int,
                             q_norm: nn.LayerNorm, k_norm: nn.LayerNorm,
                             tables) -> dict:
    """Raise unless the kernel takes these operands; return its launch
    (rows, blocks, threads). Pure: reads dtypes, shapes, strides, addresses
    and autograd flags only, so it runs on CPU tensors too. The kernel takes
    a contiguous bf16 (B, S, 3*heads*64) ``qkv`` that autograd does not
    record, float32 cos and sin of S rows of 64, and bf16 (64,) weights and
    biases under one eps, all 16-byte aligned on the qkv's device."""
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the qk_prep kernel takes bfloat16 qkv, got "
                        f"{qkv.dtype}")
    if qkv.dim() != 3 or heads < 1 or qkv.shape[2] % (3 * heads):
        raise ValueError(f"qkv must be (B, S, 3*{heads}*D), got "
                         f"{tuple(qkv.shape)}")
    b, s, width = qkv.shape
    if width // (3 * heads) != HEAD_DIM:
        raise ValueError(f"the qk_prep kernel takes head_dim {HEAD_DIM}, got "
                         f"{width // (3 * heads)}")
    if not qkv.is_contiguous():
        raise ValueError("the qk_prep kernel needs a contiguous qkv")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("the qk_prep kernel updates qkv in place: run it "
                           "where autograd does not record (no_grad)")
    rows = 2 * b * s * heads
    if not 1 <= rows <= 2 ** 31 - 1 - ROWS_PER_BLOCK:
        raise ValueError(f"{rows} rows of q and k: outside the kernel's "
                         f"int32 row index")
    operands = [("qkv", qkv)]
    for name, t in zip(("cos", "sin"), tables):
        if t.dtype != torch.float32 or t.shape[0] != s \
                or t.numel() != s * HEAD_DIM or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 table of "
                             f"{s} rows of {HEAD_DIM}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        operands.append((name, t))
    for ln_name, ln in (("q_norm", q_norm), ("k_norm", k_norm)):
        for name, t in (("weight", ln.weight), ("bias", ln.bias)):
            if t is None or t.dtype != torch.bfloat16 \
                    or t.shape != (HEAD_DIM,) or not t.is_contiguous():
                raise ValueError(f"{ln_name}.{name} must be a contiguous "
                                 f"bf16 ({HEAD_DIM},) tensor")
            operands.append((f"{ln_name}.{name}", t))
    if q_norm.eps != k_norm.eps:
        raise ValueError("the qk_prep kernel takes one eps for q and k")
    for name, t in operands:
        if t.device != qkv.device:
            raise ValueError(f"{name} lies on {t.device}, qkv on "
                             f"{qkv.device}")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} is not {ALIGN}-byte aligned")
    return {"rows": rows, "blocks": -(-rows // ROWS_PER_BLOCK),
            "threads": THREADS}


def _launch(qkv: torch.Tensor, heads: int, q_norm: nn.LayerNorm,
            k_norm: nn.LayerNorm, tables) -> torch.Tensor:
    """One launch on operands that :func:`require_qk_prep_operands`
    passed."""
    b, s, _ = qkv.shape
    cos, sin = tables
    with torch.cuda.device(qkv.device):
        err = _cuda.lib().txr_qk_prep_fwd(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            q_norm.weight.data_ptr(), q_norm.bias.data_ptr(),
            k_norm.weight.data_ptr(), k_norm.bias.data_ptr(), b, s, heads,
            q_norm.eps, torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "qk_prep")
    _cuda.launches["qk_prep"] += 1
    return qkv


def qk_prep(qkv: torch.Tensor, heads: int, q_norm: nn.LayerNorm,
            k_norm: nn.LayerNorm, tables) -> torch.Tensor:
    """q and k of the fused (B, S, 3*heads*D) ``qkv`` normed by ``q_norm`` /
    ``k_norm`` and turned by ``tables`` (``rope_tables`` of the batch's
    patch grid); v as it was. A CPU tensor takes :func:`qk_prep_plain` and
    gets a new tensor; a CUDA tensor is updated in place by the kernel and
    returned."""
    if qkv.device.type == "cpu":
        return qk_prep_plain(qkv, heads, q_norm, k_norm, tables)
    require_qk_prep_operands(qkv, heads, q_norm, k_norm, tables)
    return _launch(qkv, heads, q_norm, k_norm, tables)
