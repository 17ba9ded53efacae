"""Fused W8A8 linear layer: Hopper kernel + plain PyTorch version.
Counterpart of ``txr/ops/quant_pallas.py``.

    y = (round(x / s_x) @ W_q) * (s_x ⊗ s_w) + b

with s_x = max(rowmax|x| / 127, 1e-12) computed per row inside the kernel,
W_q and s_w quantised per output column outside it, the integer sums exact,
the rescale and the bias add in f32, and one rounding to x's dtype. (The
``"int8"`` policy, ``txr_torch.ops.quant.Int8Linear``, differs on purpose:
it rounds before it adds the bias.)

The kernel (``csrc/int8_linear.cu``) replaces the TPU kernel
``txr/ops/quant_pallas.py:_kernel``. It is bound by operations on this card,
so the product runs on the int8 tensor cores (``mma.sync.m16n8k32``). The
TPU kernel's scheme, a whole (256, K) row block resident and re-quantised
per tile of N, does not fit a Hopper block's shared memory; here one small
kernel quantises each row once (bf16 in, int8 and s_x out) and a tiled
product with the rescale-and-bias epilogue follows, both behind one entry
point. The weight goes in as (N, K) int8 with K contiguous, which is
``nn.Linear.weight``'s own layout.

``int8_linear`` takes the plain version only for a tensor that lies on the
CPU. For a CUDA tensor it launches the kernel or raises (bf16 only).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from txr_torch import _cuda
from txr_torch.core.derived import Derived
from txr_torch.ops.quant import int_product, quantize_rows, quantize_weight


def _reference_q(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                 b: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version on an already quantised weight: wq (K, N) int8."""
    shape = x.shape
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]))
    y = int_product(xq, wq) * (sx * sw)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype).reshape(*shape[:-1], wq.shape[1])


def int8_linear_reference(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's exact arithmetic.

    x: (..., K) float; w: (K, N) float; b: (N,) or None. Returns x.dtype.
    """
    wq, sw = quantize_weight(w)
    return _reference_q(x, wq, sw, b)


def _launch(x: torch.Tensor, wq_nk: torch.Tensor, sw: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """x (..., K) bf16 CUDA; wq_nk (N, K) int8 contiguous; sw, bias (N,) f32."""
    shape = x.shape
    k = shape[-1]
    n = wq_nk.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(
            f"the int8 linear kernel takes bfloat16 activations, got "
            f"{x.dtype}")
    if k % 16 or n % 8:
        raise ValueError(
            f"the int8 linear kernel needs K a multiple of 16 and N a "
            f"multiple of 8, got K={k}, N={n}")
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m = x2.shape[0]
    dev = x.device
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return out.reshape(*shape[:-1], n)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty((m,), dtype=torch.float32, device=dev)
    for name, ten in (("x", x2), ("wq", wq_nk), ("sw", sw), ("bias", bias)):
        if (ten.device != dev or not ten.is_contiguous()
                or ten.data_ptr() % 16):
            raise ValueError(
                f"the int8 linear kernel needs {name} contiguous, 16-byte "
                f"aligned and on {dev}")
    with torch.cuda.device(dev):
        err = _cuda.lib().txr_int8_linear_fwd(
            x2.data_ptr(), wq_nk.data_ptr(), sw.data_ptr(), bias.data_ptr(),
            xq.data_ptr(), sx.data_ptr(), out.data_ptr(), m, k, n,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "int8_linear")
    _cuda.launches["int8_linear"] += 1
    return out.reshape(*shape[:-1], n)


def _kernel_operands(wq: torch.Tensor, sw: torch.Tensor):
    """(K, N) int8 of any layout -> the (N, K)-contiguous operand."""
    return wq.t().contiguous(), sw.to(torch.float32).contiguous()


def int8_linear(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w + b with W8A8 dynamic quantisation.

    x: (..., K) float; w: (K, N) float (quantised per column here);
    b: (N,) or None. Returns x.dtype.
    """
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(
            f"expected x (..., K) and w (K, N), got {tuple(x.shape)} and "
            f"{tuple(w.shape)}")
    wq, sw = quantize_weight(w)
    if x.device.type == "cpu":
        return _reference_q(x, wq, sw, b)
    wq_nk, sw = _kernel_operands(wq, sw)
    bias = (torch.zeros_like(sw) if b is None
            else b.to(torch.float32).contiguous())
    return _launch(x, wq_nk, sw, bias)


def _quantize_for_kernel(weight: torch.Tensor):
    wq, sw = quantize_weight(weight.t())
    return (wq, *_kernel_operands(wq, sw))


def _bias_f32(bias: torch.Tensor) -> torch.Tensor:
    return bias.to(torch.float32).contiguous()


class Int8LinearFused(nn.Linear):
    """``nn.Linear`` whose forward is :func:`int8_linear` (``txr``'s
    ``Int8DensePallas``). Same parameters and state-dict keys as
    ``nn.Linear``. ``txr`` quantises the weight in every forward; here the
    quantised weight and the f32 bias are derived from the parameters and
    kept until those change."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device, dtype)
        self._wq = Derived(_quantize_for_kernel)
        self._b32 = Derived(_bias_f32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wq, wq_nk, sw = self._wq.get(self.weight)
        if x.device.type == "cpu":
            return _reference_q(x, wq, sw, self.bias)
        bias = (torch.zeros_like(sw) if self.bias is None
                else self._b32.get(self.bias))
        return _launch(x, wq_nk, sw, bias)
