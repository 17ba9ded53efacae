"""W8A8 dynamic quantisation for int8 matrix products, the counterpart of
``txr/ops/quant.py``.

The recipe is ``txr``'s:

    weight:     per-output-column symmetric int8, scale = colmax(|W|) / 127
    activation: per-row (per-token) symmetric int8 computed in the forward,
                scale = rowmax(|x|) / 127
    y = (x_q @ W_q) * (s_x ⊗ s_w) + b     (int32 sums, rescaled in f32)

with both scales clamped at 1e-12, rounding half to even, and true
divisions. ``quantize_weight`` and ``int8_matmul`` keep ``txr``'s layouts
((K, N) weights). ``Int8Linear`` is the ``"int8"`` policy of the ViT: like
``txr``'s ``Int8Dense`` it computes the integer product outside any
hand-written kernel (``torch._int_mm`` on a CUDA tensor where that call's
shape rules allow, an exact float64 product otherwise), and it rounds to the
activation dtype before it adds the bias in that dtype. The fused kernel
policy lives in ``txr_torch/ops/quant_fused.py``.

The integer sums reach 127 * 127 * K, which float32 cannot hold exactly from
K = 1041 on, so no product here is taken in float32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from txr_torch.core.derived import Derived


def amax_scale(a: torch.Tensor, dim: int) -> torch.Tensor:
    """max(amax(|a|, dim) / 127, 1e-12) in f32, ``dim`` kept.

    The divisor is a tensor on purpose: PyTorch's CUDA division by a Python
    number multiplies by the rounded reciprocal, which is not the division
    the recipe (and the fused kernel) performs.
    """
    s = a.abs().amax(dim=dim, keepdim=True)
    return (s / torch.full_like(s, 127.0)).clamp_min(1e-12)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, N) float -> (int8 (K, N), f32 (N,) per-column scale).

    The int8 result has ``w``'s memory layout, so the transposed view of an
    ``nn.Linear.weight`` gives a (K, N) view of (N, K)-contiguous storage.
    """
    wf = w.to(torch.float32)
    s = amax_scale(wf, 0)
    wq = torch.round(wf / s).clamp_(-127, 127).to(torch.int8)
    return wq, s[0]


def quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, K) float -> (int8 (M, K), f32 (M, 1) per-row scale)."""
    xf = x2.to(torch.float32)
    sx = amax_scale(xf, -1)
    return torch.round(xf / sx).to(torch.int8), sx


def int_product(xq: torch.Tensor, wq: torch.Tensor,
                library: bool = False) -> torch.Tensor:
    """Exact (M, K) int8 @ (K, N) int8 as f32 (each sum rounded once).

    ``library`` lets a CUDA product go to ``torch._int_mm`` when its shape
    rules hold (M > 16, K and N multiples of 8); otherwise the product is
    taken in float64, which holds every sum exactly.
    """
    m, k = xq.shape
    n = wq.shape[1]
    if library and xq.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(xq.contiguous(), wq).to(torch.float32)
    return torch.matmul(xq.to(torch.float64), wq.to(torch.float64)).to(
        torch.float32)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dynamic per-row W8A8 product: x (..., K) @ wq (K, N) -> (..., N)."""
    shape = x.shape
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]))
    y = int_product(xq, wq, library=True) * (sx * sw)
    return y.to(out_dtype).reshape(*shape[:-1], wq.shape[-1])


def _quantize_linear_weight(weight: torch.Tensor):
    return quantize_weight(weight.t())


class Int8Linear(nn.Linear):
    """``nn.Linear`` with the W8A8 forward of ``txr``'s ``Int8Dense``.

    Same parameters and state-dict keys as ``nn.Linear`` (``weight`` (out,
    in), ``bias``), so a model flips between the two without touching its
    checkpoints. The quantised weight is derived from ``weight`` and kept
    until ``weight`` changes.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device, dtype)
        self._wq = Derived(_quantize_linear_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wq, sw = self._wq.get(self.weight)
        y = int8_matmul(x, wq, sw, out_dtype=x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
