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
so the product runs on the int8 tensor cores through ``wgmma``
(``m64n256k32``, s8 x s8 -> s32, both operands from shared memory). The TPU
kernel's scheme, a whole (256, K) row block resident and re-quantised per
tile of N, does not fit a Hopper block's shared memory; here one small
kernel quantises each row once (bf16 in, int8 and s_x out, the row held in
registers so that it is read once) and a persistent product kernel follows,
both behind one entry point: one block per multiprocessor walks 128 x 256
output tiles, a producer thread feeds a four-stage ring of 128-byte K slices
by TMA (rows past M or N and bytes past K arrive as zeros), two consumer
warpgroups multiply, and the rescale-and-bias epilogue stores 16 bytes a
thread through shared memory (:func:`kernel_geometry` has the arithmetic).
The weight goes in as (N, K) int8 with K contiguous, which is
``nn.Linear.weight``'s own layout and the K-major operand 8-bit ``wgmma``
needs.

``int8_linear`` takes the plain version only for a tensor that lies on the
CPU. For a CUDA tensor it launches the kernel or raises (bf16 only).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn

from txr_torch import _cuda
from txr_torch.core.derived import Derived
from txr_torch.ops.quant import int_product, quantize_rows, quantize_weight

# The product kernel's tiling (csrc/int8_linear.cu; ``chip_smoke.py`` checks
# that the built library reports the same numbers).
TILE_M = 128         # output rows per tile: 64 per consumer warpgroup
TILE_N = 256         # output columns per tile
STAGE_K = 128        # int8 values (bytes) of K per ring stage
STAGES = 4
THREADS = 384        # two consumer warpgroups + the producer's
MAX_SMEM_BYTES = 232448      # what one block may use on an H100


def kernel_geometry(m: int, k: int, n: int, sm_count: int) -> dict:
    """Grid, tiles, ring and shared-memory bytes of one launch of the
    product kernel on a device of ``sm_count`` multiprocessors (pure; the
    kernel's own arithmetic, kept here so that it can be tested without the
    card). Block ``b`` of the grid takes tiles ``b, b + grid, ...``; tile
    ``i`` is row tile ``i // n_tiles``, column tile ``i % n_tiles``."""
    if m < 1 or k < 1 or n < 1 or sm_count < 1:
        raise ValueError(
            f"M, K, N and the multiprocessor count must be positive, got "
            f"{m}, {k}, {n}, {sm_count}")
    m_tiles, n_tiles = -(-m // TILE_M), -(-n // TILE_N)
    tiles = m_tiles * n_tiles
    if tiles > 2 ** 31 - 1:
        raise ValueError(
            f"the int8 linear kernel counts its {tiles} output tiles in 32 "
            f"bits")
    grid = min(tiles, sm_count)
    stage = (TILE_M + TILE_N) * STAGE_K
    return {"grid": grid, "threads": THREADS, "tile": (TILE_M, TILE_N),
            "m_tiles": m_tiles, "n_tiles": n_tiles, "tiles": tiles,
            "waves": -(-tiles // grid), "k_slices": -(-k // STAGE_K),
            "stages": STAGES, "stage_bytes": stage,
            # innermost first: xq seen as (K, M), wq as (K, N)
            "x_box": (STAGE_K, TILE_M), "w_box": (STAGE_K, TILE_N),
            # 1024 of alignment, the ring, 8 warps x 16 rows x 64 columns of
            # bf16 for the epilogue, column scales and biases per consumer
            # warpgroup, two mbarriers a stage
            "smem_bytes": 1024 + STAGES * stage + 8 * 16 * 64 * 2
            + 2 * 2 * TILE_N * 4 + 2 * STAGES * 8}


def tile_origin(i: int, n_tiles: int) -> tuple:
    """First row and column of output tile ``i``."""
    return (i // n_tiles) * TILE_M, (i % n_tiles) * TILE_N


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
    # one scratch buffer: the quantised rows, then (16-byte aligned) their
    # scales
    sx_at = -(-m * k // 16) * 16
    scratch = torch.empty((sx_at + 4 * m,), dtype=torch.uint8, device=dev)
    for name, ten in (("x", x2), ("wq", wq_nk), ("sw", sw), ("bias", bias)):
        if (ten.device != dev or not ten.is_contiguous()
                or ten.data_ptr() % 16):
            raise ValueError(
                f"the int8 linear kernel needs {name} contiguous, 16-byte "
                f"aligned and on {dev}")
    sms = _cuda.sm_count(dev)
    kernel_geometry(m, k, n, sms)                        # raises by name
    args = (x2.data_ptr(), wq_nk.data_ptr(), sw.data_ptr(), bias.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + sx_at, out.data_ptr(),
            m, k, n, sms)
    # entering a device context costs more host time than the launch
    on_dev = (contextlib.nullcontext()
              if torch.cuda.current_device() == dev.index
              else torch.cuda.device(dev))
    with on_dev:
        err = _cuda.lib().txr_int8_linear_fwd(
            *args, torch.cuda.current_stream().cuda_stream)
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
