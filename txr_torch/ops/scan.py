"""Segmented prefix sums of the fusion sort pipeline: Hopper kernel + plain
PyTorch version. Counterpart of ``txr/ops/scan.py``.

The kernel (``csrc/segscan.cu``) replaces the TPU kernel
``txr/ops/scan.py:_segscan_kernel``. It is bound by bytes on this card
(4*D + 1 read and 4*D written per row, one add per value), so the design
reads and writes every row once: a per-tile scan that also emits one
aggregate per tile, a one-block scan of the aggregates, and a pass that adds
the incoming carry to the few rows in front of each tile's first start. The
TPU kernel's in-order grid with a carry in scratch memory has no counterpart
here, because blocks run in no order. No float atomics: the result is the
same from run to run.

``segmented_cumsum_cols`` takes the plain version
(``txr_torch.ops.segment.segmented_cumsum``) only for tensors that lie on
the CPU. For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from txr_torch import _cuda
from txr_torch.ops.segment import segmented_cumsum

_MAX_COLS = 8


def _launch(cols: Tuple[torch.Tensor, ...], starts: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    d = len(cols)
    n = cols[0].shape[0]
    dev = cols[0].device
    for c in cols:
        if c.dtype != torch.float32 or c.device != dev or c.shape != (n,):
            raise TypeError(
                "the segmented-scan kernel takes float32 columns of one "
                "length on one device")
        if not c.is_contiguous():
            raise ValueError("the segmented-scan kernel needs contiguous "
                             "columns")
    if starts.dtype != torch.bool or starts.shape != (n,) \
            or starts.device != dev or not starts.is_contiguous():
        raise TypeError("starts must be a contiguous (N,) bool tensor on "
                        "the columns' device")
    out = torch.empty((d, n), dtype=torch.float32, device=dev)
    if n == 0:
        return tuple(out[i] for i in range(d))
    lib = _cuda.lib()
    ntiles = -(-n // lib.txr_segscan_tile())
    fscratch = torch.empty((2 * ntiles * _MAX_COLS,), dtype=torch.float32,
                           device=dev)
    iscratch = torch.empty((2 * ntiles,), dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * d)(*[c.data_ptr() for c in cols])
    with torch.cuda.device(dev):
        err = lib.txr_segscan_fwd(
            ptrs, starts.data_ptr(), out.data_ptr(), n, d,
            fscratch.data_ptr(), iscratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "segscan")
    _cuda.launches["segscan"] += 1
    return tuple(out[i] for i in range(d))


def segmented_cumsum_cols(cols: Tuple[torch.Tensor, ...],
                          starts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-segment inclusive prefix sums over 1 to 8 (N,) f32 columns.

    starts: (N,) bool, True at each segment's first row; all False gives a
    plain cumulative sum. The value at a segment's last row is that
    segment's total.
    """
    d = len(cols)
    if not 1 <= d <= _MAX_COLS:
        raise ValueError(f"1 to {_MAX_COLS} columns, got {d}")
    if cols[0].device.type == "cpu":
        out = segmented_cumsum(torch.stack(tuple(cols), dim=1), starts)
        return tuple(out[:, i] for i in range(d))
    return _launch(tuple(cols), starts)
