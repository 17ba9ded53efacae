"""Segmented prefix sums of the fusion sort pipeline: Hopper kernel + plain
PyTorch version. Counterpart of ``txr/ops/scan.py``.

The kernel (``csrc/segscan.cu``) replaces the TPU kernel
``txr/ops/scan.py:_segscan_kernel``. It is bound by bytes on this card
(4*D + 1 read and 4*D written per row, one add per value), so it reads and
writes every row once, in one launch: tiles of :data:`TILE` rows scan
themselves and join through a decoupled look-back (each tile publishes its
aggregate, then its inclusive prefix, in a small scratch whose status words
are zeroed before the launch). The TPU kernel's in-order grid with a carry
in scratch memory has no counterpart here, because blocks run in no order.
Every sum is folded in a fixed order and there are no float atomics: the
result is the same from run to run. The same scan core serves the voxel
map's fused segment reduce (:func:`offset_reduce`, used by
``txr_torch/fusion/offset_map.py``).

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

# The kernel's tiling (csrc/segscan.cu; ``chip_smoke.py`` checks that the
# built library reports the same numbers).
THREADS = 256        # threads per block, one tile each
ITEMS = 8            # consecutive rows per thread
TILE = THREADS * ITEMS
MAX_COLS = 8


def scan_geometry(n: int) -> dict:
    """Tiles and look-back scratch of one launch over ``n`` rows (pure; the
    kernel's own arithmetic, kept here so that it can be tested without the
    card). The int32 scratch is the tile counter and three words per tile
    (status, aggregate count, inclusive count), the f32 scratch an aggregate
    and an inclusive prefix of :data:`MAX_COLS` values per tile; only the
    counter and the status words are zeroed before a launch."""
    if n < 1:
        raise ValueError(f"the scan kernel needs at least one row, got {n}")
    tiles = -(-n // TILE)
    return {"tiles": tiles, "threads": THREADS,
            "int_words": 1 + 3 * tiles, "float_words": 2 * MAX_COLS * tiles,
            "reset_bytes": 4 * (1 + tiles),
            "scratch_bytes": 4 * (1 + 3 * tiles) + 4 * 2 * MAX_COLS * tiles}


def _scratch(n: int, dev: torch.device):
    geo = scan_geometry(n)
    return (torch.empty((geo["float_words"],), dtype=torch.float32,
                        device=dev),
            torch.empty((geo["int_words"],), dtype=torch.int32, device=dev))


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
    fscratch, iscratch = _scratch(n, dev)
    ptrs = (ctypes.c_void_p * d)(*[c.data_ptr() for c in cols])
    with torch.cuda.device(dev):
        err = _cuda.lib().txr_segscan_fwd(
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
    if not 1 <= d <= MAX_COLS:
        raise ValueError(f"1 to {MAX_COLS} columns, got {d}")
    if cols[0].device.type == "cpu":
        out = segmented_cumsum(torch.stack(tuple(cols), dim=1), starts)
        return tuple(out[:, i] for i in range(d))
    return _launch(tuple(cols), starts)


def offset_reduce(skey: torch.Tensor, perm: torch.Tensor, yzw: torch.Tensor,
                  rgb: torch.Tensor, out: Tuple[torch.Tensor, ...]) -> None:
    """The voxel map's segment reduce on the card, in one launch of the scan
    kernel's second entry point: from the sorted int64 key ``skey``, the
    sort's permutation ``perm`` and the unsorted int32 payload columns
    ``yzw`` / ``rgb`` (all (N,)), write each voxel's packed (khi, klo_x,
    yzw, rgb) at its rank into the four (cap,) int32 columns of ``out``,
    which hold an empty map; ranks past cap are dropped. Nothing is read
    back to the host. The plain version is the torch code of
    ``txr_torch/fusion/offset_map.py:_reduce_unfused``."""
    n = skey.shape[0]
    dev = skey.device
    if dev.type != "cuda":
        raise ValueError("offset_reduce is the kernel route; the CPU takes "
                         "the plain version")
    for name, t, dtype, length in (("skey", skey, torch.int64, n),
                                   ("perm", perm, torch.int64, n),
                                   ("yzw", yzw, torch.int32, n),
                                   ("rgb", rgb, torch.int32, n)):
        if t.dtype != dtype or t.shape != (length,) or t.device != dev \
                or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous ({length},) "
                            f"{dtype} tensor on {dev}")
    cap = out[0].shape[0]
    for t in out:
        if t.dtype != torch.int32 or t.shape != (cap,) or t.device != dev \
                or not t.is_contiguous():
            raise TypeError("the map's columns must be contiguous (cap,) "
                            "int32 tensors on the key's device")
    if n == 0:
        return
    fscratch, iscratch = _scratch(n, dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().txr_offset_reduce_fwd(
            skey.data_ptr(), perm.data_ptr(), yzw.data_ptr(), rgb.data_ptr(),
            n, cap, *(t.data_ptr() for t in out), fscratch.data_ptr(),
            iscratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "offset_reduce")
    _cuda.launches["offset_reduce"] += 1
