"""Merge of the voxel map's key-ordered rows with a sorted batch: Hopper
kernel + plain PyTorch version.

An insert sorts the map's rows and the batch's by one int64 key
(:func:`row_keys`). The map's rows are in key order already
(``txr_torch/fusion/offset_map.py:OffsetVoxelMap``), so only the batch is
sorted; :func:`merge_sorted` merges it into the map's rows and gives the
sorted key and the permutation that a stable sort of the map's rows
followed by the batch's would give: on an equal key a map row goes first,
and batch rows keep the order of their stable sort.

The kernel (``csrc/merge.cu``) replaces no TPU kernel: ``txr`` sorts the
map and the batch together with ``jax.lax.sort``
(``txr/fusion/offset_map.py:165``). It is bound by bytes on this card: it
reads the map's two int32 key columns and the sorted batch's key and
permutation once and writes the merged key and permutation once, in a
partition launch (one binary search per tile of :data:`TILE` output rows)
and one merge launch (a tile's rows staged in shared memory, merged there,
stored coalesced).

:func:`merge_sorted` takes the plain version (:func:`merge_sorted_plain`)
only for tensors that lie on the CPU. For CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from txr_torch import _cuda

# The kernel's tiling (csrc/merge.cu; ``chip_smoke.py`` checks that the
# built library reports the same numbers).
THREADS = 256            # threads of a merge block, one tile each
ITEMS = 8                # consecutive output rows a thread merges
TILE = THREADS * ITEMS
PART_THREADS = 256       # threads of a partition block, one split each
ALIGN = 16               # bytes: operands are read 16 bytes at a time
MAX_ROWS = 2 ** 31 - 1 - TILE   # the kernel's int32 row index

_BIAS = 1 << 31


def row_keys(khi: torch.Tensor, klo_x: torch.Tensor) -> torch.Tensor:
    """The int64 sort key ``(khi << 32) | (klo_x + 2^31)`` of packed map
    rows, whose signed order is the lexicographic signed order of the
    pair."""
    return (khi.long() << 32) | (klo_x.long() + _BIAS)


def merge_geometry(n_head: int, n_tail: int) -> dict:
    """Tiles and scratch of one merge of ``n_head`` key-ordered rows with
    ``n_tail`` sorted ones (pure; the kernel's own arithmetic). The int32
    scratch holds the first head row of each tile's output, and of the
    end."""
    n = n_head + n_tail
    if n_head < 0 or n_tail < 0:
        raise ValueError(f"row counts must not be negative, got {n_head} "
                         f"and {n_tail}")
    if n > MAX_ROWS:
        raise ValueError(f"{n} rows: beyond the merge kernel's int32 row "
                         f"index ({MAX_ROWS})")
    tiles = -(-n // TILE)
    return {"rows": n, "tiles": tiles, "threads": THREADS,
            "tile_rows": TILE, "splits": tiles + 1,
            "partition_blocks": -(-(tiles + 1) // PART_THREADS),
            "partition_threads": PART_THREADS,
            "scratch_bytes": 4 * (tiles + 1)}


def require_merge_operands(khi: torch.Tensor, klo_x: torch.Tensor,
                           tail_key: torch.Tensor,
                           tail_perm: torch.Tensor) -> dict:
    """Raise unless the merge takes these operands; return its
    :func:`merge_geometry`. Pure: reads dtypes, shapes, devices, strides and
    addresses only. The head's ``khi`` and ``klo_x`` are (H,) int32, the
    tail's ``tail_key`` and ``tail_perm`` (T,) int64, all contiguous and
    16-byte aligned on one device."""
    for name, t, dtype in (("khi", khi, torch.int32),
                           ("klo_x", klo_x, torch.int32),
                           ("tail_key", tail_key, torch.int64),
                           ("tail_perm", tail_perm, torch.int64)):
        if t.dtype != dtype or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D {dtype} tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != khi.device:
            raise ValueError(f"{name} lies on {t.device}, khi on "
                             f"{khi.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} is not {ALIGN}-byte aligned")
    if klo_x.shape != khi.shape or tail_perm.shape != tail_key.shape:
        raise ValueError(f"khi {tuple(khi.shape)} and klo_x "
                         f"{tuple(klo_x.shape)}, tail_key "
                         f"{tuple(tail_key.shape)} and tail_perm "
                         f"{tuple(tail_perm.shape)} must pair up")
    return merge_geometry(khi.shape[0], tail_key.shape[0])


def merge_sorted_plain(khi: torch.Tensor, klo_x: torch.Tensor,
                       tail_key: torch.Tensor, tail_perm: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: each row's place by rank. Head row i lands at i
    plus the tail keys below its key, tail row j at j plus the head keys at
    or below its key."""
    head_key = row_keys(khi, klo_x)
    nh, nt = head_key.shape[0], tail_key.shape[0]
    dev = head_key.device
    head_at = torch.arange(nh, device=dev) + torch.searchsorted(
        tail_key, head_key, right=False)
    tail_at = torch.arange(nt, device=dev) + torch.searchsorted(
        head_key, tail_key, right=True)
    skey = torch.empty((nh + nt,), dtype=torch.int64, device=dev)
    perm = torch.empty((nh + nt,), dtype=torch.int64, device=dev)
    skey[head_at] = head_key
    skey[tail_at] = tail_key
    perm[head_at] = torch.arange(nh, device=dev)
    perm[tail_at] = tail_perm + nh
    return skey, perm


def _launch(khi, klo_x, tail_key, tail_perm, geo: dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = khi.device
    skey = torch.empty((geo["rows"],), dtype=torch.int64, device=dev)
    perm = torch.empty((geo["rows"],), dtype=torch.int64, device=dev)
    if geo["rows"] == 0:
        return skey, perm
    splits = torch.empty((geo["splits"],), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().txr_merge_sorted_fwd(
            khi.data_ptr(), klo_x.data_ptr(), tail_key.data_ptr(),
            tail_perm.data_ptr(), khi.shape[0], tail_key.shape[0],
            skey.data_ptr(), perm.data_ptr(), splits.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "merge_sorted")
    _cuda.launches["merge_sorted"] += 1
    return skey, perm


def merge_sorted(khi: torch.Tensor, klo_x: torch.Tensor,
                 tail_key: torch.Tensor, tail_perm: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge H head rows, given as their int32 ``khi`` / ``klo_x`` columns
    in key order, with T tail rows, given as their sorted int64 keys
    (:func:`row_keys`) and the stable sort's permutation of the tail. Returns
    the (H + T,) int64 sorted key and permutation of the head's rows
    followed by the tail's: exactly what ``torch.sort(stable=True)`` of the
    keys of all H + T rows gives. Nothing is read back to the host."""
    geo = require_merge_operands(khi, klo_x, tail_key, tail_perm)
    if khi.device.type == "cpu":
        return merge_sorted_plain(khi, klo_x, tail_key, tail_perm)
    return _launch(khi, klo_x, tail_key, tail_perm, geo)
