"""Mean-offset packed voxel map, the counterpart of
``txr/fusion/offset_map.py``.

The whole per-voxel state is four int32 columns, bit for bit as in ``txr``:

  khi   : voxel key bits x18|y14hi (order-preserved via sign-bit xor)
  klo_x : voxel key bits y4lo|z18 (22) << 10 | x-offset u10 (sign-bit xor).
          The x offset rides the low bits of the second sort key: it only
          tie-breaks rows within a voxel segment, never reorders voxels.
  yzw   : y-offset u10 << 21 | z-offset u10 << 11 | weight u11
  rgb   : mean color r8|g8|b8

Offsets are the mean position within the voxel in units of voxel_size/1024.
Weight saturates at 2047. Re-quantizing a stable mean is a fixed point of
floor(mean * 2^bits) with midpoint dequantization, so untouched voxels do
not drift across inserts.

The insert concatenates the map's rows with the batch's and orders them by
key: the map's rows are in key order already (see ``OffsetVoxelMap``), so
only the batch's rows are sorted, and merged into the map's
(``txr_torch/ops/merge.py:merge_sorted``; on the card a kernel), which gives
what a stable sort of all rows would give. It then reduces each voxel
segment with the SEGMENTED scan (``txr_torch/ops/scan.py``), so rounding
scales with a segment's own sum and not with the map's total weight, and
compacts the segment ends to the front. On the CPU the reduce after the
sort is plain PyTorch (``_reduce_unfused``: gathers, the scan's plain
version, ``torch.nonzero`` compaction). On the card it is one kernel
(``txr_torch.ops.scan.offset_reduce``) that unpacks the contributions, scans
them and writes each voxel at its rank, with no host sync.

Bit fields are assembled in int64 and narrowed to int32 at the end (see
``txr_torch/fusion/keys.py``); the two sort keys travel as one int64 key
``(khi << 32) | (klo_x + 2^31)``, whose signed order is the lexicographic
signed order of the pair.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from txr_torch.core.device import resolve_device
from txr_torch.core.types import PointSet
from txr_torch.fusion.keys import pack_keys, unpack_keys
from txr_torch.ops.merge import merge_sorted, row_keys
from txr_torch.ops.scan import offset_reduce, segmented_cumsum_cols
from txr_torch.ops.segment import INT_MAX
from txr_torch.utils.profiling import count, recording, span

_BIAS = 1 << 31
_MASK32 = 0xFFFFFFFF
W_MAX = 2047                    # 11-bit weight saturation


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding a 32-bit pattern -> the int32 with the same bits."""
    return (((v & _MASK32) ^ _BIAS) - _BIAS).to(torch.int32)


def _q(x: torch.Tensor, bits: int) -> torch.Tensor:
    """[0, 1) float -> fixed point (int64 in [0, 2^bits))."""
    scale = float(1 << bits)
    return torch.floor(x * scale).clamp(0, scale - 1).long()


def _dq(u: torch.Tensor, bits: int) -> torch.Tensor:
    """fixed point -> midpoint dequantized float in (0, 1)."""
    return (u.to(torch.float32) + 0.5) * (1.0 / float(1 << bits))


def _pack_klo_x(lo: torch.Tensor, xoff_u10: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """22-bit klo + u10 x offset -> sign-xored int32 sort column.

    Valid rows can never collide with the INT_MAX empty sentinel:
    ``pack_keys`` clips every coordinate to HALF_RANGE - 2, so the z18 field
    is strictly below all-ones and the column stays < INT_MAX even with x
    offset 1023."""
    u = ((lo.long() << 10) | xoff_u10) & _MASK32
    col = (u - _BIAS).to(torch.int32)
    return torch.where(valid, col, torch.full_like(col, INT_MAX))


def _unpack_klo_x(klo_x: torch.Tensor):
    u = klo_x.long() + _BIAS
    return (u >> 10).to(torch.int32), u & 0x3FF


def _pack_yzw(yoff_u10, zoff_u10, w) -> torch.Tensor:
    return _wrap32((yoff_u10 << 21) | (zoff_u10 << 11)
                   | w.long().clamp(max=W_MAX))


def _pack_rgb(r, g, b) -> torch.Tensor:
    return ((_q(r, 8) << 16) | (_q(g, 8) << 8) | _q(b, 8)).to(torch.int32)


def _unpack_rgb(u: torch.Tensor):
    return (_dq((u >> 16) & 0xFF, 8), _dq((u >> 8) & 0xFF, 8),
            _dq(u & 0xFF, 8))


class OffsetVoxelMap(NamedTuple):
    """The map's packed rows, in key order: ascending by the int64 key
    ``(khi << 32) | (klo_x + 2^31)`` (``txr_torch.ops.merge.row_keys``),
    occupied voxels first and the empty rows, ``(INT_MAX, INT_MAX)``,
    after them. An insert relies on it: it sorts only the batch and merges
    it into the map's rows. Every producer keeps it: ``create_offset_map``
    (all rows empty), ``offset_map_insert`` and ``offset_map_merge`` (each
    voxel written at its rank among the sorted voxel segments, the rows
    past the last left empty; within a voxel the x offset lies under the
    key bits, so voxel order is key order), and the slices and stacks of
    ``parallel/pipeline.py`` and ``pipelines/stream_step.py``, which are
    made of maps from these three."""

    khi: torch.Tensor     # (C,) int32 packed key high bits (INT_MAX = empty)
    klo_x: torch.Tensor   # (C,) int32 key low 22 | x-offset u10 (sign-xored)
    yzw: torch.Tensor     # (C,) int32 y10|z10|w11
    rgb: torch.Tensor     # (C,) int32 r8|g8|b8 mean color
    voxel_size: torch.Tensor  # 0-d float32 on the map's device

    @property
    def count(self) -> torch.Tensor:
        return (self.yzw.long() & 0x7FF).to(torch.float32)


NCOLS = 4  # packed int32 columns


def create_offset_map(capacity: int, voxel_size: float,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> OffsetVoxelMap:
    """An empty map. On the card it also runs once the device work of the
    insert's ``fusion.points_valid`` count (``_load_count_kernels``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        _load_count_kernels(dev)
    return _empty_map(capacity, torch.tensor(voxel_size, dtype=torch.float32,
                                             device=dev))


def _load_count_kernels(dev: torch.device) -> None:
    """The kernels of ``fusion.points_valid``'s count, as an insert under a
    profiler runs them: a bool mask's sum and its int64 accumulator's copy
    and add. Kernels load at their first launch, which stalls the card for
    milliseconds; run here, that falls in set-up and not in the first
    insert a profiler records."""
    total = torch.ones(1 << 16, dtype=torch.bool, device=dev).sum()
    total.to(torch.int64).clone().add_(total)


def _empty_map(capacity: int, voxel_size: torch.Tensor) -> OffsetVoxelMap:
    dev = voxel_size.device
    return OffsetVoxelMap(
        khi=torch.full((capacity,), INT_MAX, dtype=torch.int32, device=dev),
        klo_x=torch.full((capacity,), INT_MAX, dtype=torch.int32, device=dev),
        yzw=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        rgb=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        voxel_size=voxel_size,
    )


def _point_cols(points: PointSet, voxel_size: torch.Tensor):
    """PointSet -> the four packed int32 insert columns (weight 1 each)."""
    pm = points.mask
    zero = points.xyz.new_zeros(())
    # Zero masked rows before anything else: their xyz/rgb may be NaN.
    g = torch.where(pm[:, None], points.xyz, zero) / voxel_size
    cell = torch.floor(g)
    coords = cell.to(torch.int32)
    off = g - coords.to(torch.float32)
    rgb = torch.where(pm[:, None], points.rgb, zero)
    bhi, blo = pack_keys(coords[:, 0], coords[:, 1], coords[:, 2], pm)
    w1 = pm.long()                              # weight 1 valid, 0 invalid
    bklo_x = _pack_klo_x(blo, _q(off[:, 0], 10), pm)
    byzw = _pack_yzw(_q(off[:, 1], 10), _q(off[:, 2], 10), w1)
    brgb = _pack_rgb(rgb[:, 0], rgb[:, 1], rgb[:, 2])
    return (bhi, bklo_x, byzw, brgb)


def offset_map_insert(vm: OffsetVoxelMap, points: PointSet) -> OffsetVoxelMap:
    """Fuse a PointSet into the map; returns the new map.

    As ``txr`` donates its map state, the returned map is the only valid one
    afterwards: the implementation is free to reuse the old map's buffers.

    While a profiler records, it counts the rows it sorts, the batch's
    (``fusion.rows_sorted``), the map's rows it merges them into without a
    sort (``fusion.rows_merged``) and the batch's valid points
    (``fusion.points_valid``), none with a host sync.
    """
    cap = vm.khi.shape[0]
    with span("fusion.insert", points.xyz):
        cols = _insert_cols(vm, points)
        if recording():
            with span("fusion.insert.count", points.mask):
                count("fusion.rows_sorted", cols[0].shape[0] - cap)
                count("fusion.rows_merged", cap)
                count("fusion.points_valid", points.mask.sum())
        return _reduce_packed(cols, cap, vm.voxel_size)


def _insert_cols(vm: OffsetVoxelMap, points: PointSet):
    """The map's packed rows followed by the batch's."""
    with span("fusion.insert.pack", points.xyz):
        bcols = _point_cols(points, vm.voxel_size)
        return tuple(torch.cat([v, b]) for v, b in zip(vm[:NCOLS], bcols))


def offset_map_scan_inputs(vm: OffsetVoxelMap, points: PointSet):
    """What an insert of ``points`` hands to the segmented scan: the seven
    weighted f32 contribution columns of the key-sorted rows and the bool
    start flag of each voxel segment. The map is left as it was. For
    measuring the scan on an insert's real segment structure."""
    _, _, wcols, _, starts = _sorted_contributions(_insert_cols(vm, points))
    return wcols, starts


def offset_map_merge(a: OffsetVoxelMap, b: OffsetVoxelMap) -> OffsetVoxelMap:
    """Exact weighted merge of two offset maps (same voxel_size).

    Both maps' rows carry their accumulated u11 weights and the segment
    reduce sums weight-scaled mean offsets, so merging partial maps is the
    associative weighted-mean combine, not a weight-1 reinsertion of means.
    Output capacity = a's capacity.
    """
    cols = tuple(torch.cat([x, y.to(x.device)])
                 for x, y in zip(a[:NCOLS], b[:NCOLS]))
    return _reduce_packed(cols, a.khi.shape[0], a.voxel_size)


def _sort_keys(cols, head: int = 0):
    """The stable sort of the rows by the fused (khi, klo_x) int64 key: the
    sorted key and its permutation; the payload follows by gather. The
    first ``head`` rows must be in key order already (a map's rows are):
    only the rows after them are sorted, and merged with them; the result
    is that of the stable sort of all rows."""
    with span("fusion.insert.sort", cols[0]):
        key = row_keys(cols[0][head:], cols[1][head:])
        if head == 0:
            return torch.sort(key, stable=True)
        tail_key, tail_perm = torch.sort(key, stable=True)
        return merge_sorted(cols[0][:head], cols[1][:head], tail_key,
                            tail_perm)


def _sorted_contributions(cols, sorted_keys=None):
    """Sort the packed rows by voxel key (or take ``sorted_keys``, what
    ``_sort_keys(cols)`` returned) and unpack what the reduce sums.

    Returns (skhi, sklo, wcols, last, starts): the sorted key columns
    (int64), the seven weighted f32 contribution columns, and the bool
    flags of each voxel segment's last and first row.
    """
    n = cols[0].shape[0]
    dev = cols[0].device
    # Both keys come back out of the sorted key itself.
    skey, perm = sorted_keys or _sort_keys(cols)
    skhi = skey >> 32                     # int64, sign kept
    u = skey & _MASK32                    # klo_x with its sign xor undone
    sklo, u_x = u >> 10, u & 0x3FF
    u_yzw = cols[2][perm].long() & _MASK32
    u_rgb = cols[3][perm].long() & _MASK32
    w = (u_yzw & 0x7FF).to(torch.float32)
    rr, gg, bb = _unpack_rgb(u_rgb)
    # Weighted contributions; invalid rows (w=0) contribute nothing.
    wcols = (
        _dq(u_x, 10) * w,
        _dq((u_yzw >> 21) & 0x3FF, 10) * w,
        _dq((u_yzw >> 11) & 0x3FF, 10) * w,
        rr * w,
        gg * w,
        bb * w,
        w,
    )

    # Voxel-segment boundaries compare KEY bits only: klo_x's low 10 bits
    # are the x offset, which merely tie-breaks rows inside a segment.
    last = torch.ones((n,), dtype=torch.bool, device=dev)
    last[:-1] = (skhi[1:] != skhi[:-1]) | (sklo[1:] != sklo[:-1])
    starts = torch.roll(last, 1)        # row 0 rolls in last[n-1] == True
    return skhi, sklo, wcols, last, starts


def _reduce_packed(cols, cap: int, voxel_size) -> OffsetVoxelMap:
    """Sort the packed rows, of which the first ``cap`` are a map's (in key
    order), and reduce each voxel segment to one map row: the plain version
    on the CPU, the fused kernel on the card."""
    sorted_keys = _sort_keys(cols, cap)
    with span("fusion.insert.reduce", cols[0]):
        if cols[0].device.type == "cpu":
            return _reduce_unfused(cols, cap, voxel_size, sorted_keys)
        out = _empty_map(cap, voxel_size)
        offset_reduce(*sorted_keys, cols[2], cols[3], out[:NCOLS])
        return out


def _reduce_unfused(cols, cap: int, voxel_size,
                    sorted_keys=None) -> OffsetVoxelMap:
    """The reduce as separate PyTorch operations (and, for a CUDA tensor,
    the standalone scan kernel): the plain version of the fused kernel."""
    skhi, sklo, wcols, last, starts = _sorted_contributions(cols,
                                                            sorted_keys)

    # The value at a segment's END row is exactly that segment's total.
    seg = segmented_cumsum_cols(wcols, starts)

    # Compaction: the first `cap` segment-end rows in key order, so an
    # overflowing map drops its highest keys.
    ends = torch.nonzero(last).squeeze(1)[:cap]
    k = ends.shape[0]
    sums = torch.stack([s[ends] for s in seg], dim=1)        # (k, 7)
    ekhi = skhi[ends]
    eklo = sklo[ends]

    wgt = sums[:, 6]
    means = sums[:, :6] / wgt.clamp(min=1.0)[:, None]
    wq = wgt.clamp(0, W_MAX).long()
    occupied = (wgt > 0.0) & (ekhi != INT_MAX)
    klo_x = _pack_klo_x(eklo, _q(means[:, 0], 10), occupied)
    yzw = _pack_yzw(_q(means[:, 1], 10), _q(means[:, 2], 10), wq)
    orgb = _pack_rgb(means[:, 3], means[:, 4], means[:, 5])

    out = _empty_map(cap, voxel_size)
    out.khi[:k] = torch.where(occupied, ekhi.to(torch.int32),
                              torch.full_like(klo_x, INT_MAX))
    out.klo_x[:k] = klo_x
    out.yzw[:k] = torch.where(occupied, yzw, torch.zeros_like(yzw))
    out.rgb[:k] = torch.where(occupied, orgb, torch.zeros_like(orgb))
    return out


def offset_map_points(vm: OffsetVoxelMap) -> PointSet:
    sklo, u_x = _unpack_klo_x(vm.klo_x)
    kx, ky, kz = unpack_keys(vm.khi, sklo)
    u_yzw = vm.yzw.long() & _MASK32
    w = u_yzw & 0x7FF
    occ = (w > 0) & (vm.khi != INT_MAX)
    xyz = torch.stack([
        kx.to(torch.float32) + _dq(u_x, 10),
        ky.to(torch.float32) + _dq((u_yzw >> 21) & 0x3FF, 10),
        kz.to(torch.float32) + _dq((u_yzw >> 11) & 0x3FF, 10),
    ], dim=1) * vm.voxel_size
    rgb = torch.stack(_unpack_rgb(vm.rgb.long() & _MASK32), dim=1)
    zero = xyz.new_zeros(())
    return PointSet(
        xyz=torch.where(occ[:, None], xyz, zero),
        rgb=torch.where(occ[:, None], rgb, zero),
        mask=occ,
    )


def offset_map_size(vm: OffsetVoxelMap) -> torch.Tensor:
    """Occupied voxel count (0-d int32 tensor; reading it synchronises)."""
    w = vm.yzw.long() & 0x7FF
    return ((w > 0) & (vm.khi != INT_MAX)).sum(dtype=torch.int32)
