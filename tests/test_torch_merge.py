"""The insert's sort of the batch alone, merged into the map's key-ordered
rows (``txr_torch/ops/merge.py``, ``txr_torch/fusion/offset_map.py``), on
the CPU at small sizes.

- ``merge_sorted_plain`` and the wrapper's CPU route give the sorted key
  and the permutation of ``torch.sort(stable=True)`` of all rows, bit for
  bit: ties of the full key between head and tail and within the tail,
  empty ``(INT_MAX, INT_MAX)`` rows on both sides, an empty tail, an
  all-invalid batch, no head, an overflowing map;
- every producer of a map leaves its rows in key order: create, insert,
  merge, the parallel pipeline's stacks and merged map (the stream step's
  state: ``tests/test_torch_stream_step.py``);
- seeded inserts, into a map that fills and overflows and into a voxel
  whose weight saturates, give the map that the sort of all rows gives;
- the insert counts the batch's rows as sorted and the map's as merged;
- the wrapper refuses what the kernel would not take, and
  ``merge_geometry`` is the kernel's tiling.
"""

import pytest
import torch

from txr_torch.core.types import PointSet
from txr_torch.fusion import offset_map as om
from txr_torch.ops import merge
from txr_torch.ops.merge import (MAX_ROWS, PART_THREADS, TILE,
                                 merge_geometry, merge_sorted,
                                 merge_sorted_plain, row_keys)
from txr_torch.ops.segment import INT_MAX
from txr_torch.parallel.pipeline import merge_sharded_maps
from txr_torch.utils import profiling

I32 = torch.iinfo(torch.int32)


def key_ordered(vm) -> bool:
    k = row_keys(vm.khi, vm.klo_x)
    return bool((k[1:] >= k[:-1]).all())


def head_rows(n_keys: int, n_empty: int, gen: torch.Generator):
    """A map's key columns: ``n_keys`` distinct random keys in key order,
    then ``n_empty`` empty rows."""
    khi = torch.randint(I32.min, I32.max, (n_keys,), generator=gen,
                        dtype=torch.int32)
    klo = torch.randint(I32.min, I32.max, (n_keys,), generator=gen,
                        dtype=torch.int32)
    key = torch.unique(row_keys(khi, klo))      # sorted, distinct
    khi, klo = (key >> 32).to(torch.int32), \
        ((key & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    empty = torch.full((n_empty,), INT_MAX, dtype=torch.int32)
    return torch.cat([khi, empty]), torch.cat([klo, empty])


def tail_rows(khi, klo, n_new: int, n_copies: int, n_empty: int,
              gen: torch.Generator):
    """A batch's key columns in no order: new random keys, copies of head
    keys (ties of the full key with the head) each twice (ties within the
    tail), and empty rows."""
    nkhi = torch.randint(I32.min, I32.max, (n_new,), generator=gen,
                         dtype=torch.int32)
    nklo = torch.randint(I32.min, I32.max, (n_new,), generator=gen,
                         dtype=torch.int32)
    pick = torch.randint(0, max(khi.shape[0], 1), (n_copies,), generator=gen)
    ckhi = khi[pick] if khi.shape[0] else nkhi[:0]
    cklo = klo[pick] if klo.shape[0] else nklo[:0]
    empty = torch.full((n_empty,), INT_MAX, dtype=torch.int32)
    tkhi = torch.cat([nkhi, ckhi, ckhi, empty])
    tklo = torch.cat([nklo, cklo, cklo, empty])
    order = torch.randperm(tkhi.shape[0], generator=gen)
    return tkhi[order], tklo[order]


# name -> (head keys, head empties, tail new, tail copies, tail empties)
CASES = {
    "ties_and_empties": (300, 200, 150, 60, 40),
    "full_head_all_tied": (400, 0, 0, 200, 0),
    "empty_head_rows_only": (0, 256, 100, 0, 30),
    "empty_tail": (500, 100, 0, 0, 0),
    "all_invalid_batch": (500, 100, 0, 0, 300),
    "no_head": (0, 0, 400, 0, 50),
    "overflow": (1024, 0, 2000, 100, 0),
    "many_tiles": (3 * TILE + 5, 77, TILE + 3, 500, 9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_equals_stable_sort_of_all_rows(case):
    n_keys, n_empty, n_new, n_copies, n_tail_empty = CASES[case]
    gen = torch.Generator().manual_seed(sorted(CASES).index(case))
    khi, klo = head_rows(n_keys, n_empty, gen)
    tkhi, tklo = tail_rows(khi, klo, n_new, n_copies, n_tail_empty, gen)
    tail_key, tail_perm = torch.sort(row_keys(tkhi, tklo), stable=True)
    want_key, want_perm = torch.sort(
        row_keys(torch.cat([khi, tkhi]), torch.cat([klo, tklo])),
        stable=True)
    for fn in (merge_sorted_plain, merge_sorted):
        skey, perm = fn(khi, klo, tail_key, tail_perm)
        assert skey.dtype == perm.dtype == torch.int64
        assert torch.equal(skey, want_key), fn.__name__
        assert torch.equal(perm, want_perm), fn.__name__


def test_row_keys_order_is_the_pairs_order():
    """The int64 key orders rows as (khi, klo_x) signed, lexicographically,
    at the ends of the int32 range too."""
    vals = torch.tensor([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1,
                         I32.max], dtype=torch.int32)
    khi, klo = torch.meshgrid(vals, vals, indexing="ij")
    khi, klo = khi.reshape(-1), klo.reshape(-1)
    k = row_keys(khi, klo)
    assert bool((k[1:] > k[:-1]).all())
    assert int(k[-1]) == (INT_MAX << 32) | 0xFFFFFFFF


def points(n: int, gen: torch.Generator, extent: float = 2.0,
           valid: float = 0.9) -> PointSet:
    return PointSet(torch.rand(n, 3, generator=gen) * extent,
                    torch.rand(n, 3, generator=gen),
                    torch.rand(n, generator=gen) < valid)


def test_create_and_inserts_keep_key_order():
    gen = torch.Generator().manual_seed(1)
    vm = om.create_offset_map(2048, 0.05, "cpu")
    assert key_ordered(vm)
    sizes = []
    for _ in range(4):                       # fills, then overflows
        vm = om.offset_map_insert(vm, points(1500, gen))
        assert key_ordered(vm)
        sizes.append(int(om.offset_map_size(vm)))
    assert sizes[0] < 2048 and sizes[-1] == 2048


def test_merge_and_the_pipelines_maps_keep_key_order():
    gen = torch.Generator().manual_seed(2)
    maps = [om.offset_map_insert(om.create_offset_map(1024, 0.05, "cpu"),
                                 points(600, gen)) for _ in range(3)]
    merged = om.offset_map_merge(maps[0], maps[1])
    assert key_ordered(merged)
    # the parallel pipeline's (dp, C) stack: each row a map, and the merge
    # tree over it (the odd map carried to the next round)
    stacked = om.OffsetVoxelMap(*[torch.stack([m[c] for m in maps])
                                  for c in range(om.NCOLS)],
                                maps[0].voxel_size)
    for i in range(3):
        assert key_ordered(om.OffsetVoxelMap(
            *[c[i] for c in stacked[:om.NCOLS]], stacked.voxel_size))
    tree = merge_sharded_maps(stacked)
    assert key_ordered(tree)
    assert int(om.offset_map_size(tree)) >= int(om.offset_map_size(merged))


def whole_sort_insert(vm, pts):
    """The insert as it was before the merge: the stable sort of all
    rows, then the same reduce."""
    cols = om._insert_cols(vm, pts)
    cap = vm.khi.shape[0]
    return om._reduce_unfused(cols, cap, vm.voxel_size, om._sort_keys(cols))


def assert_maps_equal(got, want):
    for g, w in zip(got[:om.NCOLS], want[:om.NCOLS]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_equals_the_whole_sort(seed):
    """Seeded inserts into a map that fills and then overflows: the map and
    the sorted rows of each insert equal the whole sort's."""
    gen = torch.Generator().manual_seed(100 + seed)
    vm = om.create_offset_map(1024, 0.04, "cpu")
    for i in range(5):
        pts = points(400 + 150 * i, gen, valid=0.8)
        cols = om._insert_cols(vm, pts)
        got_keys = om._sort_keys(cols, vm.khi.shape[0])
        want_keys = om._sort_keys(cols)
        assert torch.equal(got_keys[0], want_keys[0])
        assert torch.equal(got_keys[1], want_keys[1])
        new = om.offset_map_insert(vm, pts)
        assert_maps_equal(new, whole_sort_insert(vm, pts))
        vm = new
    assert int(om.offset_map_size(vm)) == 1024


def test_insert_equals_the_whole_sort_at_a_saturating_voxel():
    """Two inserts of 3,000 rows into one voxel: its weight saturates at
    2047 and its rows tie on the key with the map's row."""
    n = 3000
    one = PointSet(torch.full((n, 3), 0.25), torch.tensor(
        [[0.5, 0.25, 0.75]]).expand(n, 3).contiguous(),
        torch.ones((n,), dtype=torch.bool))
    vm = om.create_offset_map(64, 1.0, "cpu")
    for _ in range(2):
        new = om.offset_map_insert(vm, one)
        assert_maps_equal(new, whole_sort_insert(vm, one))
        vm = new
    assert int((vm.yzw & 0x7FF).max()) == om.W_MAX
    assert key_ordered(vm)


def test_merge_of_two_maps_equals_the_whole_sort():
    gen = torch.Generator().manual_seed(3)
    a = om.offset_map_insert(om.create_offset_map(512, 0.05, "cpu"),
                             points(700, gen))
    b = om.offset_map_insert(om.create_offset_map(512, 0.05, "cpu"),
                             points(700, gen))
    cols = tuple(torch.cat([x, y]) for x, y in zip(a[:om.NCOLS],
                                                   b[:om.NCOLS]))
    want = om._reduce_unfused(cols, 512, a.voxel_size, om._sort_keys(cols))
    assert_maps_equal(om.offset_map_merge(a, b), want)


@pytest.mark.parametrize("inserts", [1, 3])
def test_insert_counts_the_batch_as_sorted_and_the_map_as_merged(inserts):
    gen = torch.Generator().manual_seed(4)
    cap = 1024
    batches = [points(500 + 10 * i, gen) for i in range(inserts)]
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        vm = om.create_offset_map(cap, 0.05, "cpu")
        for b in batches:
            vm = om.offset_map_insert(vm, b)
    got = profiling.counters()
    profiling.reset_counters()
    assert got["fusion.rows_sorted"] == sum(b.mask.shape[0] for b in batches)
    assert got["fusion.rows_merged"] == cap * inserts


def operands(nh=8, nt=4):
    khi, klo = head_rows(nh, 0, torch.Generator().manual_seed(5))
    key, perm = torch.sort(torch.arange(nt, 0, -1, dtype=torch.int64),
                           stable=True)
    return [khi, klo, key, perm]


@pytest.mark.parametrize("fault", ["dtype", "device", "contiguity",
                                   "alignment", "pairing", "dims"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    args = operands()
    if fault == "dtype":
        args[2] = args[2].to(torch.int32)
        err = TypeError
    elif fault == "device":
        args[3] = torch.empty(4, dtype=torch.int64, device="meta")
        err = ValueError
    elif fault == "contiguity":
        args[0] = torch.cat([args[0], args[0]])[::2]
        err = ValueError
    elif fault == "alignment":
        args[1] = torch.cat([args[1][:1], args[1]])[1:]
        err = ValueError
    elif fault == "pairing":
        args[1] = args[1][:4].clone()
        err = ValueError
    else:
        args[0] = args[0].reshape(2, 4)
        err = TypeError
    with pytest.raises(err):
        merge_sorted(*args)
    with pytest.raises(err):
        merge.require_merge_operands(*args)


def test_merge_geometry_is_the_kernels_tiling():
    assert merge.TILE == merge.THREADS * merge.ITEMS
    for nh, nt, tiles in ((0, 0, 0), (1, 0, 1), (0, 1, 1), (TILE - 1, 1, 1),
                          (TILE, 1, 2), (1 << 26, 3_829_056, 34_638),
                          (1 << 26, 7_658_112, 36_508)):
        geo = merge_geometry(nh, nt)
        assert geo["tiles"] == tiles == -(-(nh + nt) // TILE)
        assert geo["rows"] == nh + nt
        assert geo["splits"] == tiles + 1
        assert geo["partition_blocks"] * PART_THREADS >= tiles + 1 > \
            (geo["partition_blocks"] - 1) * PART_THREADS
        assert geo["scratch_bytes"] == 4 * (tiles + 1)
        assert merge_geometry(nh, nt) == geo           # pure
    assert merge_geometry(MAX_ROWS, 0)["tiles"] * TILE < 2 ** 31
    for nh, nt in ((-1, 0), (0, -1), (MAX_ROWS, 1)):
        with pytest.raises(ValueError):
            merge_geometry(nh, nt)
    assert merge.require_merge_operands(*operands(8, 4)) == \
        merge_geometry(8, 4)
