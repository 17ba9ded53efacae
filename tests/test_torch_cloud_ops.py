"""The fusion CLI's cloud ops, port against ``txr`` on the CPU: the
three-key segment reduces, voxel sums / means / downsampling, the exact and
grid kNN mean distances, ``auto_cell`` and both outlier passes.

The same numpy-seeded inputs go through both packages; the port runs with
CPU tensors, so with the plain version of the segmented-scan kernel.

Tolerances: keys, validity and kept masks equal; f32 values within 1e-5
(relative to the value, or absolute where stated). Where ``txr``'s global
cumulative sum is part of the difference (``sorted_voxel_reduce`` and the
voxel ops on top of it), the test measures ``txr``'s own error against a
float64 reduce of the same rows and holds the port to that budget plus
1e-6. ``test_reference_fault_at_65536_rows`` shows that budget growing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from txr.core.types import PointSet as JPointSet
from txr.ops import grid_knn as jgk
from txr.ops import outlier as jout
from txr.ops import segment as jseg
from txr.ops import voxel as jvox
from txr_torch.core.types import PointSet
from txr_torch.ops import grid_knn as pgk
from txr_torch.ops import outlier as pout
from txr_torch.ops import segment as pseg
from txr_torch.ops import voxel as pvox

torch.set_num_threads(1)
INT_MAX = np.iinfo(np.int32).max


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _f64_group_sums(keys, cols):
    """float64 sums of cols (N, D) per distinct key row, in ascending
    lexicographic key order."""
    uk, inv = np.unique(keys, axis=0, return_inverse=True)
    out = np.zeros((len(uk), cols.shape[1]), np.float64)
    np.add.at(out, inv.reshape(-1), cols.astype(np.float64))
    return uk, out


def _reduce_both(kx, ky, kz, cols, capacity):
    want = jseg.sorted_voxel_reduce(jnp.asarray(kx), jnp.asarray(ky),
                                    jnp.asarray(kz),
                                    tuple(jnp.asarray(c) for c in cols),
                                    capacity)
    got = pseg.sorted_voxel_reduce(T(kx), T(ky), T(kz),
                                   tuple(T(c) for c in cols), capacity)
    return got, want


def _case_keys(rng, case, n):
    if case == "small_range":
        k = rng.integers(0, 6, (3, n)).astype(np.int32)
    elif case == "negative_and_wide":
        # negative keys and extents far beyond 2^21 voxels
        k = rng.choice(np.array([-2 ** 31, -5_000_000, -1, 0, 3, 2 ** 22,
                                 2 ** 30, INT_MAX - 1], np.int32), (3, n))
    else:                                   # INT_MAX tail, zeroed columns
        k = rng.integers(-3, 3, (3, n)).astype(np.int32)
        k[:, n // 2:] = INT_MAX
    return k


@pytest.mark.parametrize("case", ["small_range", "negative_and_wide",
                                  "int_max_tail"])
def test_sorted_voxel_reduce_matches_txr(case):
    rng = np.random.default_rng(1)
    n = 3000
    kx, ky, kz = _case_keys(rng, case, n)
    cols = [rng.uniform(-30, 30, n).astype(np.float32) for _ in range(6)]
    w = np.ones(n, np.float32)
    if case == "int_max_tail":
        for c in cols:
            c[n // 2:] = 0.0
        w[n // 2:] = 0.0
    cols.append(w)
    got, want = _reduce_both(kx, ky, kz, cols, n)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(got[4]), _np(want[4]))
    # lexicographic order of the segments, and their float64 sums
    keys = np.stack([kx, ky, kz], 1)
    uk, ref = _f64_group_sums(keys, np.stack(cols, 1))
    valid = _np(got[4])
    assert valid.sum() == len(uk)
    np.testing.assert_array_equal(
        np.stack([_np(a) for a in got[:3]], 1)[valid], uk)
    g = np.stack([_np(c) for c in got[3]], 1)[valid]
    j = np.stack([_np(c) for c in want[3]], 1)[valid]
    budget = np.abs(j - ref).max()
    assert np.abs(g - ref).max() <= budget + 1e-6
    assert np.abs(g - j).max() <= 2 * budget + 1e-6


def test_sorted_voxel_reduce_capacity_and_all_invalid():
    rng = np.random.default_rng(2)
    n = 2000
    kx, ky, kz = _case_keys(rng, "small_range", n)
    cols = [rng.uniform(0, 2, n).astype(np.float32) for _ in range(7)]
    got, want = _reduce_both(kx, ky, kz, cols, 64)   # < 216 voxels
    assert _np(got[4]).all() and len(_np(got[4])) == 64
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_allclose(np.stack([_np(c) for c in got[3]]),
                               np.stack([_np(c) for c in want[3]]),
                               rtol=1e-5, atol=1e-4)
    dead = np.full(n, INT_MAX, np.int32)
    zero = [np.zeros(n, np.float32) for _ in range(7)]
    got, want = _reduce_both(dead, dead, dead, zero, n)
    # one INT_MAX segment of zero weight, then empty slots
    np.testing.assert_array_equal(_np(got[4]), _np(want[4]))
    assert _np(got[4]).sum() == 1
    assert (_np(got[0]) == INT_MAX).all()
    assert all((_np(c) == 0).all() for c in got[3])


@pytest.mark.parametrize("case", ["small_range", "negative_and_wide",
                                  "int_max_tail"])
def test_sorted_segment_reduce_at_ends_matches_txr(case):
    rng = np.random.default_rng(3)
    n = 2500
    kx, ky, kz = _case_keys(rng, case, n)
    cols = [rng.uniform(-5, 5, n).astype(np.float32) for _ in range(3)]
    for cap in (n, 1000):
        want = jseg.sorted_segment_reduce_at_ends(
            *(jnp.asarray(k) for k in (kx, ky, kz)),
            tuple(jnp.asarray(c) for c in cols), cap)
        got = pseg.sorted_segment_reduce_at_ends(
            T(kx), T(ky), T(kz), tuple(T(c) for c in cols), cap)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(got[4]), _np(want[4]))
        for a, b in zip(got[3], want[3]):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


def test_lexsort3_is_lexicographic_for_every_int32():
    rng = np.random.default_rng(4)
    edge = np.array([-2 ** 31, -2 ** 31 + 1, -2 ** 21 - 1, -1, 0, 1,
                     2 ** 21, 2 ** 21 + 1, 2 ** 31 - 2, INT_MAX], np.int32)
    k = rng.choice(edge, (3, 4000))
    perm = pseg.lexsort3(*(T(a) for a in k)).numpy()
    np.testing.assert_array_equal(perm, np.lexsort((k[2], k[1], k[0])))


def _cloud(rng, n, invalid=0.1):
    xyz = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                    rng.uniform(25, 50, n)], 1).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, n) > invalid
    return xyz, rgb, mask


def _both_sets(xyz, rgb, mask):
    return (JPointSet(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(mask)),
            PointSet(T(xyz), T(rgb), T(mask)))


def _voxel_ref(xyz, rgb, mask, vs, origin=None):
    """float64 per-voxel means of the valid rows, keyed as both packages
    key them (f32 (xyz - origin) / voxel_size, floored)."""
    o = xyz[mask].min(0) if origin is None else origin
    keys = np.floor((xyz[mask] - o) / np.float32(vs)).astype(np.int32)
    cols = np.concatenate([xyz[mask], rgb[mask],
                           np.ones((mask.sum(), 1), np.float32)], 1)
    uk, s = _f64_group_sums(keys, cols)
    return uk, s, s[:, :6] / s[:, 6:]


def test_voxel_downsample_matches_txr():
    rng = np.random.default_rng(5)
    xyz, rgb, mask = _cloud(rng, 6000)
    vs = 0.8
    jps, pps = _both_sets(xyz, rgb, mask)
    want = jvox.voxel_downsample(jps, vs)
    got = pvox.voxel_downsample(pps, vs)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    m = got.mask.numpy()
    _, _, ref = _voxel_ref(xyz, rgb, mask, vs)
    assert m.sum() == len(ref)
    g = np.concatenate([got.xyz.numpy(), got.rgb.numpy()], 1)[m]
    j = np.concatenate([np.asarray(want.xyz), np.asarray(want.rgb)], 1)[m]
    budget = np.abs(j - ref).max()
    assert np.abs(g - ref).max() <= budget + 1e-6
    assert (got.xyz.numpy()[~m] == 0).all()
    # all-invalid input: an empty cloud
    none = pvox.voxel_downsample(PointSet(T(xyz), T(rgb),
                                          T(np.zeros_like(mask))), vs)
    assert not none.mask.any() and (none.xyz == 0).all()


def test_voxel_sums_and_means_of_sums_match_txr():
    rng = np.random.default_rng(6)
    xyz, rgb, mask = _cloud(rng, 5000)
    vs = 1.0
    origin = np.array([-21.0, -21.0, 24.0], np.float32)
    jps, pps = _both_sets(xyz, rgb, mask)
    jk, js, jv, jn = jvox.voxel_sums(jps, vs, jnp.asarray(origin))
    pk, ps_, pv, pn = pvox.voxel_sums(pps, vs, T(origin))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert int(pn) == int(jn)
    uk, ref, _ = _voxel_ref(xyz, rgb, mask, vs, origin)
    np.testing.assert_array_equal(pk.numpy()[:int(pn)], uk)
    budget = np.abs(np.asarray(js)[:int(jn)] - ref).max()
    assert np.abs(ps_.numpy()[:int(pn)] - ref).max() <= budget + 1e-6
    assert (pk.numpy()[int(pn):] == INT_MAX).all()
    # the second half of the chunked merge: two halves' sums, re-reduced
    half = len(xyz) // 2
    parts = [pvox.voxel_sums(PointSet(T(xyz[s]), T(rgb[s]), T(mask[s])), vs,
                             T(origin)) for s in (slice(0, half),
                                                  slice(half, None))]
    keys = torch.cat([p[0] for p in parts])
    sums = torch.cat([p[1] for p in parts])
    got = pvox.voxel_means_of_sums(keys, sums)
    want = jvox.voxel_means_of_sums(jnp.asarray(keys.numpy()),
                                    jnp.asarray(sums.numpy()))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    m = got.mask.numpy()
    _, _, mref = _voxel_ref(xyz, rgb, mask, vs, origin)
    g = np.concatenate([got.xyz.numpy(), got.rgb.numpy()], 1)[m]
    j = np.concatenate([np.asarray(want.xyz), np.asarray(want.rgb)], 1)[m]
    budget = np.abs(j - mref).max()
    assert np.abs(g - mref).max() <= budget + 1e-6


def test_reference_fault_at_65536_rows():
    """txr's voxel means carry its global cumsum's round-off: at 65,536
    rows with z in 25 to 50 m and 5 cm voxels it is more than 1 cm off a
    float64 reduce of the same rows; the port's segmented sums stay within
    1e-5 m."""
    rng = np.random.default_rng(7)
    xyz, rgb, _ = _cloud(rng, 65536)
    mask = np.ones(len(xyz), bool)
    jps, pps = _both_sets(xyz, rgb, mask)
    got = pvox.voxel_downsample(pps, 0.05)
    want = jvox.voxel_downsample(jps, 0.05)
    _, _, ref = _voxel_ref(xyz, rgb, mask, 0.05)
    m = got.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(want.mask))
    port_err = np.abs(got.xyz.numpy()[m] - ref[:, :3]).max()
    txr_err = np.abs(np.asarray(want.xyz)[m] - ref[:, :3]).max()
    assert port_err <= 1e-5, port_err
    assert txr_err > 1e-2, txr_err


@pytest.mark.parametrize("n,chunk", [(900, 512), (300, 64)])
def test_knn_mean_distance_and_exact_outliers_match_txr(n, chunk):
    rng = np.random.default_rng(8)
    xyz = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    xyz[:5] += 6.0                      # planted outliers
    mask = rng.uniform(0, 1, n) > 0.05
    want = jout.knn_mean_distance(jnp.asarray(xyz), jnp.asarray(mask), k=10,
                                  chunk=chunk)
    got = pout.knn_mean_distance(T(xyz), T(mask), k=10, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    jps, pps = _both_sets(xyz, rgb, mask)
    jo = jout.remove_statistical_outliers(jps, 10, 2.0, chunk=chunk)
    po = pout.remove_statistical_outliers(pps, 10, 2.0, chunk=chunk)
    np.testing.assert_array_equal(po.mask.numpy(), np.asarray(jo.mask))
    np.testing.assert_array_equal(po.xyz.numpy(), np.asarray(jo.xyz))
    assert not po.mask.numpy()[:5].any()


def test_median_occupancy_and_auto_cell_match_txr():
    """The volumetric case (refine down), the planar ladder cases of
    tests/test_grid_knn.py (refine up), a compact cloud in a big masked
    buffer, and a far outlier cluster."""
    rng = np.random.default_rng(9)
    vol = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    vol[:20] += 5.0
    planar = rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    planar[:, 2] = 0.0
    g = np.linspace(-6.5, 6.5, 27, dtype=np.float32)
    gx, gy = np.meshgrid(g, g)
    lattice = np.stack([gx.ravel(), gy.ravel(),
                        np.full(27 * 27, 25.0, np.float32)], 1)
    compact = np.zeros((1 << 14, 3), np.float32)
    compact[:500] = rng.uniform(0, 0.05, (500, 3))
    cmask = np.zeros(1 << 14, bool)
    cmask[:500] = True
    for xyz, mask in ((vol, None), (planar, None), (lattice, None),
                      (compact, cmask)):
        mask = np.ones(len(xyz), bool) if mask is None else mask
        want = float(jgk.auto_cell(jnp.asarray(xyz), jnp.asarray(mask)))
        got = float(pgk.auto_cell(T(xyz), T(mask)))
        assert np.isfinite(got) and got > 0
        np.testing.assert_allclose(got, want, rtol=1e-5)
        lo = xyz[mask].min(0)
        mw = float(jgk._median_occupancy(
            jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(lo),
            jnp.float32(want)))
        mg = float(pgk._median_occupancy(
            T(xyz), T(mask), T(lo), torch.tensor(want, dtype=torch.float32)))
        assert mg == mw


def test_grid_knn_mean_distance_matches_txr_at_any_chunk():
    """Truncated windows included (per_cell 2): the same sorted order on
    both sides, so the same candidates. The port's result does not depend
    on the query chunk."""
    rng = np.random.default_rng(10)
    n = 3000
    xy = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    z = (0.1 * np.sin(8 * xy[:, 0])).astype(np.float32)
    xyz = np.column_stack([xy, z])
    xyz[:10] = rng.uniform(3, 4, (10, 3))
    mask = rng.uniform(0, 1, n) > 0.1
    cell = 3.0 / np.sqrt(n)
    for per_cell, chunks in ((2, (512, 1000, 4096)), (16, (512,))):
        want = np.asarray(jgk.grid_knn_mean_distance(
            jnp.asarray(xyz), jnp.asarray(mask), cell, k=8,
            per_cell=per_cell, chunk=512))
        got = [pgk.grid_knn_mean_distance(T(xyz), T(mask), cell, k=8,
                                          per_cell=per_cell, chunk=c).numpy()
               for c in chunks]
        np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-6)
        assert all(np.array_equal(got[0], g) for g in got[1:])
        assert (got[0][~mask] > 1e30).all()


def test_remove_statistical_outliers_grid_both_routes(monkeypatch):
    """Above 65,536 rows the grid route with an auto-tuned and a given
    cell, and its sentinel rules: a lone far point (the sentinel) is
    dropped and left out of the statistics, so the genuine outliers go
    too. At 65,536 rows and below the exact route (held against txr's at a
    small capacity; an exact pass over 65,536 rows is minutes on the
    CPU)."""
    rng = np.random.default_rng(11)
    dense = (rng.normal(size=(2000, 3)) * 0.1).astype(np.float32)
    genuine = np.array([[0.55, 0, 0], [-0.6, 0.1, 0]], np.float32)
    isolated = np.array([[5e4, 5e4, 5e4]], np.float32)
    xyz = np.concatenate([dense, genuine, isolated])
    rgb = rng.uniform(0, 1, xyz.shape).astype(np.float32)
    cap = (1 << 16) + 4096
    jps = JPointSet.from_numpy(xyz, rgb, capacity=cap)
    pps = PointSet.from_numpy(xyz, rgb, capacity=cap, device="cpu")
    for cell in (None, 0.3):
        want = jout.remove_statistical_outliers_grid(
            jps, cell, nb_neighbors=10, std_ratio=2.0, per_cell=32)
        got = pout.remove_statistical_outliers_grid(
            pps, cell, nb_neighbors=10, std_ratio=2.0, per_cell=32)
        m = got.mask.numpy()
        np.testing.assert_array_equal(m, np.asarray(want.mask))
        assert not m[len(xyz) - 3:].any() and m[:2000].sum() > 1800

    small = 4096
    want = jout.remove_statistical_outliers_grid(
        JPointSet.from_numpy(xyz, rgb, capacity=small), 0.3,
        nb_neighbors=10)
    got = pout.remove_statistical_outliers_grid(
        PointSet.from_numpy(xyz, rgb, capacity=small, device="cpu"), 0.3,
        nb_neighbors=10)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    exact = []
    monkeypatch.setattr(pout, "remove_statistical_outliers",
                        lambda p, **kw: exact.append(kw["chunk"]) or p)
    for rows in (1 << 16, (1 << 16) + 1):
        pout.remove_statistical_outliers_grid(
            PointSet.from_numpy(xyz[:64], capacity=rows, device="cpu"), 0.3)
    assert exact == [512]


def test_grid_route_keeps_every_sentinel_when_the_cell_is_mistuned():
    """More than a quarter of the valid points reading the no-neighbour
    sentinel means a mis-tuned cell: all of them are kept."""
    rng = np.random.default_rng(12)
    g = np.linspace(-6.5, 6.5, 27, dtype=np.float32)
    gx, gy = np.meshgrid(g, g)
    xyz = np.stack([gx.ravel(), gy.ravel(),
                    np.full(27 * 27, 25.0, np.float32)], 1)
    rgb = rng.uniform(0, 1, xyz.shape).astype(np.float32)
    cap = (1 << 16) + 2048
    cell = 0.05                               # far below the lattice step
    want = jout.remove_statistical_outliers_grid(
        JPointSet.from_numpy(xyz, rgb, capacity=cap), cell)
    got = pout.remove_statistical_outliers_grid(
        PointSet.from_numpy(xyz, rgb, capacity=cap, device="cpu"), cell)
    m = got.mask.numpy()
    np.testing.assert_array_equal(m, np.asarray(want.mask))
    assert m[:len(xyz)].all()
