"""Keys, back-projection and the packed voxel map of the port against
``txr`` on the same inputs (CPU, plain version of the scan)."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from txr.core.types import PointSet as JPointSet
from txr.fusion import keys as jk
from txr.fusion import offset_map as jo

from txr_torch.core.types import PointSet, concatenate
from txr_torch.fusion import keys as pk
from txr_torch.fusion import offset_map as po
from txr_torch.ops import backproject as pb

torch.set_num_threads(1)

# txr.ops re-exports a function named backproject over the module
jb = importlib.import_module("txr.ops.backproject")

INT32_MAX = np.iinfo(np.int32).max


def jps(xyz, rgb, mask):
    return JPointSet(jnp.asarray(xyz), jnp.asarray(rgb), jnp.asarray(mask))


def tps(xyz, rgb, mask):
    return PointSet(torch.from_numpy(xyz), torch.from_numpy(rgb),
                    torch.from_numpy(mask))


def weights(yzw) -> np.ndarray:
    return np.asarray(yzw).astype(np.uint32) & 0x7FF


def assert_maps_agree(got: po.OffsetVoxelMap, want: jo.OffsetVoxelMap):
    """Identical key columns and occupancy; weights equal; offsets and
    colors within one u10 / u8 quantum (a mean that lands on a quantization
    step may round either way when the sums are taken in another order)."""
    gk, wk = got.khi.numpy(), np.asarray(want.khi)
    np.testing.assert_array_equal(gk, wk)
    gx = got.klo_x.numpy().astype(np.int64)
    wx = np.asarray(want.klo_x).astype(np.int64)
    np.testing.assert_array_equal(gx >> 10, wx >> 10)       # key bits
    gy, wy = got.yzw.numpy(), np.asarray(want.yzw)
    np.testing.assert_array_equal(weights(gy), weights(wy))
    occ = weights(wy) > 0
    assert int(po.offset_map_size(got)) == int(jo.offset_map_size(want)) \
        == int(occ.sum())
    assert np.abs((gx & 0x3FF) - (wx & 0x3FF))[occ].max(initial=0) <= 1
    gu, wu = gy.astype(np.uint32), wy.astype(np.uint32)
    for shift in (21, 11):
        a = ((gu >> shift) & 0x3FF).astype(np.int64)
        b = ((wu >> shift) & 0x3FF).astype(np.int64)
        assert np.abs(a - b)[occ].max(initial=0) <= 1
    gr, wr = got.rgb.numpy(), np.asarray(want.rgb)
    for shift in (16, 8, 0):
        a = (gr >> shift) & 0xFF
        b = (wr >> shift) & 0xFF
        assert np.abs(a - b)[occ].max(initial=0) <= 1


class TestKeys:
    def test_pack_unpack_bit_equal(self):
        rng = np.random.default_rng(0)
        hr = jk.HALF_RANGE
        assert pk.HALF_RANGE == hr
        corners = np.array([[s * (hr + d)] * 3 for s in (-1, 1)
                            for d in (-3, -2, -1, 0, 1, 5)] +
                           [[-hr, hr, 0], [hr - 2, -hr + 1, hr - 1],
                            [0, 0, 0], [-1, -1, -1], [1 << 20, -(1 << 20), 7]],
                           np.int32)
        k = np.concatenate([corners, rng.integers(-hr - 10, hr + 10,
                                                  (500, 3)).astype(np.int32)])
        valid = rng.random(len(k)) < 0.8
        valid[:len(corners)] = True
        whi, wlo = jk.pack_keys(*(jnp.asarray(k[:, i]) for i in range(3)),
                                jnp.asarray(valid))
        ghi, glo = pk.pack_keys(*(torch.from_numpy(k[:, i].copy())
                                  for i in range(3)),
                                torch.from_numpy(valid))
        assert ghi.dtype == glo.dtype == torch.int32
        np.testing.assert_array_equal(ghi.numpy(), np.asarray(whi))
        np.testing.assert_array_equal(glo.numpy(), np.asarray(wlo))
        assert (ghi.numpy()[~valid] == INT32_MAX).all()
        assert (ghi.numpy()[valid] < INT32_MAX).all()
        wx = jk.unpack_keys(whi, wlo)
        gx = pk.unpack_keys(ghi, glo)
        for g, w in zip(gx, wx):          # invalid rows included
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # order preserved: packed (hi, lo) sorts as (x, y, z) does
        kk = np.clip(k[valid], -hr + 1, hr - 2).astype(np.int64)
        order = np.lexsort((kk[:, 2], kk[:, 1], kk[:, 0]))
        packed = (ghi.numpy()[valid].astype(np.int64) << 32) + \
            glo.numpy()[valid]
        assert (np.diff(packed[order]) >= 0).all()

    def test_packed_columns_bit_equal(self):
        rng = np.random.default_rng(1)
        n = 300
        lo = rng.integers(0, 1 << 22, n).astype(np.int32)
        off = rng.random(n).astype(np.float32)
        valid = rng.random(n) < 0.9
        w = rng.integers(0, 5000, n)
        want = jo._pack_klo_x(jnp.asarray(lo), jo._q(jnp.asarray(off), 10),
                              jnp.asarray(valid))
        got = po._pack_klo_x(torch.from_numpy(lo),
                             po._q(torch.from_numpy(off), 10),
                             torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for g, w_ in zip(po._unpack_klo_x(got), jo._unpack_klo_x(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        off2 = rng.random(n).astype(np.float32)
        want = jo._pack_yzw(jo._q(jnp.asarray(off), 10),
                            jo._q(jnp.asarray(off2), 10),
                            jnp.asarray(w, jnp.uint32))
        got = po._pack_yzw(po._q(torch.from_numpy(off), 10),
                           po._q(torch.from_numpy(off2), 10),
                           torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        c = rng.random((3, n)).astype(np.float32)
        c[:, :3] = [[0.0, 1.0, 0.999999], [1.0, 0.0, 0.5], [0.25, 0.75, 1.0]]
        want = jo._pack_rgb(*(jnp.asarray(x) for x in c))
        got = po._pack_rgb(*(torch.from_numpy(x) for x in c))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestBackproject:
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("integer_rgb", [False, True])
    def test_backproject_world_matches_txr(self, stride, integer_rgb):
        """1e-6 relative, 2e-6 absolute on coordinates of a few metres: the
        same f32 operations, the world transform summed as three scaled
        adds here and as a product there. Masks are identical."""
        rng = np.random.default_rng(2)
        h, w = 23, 31
        depth = rng.uniform(0.0, 4.0, (h, w)).astype(np.float32)
        depth[0, :5] = [np.nan, np.inf, -1.0, 0.05, 60.0]
        if integer_rgb:
            rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            rgb = rng.random((h, w, 3)).astype(np.float32)
        a = rng.standard_normal((3, 3))
        R = np.linalg.qr(a)[0].astype(np.float32)
        t = rng.standard_normal(3).astype(np.float32)
        args = (20.5, 21.5, 15.2, 11.1, 0.1, 50.0, 1.25, stride)
        want = jb.backproject_world(jnp.asarray(depth), jnp.asarray(rgb),
                                    jnp.asarray(R), jnp.asarray(t), *args)
        got = pb.backproject_world(torch.from_numpy(depth),
                                   torch.from_numpy(rgb),
                                   torch.from_numpy(R), torch.from_numpy(t),
                                   *args)
        np.testing.assert_array_equal(got.mask.numpy(),
                                      np.asarray(want.mask))
        assert 0 < int(got.count()) < got.capacity
        np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz),
                                   rtol=1e-6, atol=2e-6)
        np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb),
                                   rtol=1e-6, atol=1e-7)
        assert (got.xyz.numpy()[~got.mask.numpy()] == 0).all()

    def test_batched_form_equals_per_frame(self):
        rng = np.random.default_rng(3)
        depth = rng.uniform(0.5, 3.0, (3, 9, 11)).astype(np.float32)
        rgb = rng.random((3, 9, 11, 3)).astype(np.float32)
        eye, zero = torch.eye(3), torch.zeros(3)
        batched = pb.backproject_world(torch.from_numpy(depth),
                                       torch.from_numpy(rgb), eye, zero,
                                       8.0, 8.0, 5.0, 4.0)
        assert batched.xyz.shape == (3, 99, 3)
        want = jb.backproject_batch(jnp.asarray(depth), jnp.asarray(rgb),
                                    8.0, 8.0, 5.0, 4.0, 0.1, 50.0, 1.0, 1)
        np.testing.assert_allclose(batched.xyz.numpy(),
                                   np.asarray(want.xyz), rtol=1e-6,
                                   atol=1e-6)
        for i in range(3):
            one = pb.backproject(torch.from_numpy(depth[i]),
                                 torch.from_numpy(rgb[i]), 8.0, 8.0, 5.0, 4.0)
            assert torch.equal(one.xyz, batched.xyz[i])
            assert torch.equal(one.mask, batched.mask[i])


class TestPointSet:
    def test_container_roundtrip(self):
        rng = np.random.default_rng(4)
        xyz = rng.standard_normal((5, 3)).astype(np.float32)
        ps = PointSet.from_numpy(xyz, capacity=8, device="cpu")
        assert ps.capacity == 8 and int(ps.count()) == 5
        assert (ps.xyz[5:] == 0).all()
        both = concatenate([ps, PointSet.empty(3, device="cpu")]).to("cpu")
        assert both.capacity == 11 and int(both.count()) == 5
        got_xyz, got_rgb = both.to_numpy()
        np.testing.assert_array_equal(got_xyz, xyz)
        assert got_rgb.shape == (5, 3)
        want = JPointSet.from_numpy(xyz, capacity=8).to_numpy()
        np.testing.assert_array_equal(ps.to_numpy()[0], want[0])
        assert PointSet.from_numpy(xyz, capacity=3,
                                   device="cpu").to_numpy()[0].shape == (3, 3)


class TestOffsetMapParity:
    def test_three_inserts_match_txr(self):
        rng = np.random.default_rng(5)
        voxel = 0.05
        want = jo.create_offset_map(4096, voxel)
        got = po.create_offset_map(4096, voxel, device="cpu")
        for i in range(3):
            xyz = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
            rgb = rng.random((1500, 3)).astype(np.float32)
            mask = rng.random(1500) < 0.9
            xyz[~mask] = np.nan
            want = jo.offset_map_insert(want, jps(xyz, rgb, mask))
            got = po.offset_map_insert(got, tps(xyz, rgb, mask))
            assert_maps_agree(got, want)
        assert 0 < int(po.offset_map_size(got)) < 4096
        gp = po.offset_map_points(got)
        wp = jo.offset_map_points(want)
        np.testing.assert_array_equal(gp.mask.numpy(), np.asarray(wp.mask))
        # one quantum of the stored offset / color, plus f32 rounding
        np.testing.assert_allclose(gp.xyz.numpy(), np.asarray(wp.xyz),
                                   rtol=0, atol=voxel / 1024 * 1.01)
        np.testing.assert_allclose(gp.rgb.numpy(), np.asarray(wp.rgb),
                                   rtol=0, atol=1.01 / 256)
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want.count))

    def test_merge_matches_txr(self):
        rng = np.random.default_rng(6)
        voxel = 0.1
        maps = []
        for _ in range(2):
            xyz = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
            rgb = rng.random((2000, 3)).astype(np.float32)
            m = np.ones(2000, bool)
            maps.append((
                jo.offset_map_insert(jo.create_offset_map(8192, voxel),
                                     jps(xyz, rgb, m)),
                po.offset_map_insert(
                    po.create_offset_map(8192, voxel, device="cpu"),
                    tps(xyz, rgb, m))))
        want = jo.offset_map_merge(maps[0][0], maps[1][0])
        got = po.offset_map_merge(maps[0][1], maps[1][1])
        assert_maps_agree(got, want)
        assert weights(got.yzw.numpy()).max() > 1

    def test_far_corner_voxel_not_dropped(self):
        """A point clamped to the +range corner in all axes must not pack to
        the empty sentinel."""
        voxel = 0.01
        far = np.float32(1 << 18) * voxel
        xyz = np.array([[far, far, far], [0.0, 0.0, 0.0]], np.float32)
        rgb = np.full((2, 3), 0.5, np.float32)
        m = np.ones(2, bool)
        vm = po.offset_map_insert(po.create_offset_map(64, voxel,
                                                       device="cpu"),
                                  tps(xyz, rgb, m))
        assert int(po.offset_map_size(vm)) == 2
        occ = weights(vm.yzw.numpy()) > 0
        assert (vm.khi.numpy()[occ] < INT32_MAX).all()
        assert (vm.klo_x.numpy()[occ] < INT32_MAX).all()
        assert_maps_agree(vm, jo.offset_map_insert(
            jo.create_offset_map(64, voxel), jps(xyz, rgb, m)))

    def test_overflow_drops_highest_keys(self):
        rng = np.random.default_rng(3)
        xyz = rng.uniform(0, 10, (2000, 3)).astype(np.float32)
        p = po.offset_map_insert(
            po.create_offset_map(16, 0.01, device="cpu"),
            PointSet.from_numpy(xyz, device="cpu"))
        assert int(po.offset_map_size(p)) == 16
        hi = p.khi.numpy().astype(np.int64)
        assert np.all(np.diff(hi) >= 0)
        want = jo.offset_map_insert(jo.create_offset_map(16, 0.01),
                                    JPointSet.from_numpy(xyz))
        assert_maps_agree(p, want)

    def test_empty_and_masked(self):
        p = po.create_offset_map(32, 0.1, device="cpu")
        p = po.offset_map_insert(p, PointSet.empty(50, device="cpu"))
        assert int(po.offset_map_size(p)) == 0
        xyz = np.zeros((10, 3), np.float32)
        xyz[0] = np.nan                      # masked garbage must not poison
        mask = np.zeros(10, bool)
        mask[3] = True
        p = po.offset_map_insert(p, tps(xyz, np.zeros((10, 3), np.float32),
                                        mask))
        assert int(po.offset_map_size(p)) == 1
        pts, _ = po.offset_map_points(p).to_numpy()
        assert np.isfinite(pts).all() and len(pts) == 1

    def test_weight_saturation(self):
        p = po.create_offset_map(64, 1.0, device="cpu")
        n = 50000
        one = tps(np.tile(np.array([[0.25, 0.25, 0.25]], np.float32), (n, 1)),
                  np.tile(np.array([[0.5, 0.25, 0.75]], np.float32), (n, 1)),
                  np.ones(n, bool))
        p = po.offset_map_insert(p, one)
        p = po.offset_map_insert(p, one)     # 100k raw observations
        w = float(p.count.max())
        assert w == po.W_MAX == jo.W_MAX
        pts, cols = po.offset_map_points(p).to_numpy()
        assert len(pts) == 1
        assert np.allclose(pts[0], [0.25, 0.25, 0.25], atol=1e-3)
        assert np.allclose(cols[0], [0.5, 0.25, 0.75], atol=0.01)

    def test_stable_mean_no_drift(self):
        """Re-inserting disjoint points must not move untouched voxels."""
        p = po.create_offset_map(256, 1.0, device="cpu")
        a = tps(np.array([[0.3, 0.6, 0.9]], np.float32),
                np.array([[0.2, 0.4, 0.8]], np.float32), np.ones(1, bool))
        p = po.offset_map_insert(p, a)
        ref = po.offset_map_points(p).to_numpy()
        for i in range(10):
            other = tps(np.array([[10.0 + i, 0.0, 0.0]], np.float32),
                        np.ones((1, 3), np.float32), np.ones(1, bool))
            p = po.offset_map_insert(p, other)
        pts, cols = po.offset_map_points(p).to_numpy()
        sel = np.argmin(np.abs(pts[:, 0] - 0.3))
        assert np.allclose(pts[sel], ref[0][0], atol=1e-6)
        assert np.allclose(cols[sel], ref[1][0], atol=1e-6)


class TestReduceAcrossTiles:
    """What the fused reduce on the card must also get right, held here
    against txr through the port's plain route (the scan kernel's tile is
    2048 rows, ``txr_torch.ops.scan.TILE``)."""

    def test_one_voxel_longer_than_a_tile(self):
        rng = np.random.default_rng(7)
        n = 5000                      # 3000 rows in one voxel, then others
        xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        xyz[:3000] = rng.uniform(0.30, 0.34, (3000, 3))
        rgb = rng.random((n, 3)).astype(np.float32)
        m = np.ones(n, bool)
        want = jo.offset_map_insert(jo.create_offset_map(4096, 0.05),
                                    jps(xyz, rgb, m))
        got = po.offset_map_insert(po.create_offset_map(4096, 0.05,
                                                        device="cpu"),
                                   tps(xyz, rgb, m))
        assert_maps_agree(got, want)
        assert weights(got.yzw.numpy()).max() == po.W_MAX   # 3000 rows

    def test_rows_not_a_multiple_of_the_tile(self):
        rng = np.random.default_rng(8)
        vm_j = jo.create_offset_map(1000, 0.1)
        vm_p = po.create_offset_map(1000, 0.1, device="cpu")
        for n in (1501, 2049):        # 2501 and 3049 rows with the map
            xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
            rgb = rng.random((n, 3)).astype(np.float32)
            m = rng.random(n) < 0.95
            vm_j = jo.offset_map_insert(vm_j, jps(xyz, rgb, m))
            vm_p = po.offset_map_insert(vm_p, tps(xyz, rgb, m))
            assert_maps_agree(vm_p, vm_j)

    def test_all_invalid_batch_into_a_non_empty_map(self):
        rng = np.random.default_rng(9)
        xyz = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
        rgb = rng.random((700, 3)).astype(np.float32)
        m = np.ones(700, bool)
        vm_p = po.offset_map_insert(po.create_offset_map(1024, 0.1,
                                                         device="cpu"),
                                    tps(xyz, rgb, m))
        vm_j = jo.offset_map_insert(jo.create_offset_map(1024, 0.1),
                                    jps(xyz, rgb, m))
        dead = np.full((300, 3), np.nan, np.float32)
        none = np.zeros(300, bool)
        got = po.offset_map_insert(vm_p, tps(dead, dead, none))
        assert_maps_agree(got, jo.offset_map_insert(vm_j,
                                                    jps(dead, dead, none)))
        for g, w in zip(got[:po.NCOLS], vm_p[:po.NCOLS]):
            assert torch.equal(g, w)           # a stable map stays bit-equal

    @pytest.mark.parametrize("cap", [64, 200])
    def test_overflow_and_saturation_at_a_capacity(self, cap):
        rng = np.random.default_rng(cap)
        xyz = rng.uniform(0, 10, (2100 + 3 * cap, 3)).astype(np.float32)
        xyz[:2100] = [0.005, 0.005, 0.005]     # one voxel past 2047 rows
        rgb = rng.random((len(xyz), 3)).astype(np.float32)
        m = np.ones(len(xyz), bool)
        got = po.offset_map_insert(po.create_offset_map(cap, 0.01,
                                                        device="cpu"),
                                   tps(xyz, rgb, m))
        want = jo.offset_map_insert(jo.create_offset_map(cap, 0.01),
                                    jps(xyz, rgb, m))
        assert_maps_agree(got, want)
        assert int(po.offset_map_size(got)) == cap
        assert weights(got.yzw.numpy()).max() == po.W_MAX
        assert np.all(np.diff(got.khi.numpy().astype(np.int64)) >= 0)
