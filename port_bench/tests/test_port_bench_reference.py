"""The plain reference against the port (``txr_torch``) on the CPU at a
small size: the same depth in float32, the same points bit for bit, and
the same voxel map over two inserts, one into a map that overflows."""

import pytest
import torch

from port_bench.lib import inputs, spec, weights
from port_bench.reference import depth_anything_v2 as ref
from port_bench.reference import geometry, voxel_map
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import create_offset_map, offset_map_insert
from txr_torch.models.depth_anything import DepthAnything
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.ops.backproject import backproject_world

VITL = spec.load_json(spec.BENCH_DIR / "configs" / "da2-vitl-metric.json")
DA2 = spec.architecture(VITL)
SMALL = dict(VITL, hidden_size=64, num_hidden_layers=3,
             num_attention_heads=2, out_indices=[0, 1, 1, 2], features=16,
             out_channels=[8, 16, 32, 32])


def port_model(cfg, w):
    vit = ViTConfig(cfg["hidden_size"], cfg["num_hidden_layers"],
                    cfg["num_attention_heads"],
                    out_layers=tuple(cfg["out_indices"]))
    dpt = DPTConfig(features=cfg["features"],
                    out_channels=tuple(cfg["out_channels"]), metric=True,
                    max_depth=cfg["max_depth"])
    m = DepthAnything(vit, dpt)
    m.load_state_dict(w, strict=True)
    return m.eval()


@pytest.mark.parametrize("seed", [1, 2])
def test_depth_matches_the_port_in_float32(seed):
    w = weights.make_weights(DA2, SMALL, seed, "cpu", torch.float32)
    frames = inputs.make_frames(2, (84, 140), seed, "cpu")
    hw = DA2.model_grid(dict(SMALL, input_size=42), (84, 140))
    want, colour = ref.reference(frames, w, SMALL, hw)
    x = frames.to(torch.float32) / 255.0
    from txr_torch.ops.resize import (IMAGENET_MEAN, IMAGENET_STD,
                                      resize_bicubic)
    xm = resize_bicubic(x, *hw)
    xn = (xm - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD)
    with torch.no_grad():
        got = port_model(SMALL, w)(xn)
    torch.testing.assert_close(colour, xm, rtol=0, atol=1e-6)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert float(want.std()) > 0.01          # the depth is not flat


def test_points_match_the_port_bit_for_bit():
    g = torch.Generator().manual_seed(3)
    depth = torch.rand((2, 14, 28), generator=g) * 25.0
    depth[0, 0, 0] = float("nan")
    colour = torch.rand((2, 14, 28, 3), generator=g)
    R, t = inputs.PoseTable(2, 0.05, "cpu").at(5)
    intr = (30.0, 31.0, 14.0, 7.0)
    want = geometry.backproject_world(depth, colour, R, t, intr, (0.1, 20.0))
    got = backproject_world(depth, colour, R, t, *intr, 0.1, 20.0, 1.0, 1)
    assert torch.equal(got.xyz.reshape(-1, 3), want[0])
    assert torch.equal(got.rgb.reshape(-1, 3), want[1])
    assert torch.equal(got.mask.reshape(-1), want[2])


@pytest.mark.parametrize("capacity", [1 << 14, 1500])
def test_map_matches_the_port(capacity):
    g = torch.Generator().manual_seed(4)
    n = 6000
    xyz = torch.randn((n, 3), generator=g) * 0.05
    rgb = torch.rand((n, 3), generator=g)
    mask = torch.rand(n, generator=g) > 0.1
    vm = create_offset_map(capacity, 0.01, device="cpu")
    stored = voxel_map.empty("cpu")
    for shift in (0.0, 0.003):
        pts = voxel_map.point_rows(xyz + shift, rgb, mask, 0.01)
        want = voxel_map.insert(stored, pts, capacity)
        new = offset_map_insert(vm, PointSet(xyz + shift, rgb, mask))
        got = voxel_map.decode(tuple(new[:4]))
        c = voxel_map.compare(got, want)
        assert c["rows_diff"] == 0
        assert c["quanta_max"] <= 1
        assert got["key"].shape[0] == min(capacity, int(torch.unique(
            torch.cat([stored["key"], pts["key"]])).shape[0]))
        vm, stored = new, got


def test_map_compare_sees_a_missing_voxel_and_a_moved_mean():
    rows = voxel_map.point_rows(torch.rand((50, 3)), torch.rand((50, 3)),
                                torch.ones(50, dtype=torch.bool), 0.1)
    want = voxel_map.insert(voxel_map.empty("cpu"), rows, 100)
    cut = {k: v[1:] for k, v in want.items()}
    assert voxel_map.compare(cut, want)["rows_diff"] > 0
    moved = dict(want, qx=want["qx"].clone())
    moved["qx"][3] += 5
    assert voxel_map.compare(moved, want)["quanta_max"] == 5
