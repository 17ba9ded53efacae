"""The check fails what it should. Each cell is driven through ``run.py``'s
``run_cell`` on the CPU at a small size (``tiny.py``: no look for a card),
with the timed path broken underneath, and ``correct`` has to come out
false; sound, it comes out true. The control (the port's int8 route, the
reference's bfloat16 back-projection and insert in the program's place)
fails as well."""

import json
import types

import pytest
import torch

from port_bench import run as run_mod
from port_bench.lib import check, program
from port_bench.lib.bench import Run
from port_bench.tests.tiny import tiny_cell
from txr_torch.core.types import PointSet
from txr_torch.models.depth_anything import DepthAnything

CELLS = ["vitl-offline-b8"]


def result(cell, capsys, seed=2 ** 31 + 11):
    args = types.SimpleNamespace(workload=cell.name, seed=seed,
                                 seconds=0.4, trace=0)
    assert run_mod.run_cell(cell, args, torch.device("cpu")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def insert_unchanged(vm, points):
    return vm


def insert_half(vm, points):
    mask = points.mask.clone()
    mask[mask.shape[0] // 2:] = False
    return program.offset_map_insert.__wrapped__(
        vm, PointSet(points.xyz, points.rgb, mask))


def insert_one_voxel_altered(vm, points):
    new = program.offset_map_insert.__wrapped__(vm, points)
    new.rgb[0] ^= 0x7F0000
    return new


def backproject_one_point_altered(*args, **kw):
    ps = program.backproject_world.__wrapped__(*args, **kw)
    ps.xyz.view(-1, 3)[7, 0] += 0.05
    return ps


def model_one_frame_altered(self, pixels):
    depth = model_one_frame_altered.__wrapped__(self, pixels)
    depth[0] = depth[0] * 1.05
    return depth


def model_one_tile_stale(self, pixels):
    """One 14 x 14 tile of one frame holding its right neighbour's values,
    as a kernel that writes an output tile from the wrong place would: a
    fiftieth of this frame, so its median does not move."""
    depth = model_one_tile_stale.__wrapped__(self, pixels)
    depth[0, 14:28, 28:42] = depth[0, 14:28, 42:56]
    return depth


def plant(monkeypatch, name, fn):
    holder = DepthAnything if name == "forward" else program
    fn.__wrapped__ = getattr(holder, name)
    monkeypatch.setattr(holder, name, fn)


FAULTS = {
    "state_unchanged": ("offset_map_insert", insert_unchanged),
    "half_the_batch": ("offset_map_insert", insert_half),
    "voxel_altered": ("offset_map_insert", insert_one_voxel_altered),
    "point_altered": ("backproject_world", backproject_one_point_altered),
    "depth_altered": ("forward", model_one_frame_altered),
    "depth_tile_stale": ("forward", model_one_tile_stale),
}


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(cell_name, capsys):
    out = result(tiny_cell(cell_name), capsys)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", CELLS)
def test_fault_is_caught(cell_name, fault, capsys, monkeypatch):
    plant(monkeypatch, *FAULTS[fault])
    out = result(tiny_cell(cell_name), capsys)
    assert not out["correct"], (fault, out["checks"])
    if fault == "depth_tile_stale":
        failed = {k for k, c in out["checks"].items()
                  if c["value"] > c["limit"]}
        assert failed == {"depth_p99_excess"}, out["checks"]


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name, seed):
    cell = tiny_cell(cell_name)
    run = Run(cell, "cpu", quant=cell.arch.CONTROL)
    run.prepare(seed)
    res = run.window(0.3, False)
    numbers = check.judge(run, res["checked"], control=True)
    correct, checks = check.verdict(numbers, cell.limits)
    assert not correct, checks
