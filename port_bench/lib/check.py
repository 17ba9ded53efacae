"""Whether what the timed path produced is right: its outputs held against
the plain reference (``port_bench/reference``), after the window.

The checked steps are one drawn from the seed among the window's first
steps and the window's last. For each, the reference

- runs the architecture's float32 reference (``reference``) on the step's
  frames and weights (both remade from the seed), and the same plain
  model at bfloat16, the precision the configuration states; the
  program's depth is judged, frame by frame, by how much larger its error
  relative to the float32 depth is than the bfloat16 reference's
  (``depth_numbers``: 0 is as good as plain bfloat16 arithmetic), at the
  median pixel and at the 99th percentile, so that a fault confined to a
  hundredth of a frame shows.
  The raw error moves threefold from seed to seed with where the seeded
  head puts sigmoid's input (bfloat16 spacing grows with its magnitude);
  the ratio moves by a few percent;
- back-projects the program's depth with the step's poses and compares the
  program's points, positions and colours, with what it gives;
- inserts the program's points into the map the program held before the
  step and compares the map the program held after it, voxel by voxel.

So the back-projection and the insert are followed step by step from the
program's own depth and map; the depth is checked from the frames. The
map starts empty in set-up; the inserts between the checked steps are
the same call on other points.

In the control (``control=True``) the back-projection and the insert of the
check are the reference's own at bfloat16 in the program's place, and the
model is the program's lower-precision route, the architecture's
``CONTROL`` (the caller builds it): the run that has to come out as not
correct.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from port_bench.lib import inputs, weights
from port_bench.reference import geometry, voxel_map


@dataclass
class Captured:
    step: int
    first: int
    before: object
    after: object
    depth: torch.Tensor
    points: object


def _frames(run, cap: Captured) -> torch.Tensor:
    idx = torch.from_numpy(run.order).to(run.dev).view(-1, run.B)[
        cap.step % (len(run.order) // run.B)]
    return run.pool.index_select(0, idx)


def relative_error(depth: torch.Tensor, d_ref: torch.Tensor) -> torch.Tensor:
    return (depth - d_ref).abs() / d_ref


def depth_numbers(depth: torch.Tensor, d_ref: torch.Tensor,
                  d_b16: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per frame, a statistic of the program's relative depth error against
    the float32 reference over the same statistic of the reference run at
    bfloat16, less 1 (0: as good as plain bfloat16 arithmetic):
    ``depth_excess`` at the median pixel, ``depth_p99_excess`` at the 99th
    percentile, so that a fault in a hundredth of a frame shows."""
    e = relative_error(depth, d_ref).flatten(1)
    e16 = relative_error(d_b16, d_ref).flatten(1)
    return {"depth_excess": e.median(1).values / e16.median(1).values - 1.0,
            "depth_p99_excess": torch.quantile(e, 0.99, dim=1) /
            torch.quantile(e16, 0.99, dim=1) - 1.0}


def judge(run, checked: Dict[str, Captured], control: bool = False
          ) -> Dict[str, float]:
    """The numbers compared, over the checked steps."""
    cfg, dev, arch = run.cfg, run.dev, run.arch
    w = weights.make_weights(arch, cfg, inputs.stream_seed(run.seed,
                                                           inputs.WEIGHTS),
                             dev, torch.bfloat16)
    w = {k: v.to(torch.float32) for k, v in w.items()}
    cam = cfg["camera"]
    fh, fw = run.trf["frame_hw"]
    sy, sx = run.model_hw[0] / fh, run.model_hw[1] / fw
    intr = (cam["fx"] * sx, cam["fy"] * sy, cam["cx"] * sx, cam["cy"] * sy)
    rng = tuple(cfg["depth_range_m"])
    voxel = run.map_cfg["voxel_m"]
    geo_dtype = torch.bfloat16 if control else torch.float32
    sum_dtype = torch.bfloat16 if control else torch.float64
    depth_stats = []
    pts_err, rgb_err, rows_diff, quanta = 0.0, 0.0, 0.0, 0.0
    voxels = dropped = 0
    seen = set()
    for cap in checked.values():
        if cap.step in seen:
            continue
        seen.add(cap.step)
        frames = _frames(run, cap)
        d_ref, colour = arch.reference(frames, w, cfg, run.model_hw)
        d_b16, _ = arch.reference(frames, w, cfg, run.model_hw,
                                  torch.bfloat16)
        depth_stats.append(depth_numbers(cap.depth, d_ref, d_b16))
        del d_ref, d_b16
        R, t = inputs.PoseTable(frames.shape[0], run.trf["advance_m"],
                                dev).at(cap.first)
        xyz, rgb, mask = geometry.backproject_world(cap.depth, colour, R, t,
                                                    intr, rng)
        p = cap.points
        got_xyz, got_rgb, got_mask = p.xyz, p.rgb, p.mask
        if control:
            got_xyz, got_rgb, got_mask = geometry.backproject_world(
                cap.depth, colour, R, t, intr, rng, dtype=geo_dtype)
        pts_err = max(pts_err, float((got_xyz - xyz).abs().max()))
        rgb_err = max(rgb_err, float((got_rgb - rgb).abs().max()))
        stored = voxel_map.decode(run.program.map_columns(cap.before))
        want, held = voxel_map.insert_counted(stored, voxel_map.point_rows(
            got_xyz, got_rgb, got_mask, voxel), run.capacity)
        if cap is checked.get("last"):
            voxels, dropped = want["key"].shape[0], max(0, held -
                                                        run.capacity)
        if control:
            got = voxel_map.insert(stored, voxel_map.point_rows(
                got_xyz, got_rgb, got_mask, voxel, geo_dtype),
                run.capacity, sum_dtype)
        else:
            got = voxel_map.decode(run.program.map_columns(cap.after))
        c = voxel_map.compare(got, want)
        rows_diff += c["rows_diff"]
        quanta = max(quanta, c["quanta_max"])
    out = {k: float(torch.cat([d[k] for d in depth_stats]).max())
           for k in depth_stats[0]}
    return dict(out, points_err_m=pts_err, points_rgb_err=rgb_err,
                map_rows_diff=rows_diff, map_quanta_max=quanta,
                map_voxels=float(voxels),
                map_dropped=float(dropped))


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite fails."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = numbers[name]
        good = v == v and v <= lim["limit"]
        ok = ok and good
        out[name] = {"value": v, "limit": lim["limit"]}
    return ok, out
