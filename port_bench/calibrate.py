"""Readings that the check's limits are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 5]

For each seed, at the cell's own size and load with a short window (long
enough that the window's last step inserts into a full map): the
program's numbers (one JSON line, ``"kind": "sound"``), the depth numbers
of the same run with each fault of ``planted_faults`` planted in its
depth (``"kind": "fault"``: part of one frame scaled, or one output tile
of the tail holding its neighbour's values), then the control's
(``"kind": "control"``): the program's lower-precision route, the
architecture's ``CONTROL`` (Depth Anything V2: the port's int8 route of
the encoder, ``quant="int8p"``), with the back-projection and the insert
of the check computed by the reference at bfloat16. The lower reading of
a number is the largest sound one over the seeds, the upper the smallest
control one. Each route builds its model once, so a dozen seeds cost two
set-ups. The benchmark's own runs never run this. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _scaled(depth, rows, cols, scale):
    bad = depth.clone()
    bad[0, rows, cols] *= scale
    return bad


def _stale(depth, rows, cols):
    """One tile of the tail's output (32 wide) holding its right
    neighbour's values."""
    bad = depth.clone()
    w = cols.stop - cols.start
    bad[0, rows, cols] = depth[0, rows, cols.start + w:cols.stop + w]
    return bad


def planted_faults(depth):
    h, w = depth.shape[1] // 2, depth.shape[2] // 2
    th, tw = h // 14 * 14, w // 14 * 14          # the tile holding (h, w)
    return {
        "patch7_x1.05": _scaled(depth, slice(h, h + 7), slice(w, w + 7),
                                1.05),
        "tile14_x1.02": _scaled(depth, slice(th, th + 14),
                                slice(tw, tw + 14), 1.02),
        "tail_tile_x1.05": _scaled(depth, slice(h, h + 6),
                                   slice(w, w + 32), 1.05),
        "tail_tile_stale": _stale(depth, slice(h, h + 6), slice(w, w + 32)),
        "edge_band_x1.02": _scaled(depth, slice(depth.shape[1] - 4, None),
                                   slice(None), 1.02),
    }


def planted(depth_numbers, out):
    """``check.depth_numbers`` that also records the numbers of the depth
    with each of ``planted_faults``."""
    def numbers(depth, d_ref, d_b16):
        for name, bad in planted_faults(depth).items():
            out.setdefault(name, []).append(depth_numbers(bad, d_ref, d_b16))
        return depth_numbers(depth, d_ref, d_b16)
    return numbers


def readings(cell, seeds, seconds):
    import torch

    from port_bench.lib import check
    from port_bench.lib.bench import Run

    runs = {"sound": Run(cell, torch.device("cuda", 0)),
            "control": Run(cell, torch.device("cuda", 0),
                           quant=cell.arch.CONTROL)}
    plain = check.depth_numbers
    for seed in seeds:
        for kind, run in runs.items():
            run.prepare(seed)
            res = run.window(seconds, False)
            faults = {}
            if kind == "sound":
                check.depth_numbers = planted(plain, faults)
            try:
                numbers = check.judge(run, res["checked"],
                                      control=kind == "control")
            finally:
                check.depth_numbers = plain
            emit({"kind": kind, "cell": cell.name, "seed": seed,
                  "steps": res["attempted"] // run.B, "numbers": numbers})
            for fault, per_step in faults.items():
                emit({"kind": "fault", "fault": fault, "seed": seed,
                      "numbers": {k: max(float(d[k].max()) for d in per_step)
                                  for k in per_step[0]}})
            del res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench.run import set_cache_dirs
    set_cache_dirs(ROOT)
    import torch

    from port_bench.lib import spec

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    readings(cell, seeds, args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
