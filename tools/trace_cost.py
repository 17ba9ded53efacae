"""What the port's tracing costs on the card, on a benchmark cell's path
(``port_bench``; ``vitl-offline-b8`` unless ``--workload`` names another):
the same closed loop of steps with a ``torch.profiler`` recording (the
``txr.*`` spans and counters on) and without, in turns (off, on, on, off).

    python3 tools/trace_cost.py [--workload CELL] [--seed N] [--steps 30] \
        [--probes 5]

Prints a summary on standard error and one JSON line on standard output:
``probe_ms`` (host milliseconds to enqueue one step on an idle card, each
block's probes), ``frames_per_s`` (each block's closed loop, synced at its
edges), ``counter_share`` (device time of the counters' span over the
insert's, from each traced block), ``span_ms_per_step`` (each ``txr.``
span's device milliseconds a step, from each traced block: the model's
layers, VGGT's aggregator, camera head and point head among them) and
each traced block's span reduction.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def span_ms_per_step(reduction: dict, steps: int) -> dict:
    """Device milliseconds a step of each span of a ``spans.reduce``
    result (a span counts what its nested spans launch), largest first."""
    dev = reduction.get("device_s", {})
    return {k: v * 1e3 / steps
            for k, v in sorted(dev.items(), key=lambda kv: -kv[1])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="vitl-offline-b8")
    p.add_argument("--seed", type=int, default=2 ** 31 + 4242)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--probes", type=int, default=5)
    args = p.parse_args(argv)

    from port_bench import run as run_mod
    run_mod.set_cache_dirs(ROOT)
    import torch

    from port_bench.lib import spans, spec
    from port_bench.lib.bench import Run
    from txr_torch.utils import profiling

    if not torch.cuda.is_available():
        print("trace_cost: needs a CUDA card", file=sys.stderr)
        return 3
    run = Run(spec.load_cell(args.workload), torch.device("cuda", 0))
    run.prepare(args.seed, trace_on=True)
    B, step = run.B, [0]
    # The counters' reduction kernel loads lazily on its first launch,
    # which stalls the card for milliseconds: load it before the blocks.
    n = B * run.model_hw[0] * run.model_hw[1]
    pts = torch.zeros((n, 3), device=run.dev)
    with run._profiler():
        run.program.insert(
            run.program.create_map(1 << 10, run.map_cfg["voxel_m"], run.dev),
            pts, pts, torch.ones(n, dtype=torch.bool, device=run.dev))
    run.sync()

    def one():
        i = step[0]
        step[0] += 1
        run._one(i, i * B)

    def block(on: bool) -> dict:
        prof = run._profiler() if on else None
        run.sync()
        if on:
            prof.start()
            profiling.reset_counters()
        probes = []
        for _ in range(args.probes):
            run.sync()
            h0 = time.perf_counter()
            one()
            probes.append((time.perf_counter() - h0) * 1e3)
        run.sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one()
        run.sync()
        t1 = time.perf_counter()
        out = {"on": on, "probe_ms": probes,
               "frames_per_s": args.steps * B / (t1 - t0)}
        if on:
            prof.stop()
            out["counters"] = spans.program_counters()
            out["spans"] = spans.reduce(prof)
            dev = out["spans"]["device_s"]
            out["span_ms_per_step"] = span_ms_per_step(
                out["spans"], args.probes + args.steps)
            if dev.get("fusion.insert"):
                out["counter_share"] = (dev.get("fusion.insert.count", 0.0)
                                        / dev["fusion.insert"])
        return out

    blocks = [block(on) for on in (False, True, True, False)]
    res = {"device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "workload": args.workload,
           "seed": args.seed,
           "steps": args.steps, "frames_per_step": B}
    for key, on in (("off", False), ("on", True)):
        bs = [b for b in blocks if b["on"] == on]
        res[key] = {"probe_ms_median": statistics.median(
                        [x for b in bs for x in b["probe_ms"]]),
                    "frames_per_s": [b["frames_per_s"] for b in bs]}
    res["counter_share"] = [b.get("counter_share") for b in blocks
                            if b["on"]]
    res["span_ms_per_step"] = [b["span_ms_per_step"] for b in blocks
                               if b["on"]]
    print(json.dumps(res), file=sys.stderr)
    res["blocks"] = blocks
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
