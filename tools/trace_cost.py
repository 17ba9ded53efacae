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
layers, VGGT's aggregator, camera head and point head among them; the
device time of the kernels the span launched, linked by the profiler),
beside it ``span_event_ms_per_step`` (the same spans' milliseconds a step
between their own CUDA events, the program's ``span_times``, which the
benchmark's span metrics read) and ``span_event_gap`` (the second over
the first, less 1), and each traced block's span reduction.
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


def span_event_ms_per_step(times: dict, steps: int) -> dict:
    """Milliseconds a step of each span of ``profiling.span_times()``,
    largest first."""
    return {k: v["device_ms"] / steps
            for k, v in sorted(times.items(),
                               key=lambda kv: -kv[1]["device_ms"])}


def span_event_gap(event: dict, linked: dict) -> dict:
    """Each span's event time over its linked device time, less 1."""
    return {k: event[k] / v - 1.0 for k, v in linked.items()
            if v > 0 and k in event}


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
            out["span_event_ms_per_step"] = span_event_ms_per_step(
                profiling.span_times(), args.probes + args.steps)
            out["span_event_gap"] = span_event_gap(
                out["span_event_ms_per_step"], out["span_ms_per_step"])
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
    for key in ("span_ms_per_step", "span_event_ms_per_step",
                "span_event_gap"):
        res[key] = [b[key] for b in blocks if b["on"]]
    print(json.dumps(res), file=sys.stderr)
    res["blocks"] = blocks
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
