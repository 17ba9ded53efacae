"""Benchmark of the PyTorch / CUDA port of txr (``txr_torch``) on NVIDIA
cards.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(weights, frames and the map made from the seed, warm-up steps), a window
of ``--seconds`` over the port's main path, then the check of what the
window produced against the plain reference. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; ``checks``, last,
holds each number compared beside its limit, as the last lines of
standard error do too.

It exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), and if the process holds ``jax``, ``jaxlib``,
``flax`` or ``txr`` (the JAX package the port replaces) once the window
has closed. Caches of the program go to fixed directories under
``build/`` in the checkout.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_T_START = time.perf_counter()

FORBIDDEN = ("jax", "jaxlib", "flax", "txr")


def process_age_s() -> float:
    """Seconds since this process started, from /proc (the interpreter's
    start-up included); since this module's first line where /proc is
    missing."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_START


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``txr_torch`` is not ``txr``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed places inside the checkout."""
    base = root / "build" / "port_bench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    imports = {"interpreter": process_age_s()}
    t = time.perf_counter()
    import torch

    imports["import_torch"] = time.perf_counter() - t
    t = time.perf_counter()
    from port_bench.lib import spec
    from port_bench.lib import program  # noqa: F401  the system under test

    imports["import_program"] = time.perf_counter() - t

    cell = spec.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: cell {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    return run_cell(cell, args, torch.device("cuda", 0), imports)


def run_cell(cell, args, device, imports=None) -> int:
    """Set-up, window, check and the result line. Returns the exit code."""
    import json

    import torch

    from port_bench.lib import check, spec
    from port_bench.lib.bench import Run

    run = Run(cell, device)
    run.prepare(args.seed, trace_on=bool(args.trace))
    setup_s = process_age_s()
    print("setup_parts_s " + json.dumps(dict(imports or {},
                                             **run.setup_parts)),
          file=sys.stderr)
    result = run.window(args.seconds, bool(args.trace))
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"port_bench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 4

    if args.trace:
        rec = result["records"]
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = run.end_to_end(result, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    checked = result["checked"]
    run.release()
    del result["records"]
    numbers = check.judge(run, checked)
    correct, checks = check.verdict(numbers, cell.limits)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": dev}
    # the map after the window's last step, from the check's reference
    # insert: voxels held, capacity, and voxels that step could not hold
    out["map"] = {"voxels": numbers["map_voxels"],
                  "capacity": run.capacity,
                  "dropped": numbers["map_dropped"]}
    print("map " + json.dumps(out["map"]), file=sys.stderr)
    if args.trace:
        tr = rec.get("trace", {})
        dev["busy_s"] = tr.get("busy_s", 0.0)
        dev["window_s"] = tr.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": tr.get("by_name", []),
                            "idle_gaps": tr.get("idle_gaps", [])}
    out["checks"] = checks
    for name, c in checks.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
