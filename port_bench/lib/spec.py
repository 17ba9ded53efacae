"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
its files are ``configs/<config>.json`` (through the configuration's
``file``), ``traffic/<traffic>.json`` and ``limits/<cell>.json`` under the
benchmark's folder. A per-layer metric is ``metrics/<name>.py`` (or
``metrics/<base>.py``, shared by ``<base>.<suffix>`` names). Adding a
configuration, a mix, a metric or a cell is adding files and an entry.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict              # the workload entry
    config: dict             # configs/<config>.json
    traffic: dict            # traffic/<traffic>.json
    limits: dict             # limits/<cell>.json
    end_to_end: List[dict]   # end-to-end metrics the cell reports
    per_layer: List[dict]    # per-layer metrics the cell reports


def reports(metric: dict, cell: str, end_to_end_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in end_to_end_names


def load_cell(name: str, bench: dict = None, bench_dir: Path = BENCH_DIR
              ) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    if bench is None:
        bench = load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(bench_dir.parent / configs[entry["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, name, e2e_names)]
    return Cell(name, entry, config, traffic, limits, e2e, per_layer)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(records)`` of ``metrics/<name>.py``, or where that file is
    absent of ``metrics/<base>.py`` for a name ``<base>.<suffix>``: one
    formula serves a quantity split by the end-to-end metric it moves
    (``attention_roofline.offline``, ``attention_roofline.live``)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = bench_dir / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_grid(frame_hw, target: int, multiple: int) -> tuple:
    """Depth Anything's lower-bound resize: the short side scales to
    ``target`` and both sides round to the nearest multiple of
    ``multiple`` (upward where that falls under ``target``)."""
    h, w = frame_hw
    s = max(target / h, target / w)

    def fit(v):
        out = int(round(v / multiple) * multiple)
        if out < target:
            out = int(-(-v // multiple) * multiple)
        return max(out, multiple)

    return fit(s * h), fit(s * w)


def check_names(bench: dict) -> List[str]:
    """Names and units outside the allowed characters."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            if not NAME.fullmatch(e["name"]):
                bad.append(f"{group}: name {e['name']!r}")
            if "unit" in e and not UNIT.fullmatch(e["unit"]):
                bad.append(f"{group}: unit {e['unit']!r}")
            for k in ("config", "traffic"):
                if k in e and not NAME.fullmatch(e[k]):
                    bad.append(f"{group}: {k} {e[k]!r}")
            for k in e.get("reduced", []):
                if not NAME.fullmatch(k):
                    bad.append(f"{group}: reduced {k!r}")
    return bad
