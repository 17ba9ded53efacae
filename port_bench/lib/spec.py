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
from types import ModuleType
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
    arch: ModuleType         # archs/<config["architecture"]>.py
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
    return Cell(name, entry, config, architecture(config, bench_dir),
                traffic, limits, e2e, per_layer)


def _load(path: Path, prefix: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def architecture(cfg: dict, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module ``archs/<cfg["architecture"]>.py``: everything the
    harness knows of one model architecture. It gives

    - ``leaves(cfg)``, (name, shape, mean, std) of every parameter in the
      order ``weights.make_weights`` draws them, and ``CENTRED``, the names
      whose drawn values have their mean taken out; the names are the
      state-dict names of the model ``build`` returns;
    - ``model_grid(cfg, frame_hw)``, the (h, w) the model runs a frame of
      ``frame_hw`` at (the program's step resizes the frames to it);
    - ``build(cfg, weights, device, quant)``, the program's model in
      bfloat16 holding ``weights`` (``quant``: the program's int8 policy),
      whose call maps a normalised (B, h, w, 3) bfloat16 batch, one step's
      frames, to depth (B, h, w); and ``attention_modules(model)``, a
      (start, end) module pair for each attention call of a step:
      attention runs between the end of the first and the start of the
      second;
    - ``reference(frames_u8, w, cfg, model_hw, dtype)``, the plain
      reference of a whole step (module under ``reference/``, importing
      nothing of the program): (depth (B, h, w) float32, colour image
      (B, h, w, 3));
    - ``step_flops(cfg, model_hw, frames)``, the model's operations for a
      step of ``frames`` frames; ``attention_flops(cfg, model_hw, frames)``,
      those of all the step's attention calls; ``attention_calls(cfg)``,
      how many attention calls a step makes;
    - ``check_config(cfg)``, raising on a configuration it cannot run;
    - ``CONTROL``, the ``quant`` of the program's lower-precision route
      that ``calibrate.py`` runs as the control.
    """
    if "architecture" not in cfg:
        raise KeyError(f"configuration {cfg.get('name')!r} names no "
                       f"architecture; it needs an \"architecture\" key "
                       f"naming a file under {bench_dir / 'archs'}")
    path = bench_dir / "archs" / f"{cfg['architecture']}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {cfg.get('name')!r} names "
                                f"architecture {cfg['architecture']!r}; "
                                f"no file {path}")
    return _load(path, "port_bench_arch_", cfg["architecture"])


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(records)`` of ``metrics/<name>.py``, or where that file is
    absent of ``metrics/<base>.py`` for a name ``<base>.<suffix>``: one
    formula serves a quantity split by the end-to-end metric it moves
    (``attention_roofline.offline``, ``attention_roofline.live``)."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = bench_dir / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return _load(path, "port_bench_metric_", name).read


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
