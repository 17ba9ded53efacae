"""BENCHMARK.json and the files it names: every one loads by name, names
and units keep to the allowed characters, and a cell, configuration,
architecture, traffic mix or metric is added by adding files and an
entry."""

import copy
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench.lib import check, spec, weights
from port_bench.tests.tiny import tiny_cell

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"][1] == "port_bench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    assert spec.check_names(BENCH) == []
    names = [e["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[g]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        if m["name"].split(".")[0].endswith("_roofline") or \
                "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("bad", ["a b", "a/b", "a,b", ".a", "x" * 65,
                                 "µs", "ab\n"])
def test_bad_names_refused(bad):
    assert not spec.NAME.fullmatch(bad)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert c.traffic["name"] == c.entry["traffic"]
    assert set(c.limits) >= {"depth_excess", "points_err_m",
                             "map_rows_diff", "map_quanta_max"}
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_and_reads_nothing_from_nothing(name):
    read = spec.metric_reader(name)
    empty = {"steps": [], "frames": 0, "window_s": 0.0, "config": {},
             "model_hw": [518, 924], "frames_per_step": 1, "capacity": 1,
             "points_per_step": 1, "peak_flops": 1.0, "peak_bytes": 1.0}
    assert read(empty) is None


def test_a_suffixed_metric_falls_back_to_its_base_reader():
    rec = {"trace": {"range_device_s": {"attention": 1.0},
                     "range_calls": {"attention": 2}},
           "attention_flops": 3.0, "attention_calls": 2, "peak_flops": 1.0}
    base = spec.metric_reader("attention_roofline")
    assert spec.metric_reader("attention_roofline.offline")(rec) == \
        spec.metric_reader("attention_roofline.live")(rec) == base(rec)
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.offline")


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_files(cfg):
    entry = {c["name"]: c for c in BENCH["configs"]}[cfg]
    body = spec.load_json(spec.ROOT / entry["file"])
    assert body["name"] == cfg and body["reduced"] == entry["reduced"]
    spec.architecture(body).check_config(body)


def test_the_da2_architecture_refuses_what_it_cannot_run():
    vitl = spec.load_json(spec.BENCH_DIR / "configs" / "da2-vitl-metric.json")
    arch = spec.architecture(vitl)
    with pytest.raises(ValueError):
        arch.check_config(dict(vitl, num_attention_heads=15))
    with pytest.raises(ValueError):
        arch.check_config(dict(vitl, out_indices=[23]))


def test_an_architecture_is_found_by_name_with_no_default(tmp_path):
    with pytest.raises(KeyError, match="archs"):
        spec.architecture({"name": "x"})
    with pytest.raises(FileNotFoundError, match="no_such_arch.py"):
        spec.architecture({"name": "x", "architecture": "no_such_arch"})
    (tmp_path / "archs").mkdir()
    (tmp_path / "archs" / "stub.py").write_text("CONTROL = 'q'\n")
    assert spec.architecture({"architecture": "stub"},
                             bench_dir=tmp_path).CONTROL == "q"


# Taken at the commit before the architectures were split out of the
# harness: the leaves of da2-vitl-metric (names, shapes and laws, in
# order) and the bfloat16 weights ``make_weights`` draws at one seed for
# the tiny cell on the CPU.
LEAVES_SHA256 = ("b2aaf62124a468b6566e9f1ba250a283015091e2247d5f822e3cb451"
                 "607984b8")
WEIGHTS_SHA256 = ("9d4f53390561355521c1135743720e4e5134d95f83b397c424293112"
                  "bfe2c271")


def test_da2_weights_are_the_same_bit_for_bit():
    vitl = spec.load_json(spec.BENCH_DIR / "configs" / "da2-vitl-metric.json")
    arch = spec.architecture(vitl)
    assert hashlib.sha256(json.dumps(arch.leaves(vitl)).encode()
                          ).hexdigest() == LEAVES_SHA256
    cell = tiny_cell("vitl-offline-b8")
    w = weights.make_weights(cell.arch, cell.config, 2 ** 31 + 11, "cpu",
                             torch.bfloat16)
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.contiguous().view(torch.int16).numpy().tobytes())
    assert len(w) == 94 and h.hexdigest() == WEIGHTS_SHA256


def test_readers_give_the_old_formulas_values():
    """``step_mfu`` and ``attention_roofline`` on a record of the cell as
    ``Run`` writes it, against the values the readers gave before the
    counts moved into the architecture (the model's FLOPs a frame times
    the frames; 4 B S^2 D times the range's calls)."""
    from port_bench.lib.bench import Run

    run = Run(spec.load_cell("vitl-offline-b8"), "cpu")
    rec = run._records([], [], 1104, 10.0123)
    rec["trace"] = {"range_device_s": {"attention": 1.1357},
                    "range_calls": {"attention": 1224}}
    assert rec["model_hw"] == [518, 924]
    assert spec.metric_reader("step_mfu.offline")(rec) == pytest.approx(
        28.799301221499416, rel=1e-12)
    assert spec.metric_reader("attention_roofline.offline")(rec) == \
        pytest.approx(21.31171350791328, rel=1e-12)
    s, d = 2443, 1024
    assert 100.0 * 1224 * 4.0 * 8 * s * s * d / 989e12 / 1.1357 == \
        pytest.approx(21.31171350791328, rel=1e-12)


def test_model_grid_of_1080p():
    vitl = spec.load_json(spec.BENCH_DIR / "configs" / "da2-vitl-metric.json")
    assert spec.architecture(vitl).model_grid(vitl, (1080, 1920)) == \
        (518, 924)


def test_adding_files_and_an_entry_adds_a_cell(tmp_path):
    """A new configuration, mix, metric and cell are new files and entries:
    no file the benchmark has is edited."""
    root = tmp_path / "repo"
    shutil.copytree(spec.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in (root / "port_bench").rglob("*")
              if p.is_file()}
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "da2-vitl-metric.json")
    cfg["name"] = "da2-vitl-metric-copy"
    (root / "port_bench/configs/da2-vitl-metric-copy.json").write_text(
        json.dumps(cfg))
    trf = spec.load_json(spec.BENCH_DIR / "traffic" / "offline-b8.json")
    trf.update(name="offline-b32", frames_per_step=32)
    (root / "port_bench/traffic/offline-b32.json").write_text(
        json.dumps(trf))
    (root / "port_bench/limits/vitl-offline-b32.json").write_text(
        (spec.BENCH_DIR / "limits" / "vitl-offline-b8.json").read_text())
    (root / "port_bench/metrics/frames.offline.py").write_text(
        "def read(rec):\n    return rec['frames'] or None\n")
    bench["configs"].append(dict(bench["configs"][0],
                                 name="da2-vitl-metric-copy",
                                 file="port_bench/configs/"
                                      "da2-vitl-metric-copy.json"))
    bench["workloads"].append({"name": "vitl-offline-b32",
                               "config": "da2-vitl-metric-copy",
                               "traffic": "offline-b32", "chips": 1,
                               "why": "32 frames a step"})
    bench["end_to_end"][1]["workloads"].append("vitl-offline-b32")
    bench["per_layer"].append({"name": "frames.offline", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "step loop",
                               "moves": "frames_per_s",
                               "workloads": ["vitl-offline-b32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("vitl-offline-b32", bench_dir=root / "port_bench")
    assert c.traffic["frames_per_step"] == 32
    assert c.config["name"] == "da2-vitl-metric-copy"
    assert [m["name"] for m in c.per_layer] == ["frames.offline"]
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "frames_per_s"}
    read = spec.metric_reader("frames.offline", bench_dir=root / "port_bench")
    assert read({"frames": 64}) == 64
    for p, body in before.items():
        assert p.read_bytes() == body, p


TOY = Path(__file__).resolve().parent / "toy_crossview"
TOY_RUN = r"""
import json, sys
import torch
from torch.utils.flop_counter import FlopCounterMode
from port_bench.lib import check, spec, weights
from port_bench.lib.bench import Run

cell = spec.load_cell("toy-crossview-b4")
arch = cell.arch
arch.check_config(cell.config)
run = Run(cell, "cpu")
run.prepare(int(sys.argv[1]))
res = run.window(0.5, False)
rec = res["records"]
rec["trace"] = {"range_device_s": {"attention": 0.25},
                "range_calls": {"attention": 6}}
read = {m: spec.metric_reader(m)(rec)
        for m in ("step_mfu.offline", "attention_roofline.offline")}

# a frame's depth moves when only another frame of its step changes, in the
# program and in the reference
frames = run._frames(0)
other = frames.clone()
other[-1] = 255 - other[-1]
w = weights.make_weights(arch, cell.config, 7, "cpu", torch.float32)
d1, _ = arch.reference(frames, w, cell.config, run.model_hw)
d2, _ = arch.reference(other, w, cell.config, run.model_hw)
def program_depth(f):
    return run.step_fn(f, *run.poses.at(0), run.vm)[1]
p1, p2 = program_depth(frames), program_depth(other)
with FlopCounterMode(display=False) as counter:
    arch.reference(frames, w, cell.config, run.model_hw)

run.release()
numbers = check.judge(run, res["checked"])
correct, checks = check.verdict(numbers, cell.limits)

control = Run(cell, "cpu", quant=arch.CONTROL)
control.prepare(int(sys.argv[1]))
res = control.window(0.3, False)
control.release()
control_numbers = check.judge(control, res["checked"], control=True)
print(json.dumps({
    "arch_file": arch.__file__, "correct": correct, "checks": checks,
    "control": control_numbers,
    "read": read, "frames": rec["frames"], "window_s": rec["window_s"],
    "model_hw": rec["model_hw"], "flops_counted": counter.get_total_flops(),
    "reference_moves": float((d1[0] - d2[0]).abs().max()),
    "program_moves": float((p1[0] - p2[0]).abs().max())}))
"""


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 12345])
def test_a_second_architecture_enters_as_files_only(tmp_path, seed):
    """A toy architecture that mixes a step's frames (its own weight
    layout, program module and reference) is added to a copy of the
    benchmark as new files and entries only; a tiny cell of it runs through
    ``Run.prepare``, ``window`` and ``check.judge`` on the CPU to
    ``correct`` (and its control to not correct), and the step and
    attention readers read its counts."""
    root = tmp_path / "repo"
    bench_dir = root / "port_bench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    for src in TOY.rglob("*"):
        if src.is_file() and "__pycache__" not in src.parts:
            dst = bench_dir / src.relative_to(TOY)
            assert not dst.exists(), dst
            dst.parent.mkdir(exist_ok=True)
            shutil.copy(src, dst)
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({
        "name": "toy-crossview", "source": "port_bench/tests/toy_crossview",
        "file": "port_bench/configs/toy-crossview.json", "reduced": [],
        "why": "every frame's depth depends on every frame of its step"})
    bench["workloads"].append({
        "name": "toy-crossview-b4", "config": "toy-crossview",
        "traffic": "toy-b4", "chips": 1, "why": "4 views a step"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("frames_per_s", "step_mfu.offline",
                         "attention_roofline.offline"):
            m["workloads"].append("toy-crossview-b4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run(
        [sys.executable, "-c", TOY_RUN, str(seed)], cwd=root,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root), str(spec.ROOT)])))
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])

    assert Path(got["arch_file"]) == bench_dir / "archs" / "toy_crossview.py"
    assert got["correct"], got["checks"]
    # the toy's depth is judged against the toy's reference: its int8
    # control reads a depth excess the sound run does not, and fails
    assert got["control"]["depth_excess"] > 0.1 > \
        got["checks"]["depth_excess"]["value"]
    limits = spec.load_json(TOY / "limits" / "toy-crossview-b4.json")
    assert not check.verdict(got["control"], limits)[0]
    assert got["reference_moves"] > 1e-4 and got["program_moves"] > 1e-3

    cfg = spec.load_json(TOY / "configs" / "toy-crossview.json")
    c, p, layers = cfg["width"], cfg["patch_size"], cfg["layers"]
    assert got["model_hw"] == [28, 42]
    t = 4 * 2 * 3                                  # 4 views of 2 x 3 tokens
    attention = layers * 4.0 * t * t * c
    step = (2.0 * t * c * 3 * p * p + layers * 2.0 * t * c * 4 * c
            + attention + 2.0 * t * c)
    assert got["flops_counted"] == pytest.approx(step, rel=1e-12)
    assert got["read"]["step_mfu.offline"] == pytest.approx(
        100.0 * step * got["frames"] / 4 / got["window_s"] / 989e12,
        rel=1e-12)
    assert got["read"]["attention_roofline.offline"] == pytest.approx(
        100.0 * (6 / layers) * attention / 989e12 / 0.25, rel=1e-12)

    for path, body in before.items():
        assert path.read_bytes() == body, path
