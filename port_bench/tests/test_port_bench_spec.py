"""BENCHMARK.json and the files it names: every one loads by name, names
and units keep to the allowed characters, and a cell, configuration,
traffic mix or metric is added by adding files and an entry."""

import json
import shutil

import pytest

from port_bench.lib import spec

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
           "config": {"patch_size": 14, "hidden_size": 64},
           "model_hw": [28, 28], "frames_per_step": 1, "peak_flops": 1.0}
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
    assert body["hidden_size"] % body["num_attention_heads"] == 0
    assert len(body["out_indices"]) == len(body["out_channels"]) == 4


def test_model_grid_of_1080p():
    assert spec.model_grid((1080, 1920), 518, 14) == (518, 924)


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
