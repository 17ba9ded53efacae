"""On the card: each cell through ``run.py`` for a short window, untraced
and traced, with ``correct`` true and the result line in its documented
shape. Run on the chip with ``python -m pytest port_bench/tests -q -m
chip``; skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from port_bench.lib import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


@pytest.mark.chip
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 17 + trace), "--seconds", "3", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == 1
    c = spec.load_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    if trace:
        assert line["device"]["busy_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
        for m in c.per_layer:
            if m["unit"] == "%" and ("roofline" in m["name"]
                                     or "mfu" in m["name"]):
                assert line["metrics"][m["name"]]["value"] <= 100.0
