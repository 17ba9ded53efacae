"""What the benchmark loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``txr`` (compared whole: ``txr_torch`` is the
port), and the reference nothing of the program either; ``run.py`` fails
without a card and without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench import run as run_mod
from port_bench.lib import spec

ROOT = spec.ROOT


@pytest.mark.parametrize("names,found", [
    (["txr_torch", "txr_torch.ops.scan", "torch"], []),
    (["txr", "txr.ops"], ["txr"]),
    (["jax._src.core", "numpy"], ["jax"]),
    (["jaxlib", "flax.linen", "txrx", "jaxtyping"], ["flax", "jaxlib"]),
])
def test_forbidden_compares_top_level_names_whole(names, found):
    assert run_mod.forbidden_modules(names) == found


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = loaded("import port_bench.run, port_bench.lib.bench, "
                  "port_bench.lib.program, port_bench.lib.check\n"
                  "from port_bench.lib import spec\n"
                  "for w in spec.load_json(spec.ROOT / 'BENCHMARK.json')"
                  "['workloads']:\n"
                  "    spec.load_cell(w['name'])")
    assert "txr_torch" in tops
    assert not tops & set(run_mod.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = loaded("import port_bench.reference.geometry, "
                  "port_bench.reference.voxel_map")
    assert not tops & (set(run_mod.FORBIDDEN) | {"txr_torch"})


ARCHS = sorted(p.stem for p in (spec.BENCH_DIR / "archs").glob("*.py"))


@pytest.mark.parametrize("arch", ARCHS)
def test_each_architecture_reference_loads_nothing_of_the_program(arch):
    """The module that holds the architecture's ``reference``, imported
    alone, loads no ``txr_torch`` (the architecture file itself builds
    the program's model, so it does)."""
    module = spec.architecture({"architecture": arch}).reference.__module__
    assert module.startswith("port_bench.reference."), module
    tops = loaded(f"import {module}")
    assert not tops & (set(run_mod.FORBIDDEN) | {"txr_torch"})


def run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "vitl-offline-b8",
         "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=""))


def test_run_without_a_card_fails_and_prints_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "txr_torch" in out.stderr
