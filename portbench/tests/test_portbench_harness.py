"""The harness: cells found by name, the metrics each cell reports, the
result line, and what a run refuses.  CPU only; each dry run is a process
of its own at a small size."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.run import Run
from portbench.tests._cells import CHECKOUT, dry_run, run_subprocess

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
TRACE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]


def test_a_new_configuration_and_mix_are_found_by_name(cells, tmp_path):
    root, _ = cells
    bench = spec.load_benchmark(os.path.join(root, "BENCHMARK.json"))
    run = Run(bench, "small_metaseg", 5, 1.0, False, "cpu", [root, spec.PKG], str(tmp_path))
    assert run.cfg["name"] == "small_unet" and run.traffic["height"] == 300
    assert run.weights_module.__file__.startswith(root) and run.reference.__file__.startswith(root)
    assert run.driver_module.__file__ == os.path.join(spec.PKG, "drivers", "metaseg_folder.py")


def test_a_new_metric_file_is_found_by_name(tmp_path):
    os.makedirs(tmp_path / "metrics")
    (tmp_path / "metrics" / "new.share_ms.py").write_text("def read(ctx):\n    return ctx['images'] * 2\n")
    module = spec.load_module([str(tmp_path), spec.PKG], "metrics", "new.share_ms")
    assert module.read({"images": 3}) == 6
    assert spec.load_module([str(tmp_path), spec.PKG], "metrics", "setup_s").read({"setup_s": 1.5}) == 1.5


def test_every_metric_of_the_benchmark_has_its_reader():
    bench = spec.load_benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.load_module([spec.PKG], "metrics", m["name"]).read), m["name"]


@pytest.mark.parametrize("cell,throwaway", [("metaseg_folder_2048", False), ("small_metaseg", True)])
def test_each_cell_reports_setup_another_end_to_end_metric_and_per_layer_ones(cells, cell, throwaway):
    bench = spec.load_benchmark(os.path.join(cells[0], "BENCHMARK.json") if throwaway else None)
    wl = spec.workload(bench, cell)
    e2e = [m["name"] for m in spec.metrics(bench, wl, False)]
    layer = spec.metrics(bench, wl, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)
    assert all(os.path.exists(os.path.join(bench["_dir"], c["file"])) for c in bench["configs"])
    assert spec.load_json([cells[0], spec.PKG], "traffic", wl["traffic"])["driver"]


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_dry_run_prints_the_contract_line_and_loads_no_jax(cells, trace):
    root, _ = cells
    rc, line, err, forbidden = dry_run(root, "small_metaseg", trace=trace)
    assert rc == 0, err[-3000:]
    assert list(line) == (TRACE_KEYS if trace and "breakdown" in line else RESULT_KEYS)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert forbidden == []
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert "metaseg.forward_ms" in line["metrics"]
    else:
        assert "setup_s" in line["metrics"]
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    checks = err.strip().splitlines()[-len(line["checks"]):]
    assert all(c.startswith("check ") for c in checks)


def test_without_a_card_the_run_exits_1_and_prints_nothing():
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "metaseg_folder_2048", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=CHECKOUT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and proc.stdout == "" and "CUDA" in proc.stderr


def test_without_the_program_the_run_fails_and_prints_no_result(cells, tmp_path):
    """A folder that holds only BENCHMARK.json and portbench/ (run on the
    CPU here, past the look for a card)."""
    root, _ = cells
    shutil.copytree(spec.PKG, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from portbench import run\n"
            f"sys.exit(run.main(['--workload', 'small_metaseg', '--seed', '1', '--seconds', '1'], device='cpu',"
            f" roots=[{root!r}, run.spec.PKG], bench_path={os.path.join(root, 'BENCHMARK.json')!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "ecseg_torch" in proc.stderr


@pytest.mark.parametrize("name", ["ecseg_metaseg_unet"])
def test_the_references_import_nothing_of_the_program(name):
    path = os.path.join(spec.PKG, "reference", name + ".py")
    with open(path) as f:
        tree = ast.parse(f.read())
    imported = {n.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import) for n in node.names}
    imported |= {node.module.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.ImportFrom) and node.module}
    assert imported <= {"__future__", "heapq", "typing", "numpy", "torch", "scipy"}, imported
    proc = run_subprocess(f"import sys, json; import portbench.reference.{name}; "
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = set(json.loads(proc.stdout))
    assert not loaded & {"ecseg_torch", "ecseg_tpu", "jax", "jaxlib", "flax"}
