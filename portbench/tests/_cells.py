"""Throwaway cells for the harness's CPU tests: a benchmark file, a small
configuration of the model and a small traffic mix, written
under a temporary folder that the harness searches before its own.  Its
weights and reference modules re-export the real ones under the new
names."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench import spec

CHECKOUT = spec.CHECKOUT


def _load(rel):
    with open(os.path.join(spec.PKG, rel)) as f:
        return json.load(f)


def write_cells(root: str) -> dict:
    """Writes the small cells under ``root``; returns their benchmark."""
    for sub in ("configs", "traffic", "weights", "reference"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    unet = _load("configs/ecseg_metaseg_unet.json")
    unet.update(name="small_unet", widths=[4, 8, 8, 8], bottleneck=16)
    unet["check"]["images"] = 2
    dapi = _load("traffic/folder_dapi_2048.json")
    dapi.update(images=4, height=300, width=300)
    dapi["objects"][0].update(count=[1, 2], radius=[25, 35], margin=10)
    dapi["objects"][1].update(count=[12, 16], cluster_radius=[60, 80])
    dapi["objects"][2].update(count=[20, 30])
    for name, data in (("configs/small_unet", unet), ("traffic/small_dapi", dapi)):
        with open(os.path.join(root, name + ".json"), "w") as f:
            json.dump(data, f)
    for kind in ("weights", "reference"):
        with open(os.path.join(root, kind, "small_unet.py"), "w") as f:
            f.write(f"from portbench.{kind}.ecseg_metaseg_unet import *  # noqa: F401,F403\n")
    bench = _load("../BENCHMARK.json")
    bench["configs"] = [
        {"name": "small_unet", "source": "test", "file": "configs/small_unet.json", "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "small_metaseg", "config": "small_unet", "traffic": "small_dapi", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["small_metaseg"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


def run_subprocess(code: str, timeout: float = 600, cwd: str = CHECKOUT):
    env = dict(os.environ, PYTHONPATH=CHECKOUT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def dry_run(root: str, workload: str, seed: int = 2**31 + 7, seconds: float = 1.0, trace: int = 0):
    """One CPU run of a small cell in a process of its own: (returncode,
    last stdout line, stderr, the forbidden modules it had loaded)."""
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        f"rc = run.main(['--workload', {workload!r}, '--seed', '{seed}', '--seconds', '{seconds}', '--trace', '{trace}'],"
        f" device='cpu', roots=[{root!r}, run.spec.PKG], bench_path={os.path.join(root, 'BENCHMARK.json')!r})\n"
        "print(json.dumps(run.forbidden_modules()))\n"
        "sys.exit(rc)\n")
    proc = run_subprocess(code)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, (json.loads(lines[-2]) if len(lines) >= 2 else None), proc.stderr, (
        json.loads(lines[-1]) if lines else None)
