"""The readings that a cell's limits are set from (not part of a run).

    python3 -m portbench.readings --workload <name> --seeds 1,2,... [--control-seeds 1,2,3] [--seconds 4]

For each seed, in one process: the cell's set-up and a short window at
its own load, then the driver's compared numbers of the window's sampled
answers against the reference (the lower reading is their largest over
the seeds); on the control seeds also those of the reference computed in
TF32 in the program's place (the upper reading is their smallest).  One
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from portbench import spec
from portbench.run import Run, prepare_env


def read_seed(bench, workload: str, seed: int, seconds: float, control: bool):
    """(images, the program's numbers, the control's or None) of one seed:
    the cell's set-up and a window of ``seconds`` at its own load."""
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = Run(bench, workload, seed, seconds, False, "cuda", [spec.PKG], workdir)
        drv = run.driver_module.Driver(run)
        drv.setup()
        start = time.perf_counter()
        images = 0
        while time.perf_counter() - start < seconds:
            images += drv.step()
        drv.close()
        return (images,) + drv.readings(control=control)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    prepare_env(False)
    import torch

    if not torch.cuda.is_available():
        print("portbench.readings: needs a CUDA device", file=sys.stderr)
        return 1
    bench = spec.load_benchmark()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        images, prog, ctl = read_seed(bench, args.workload, seed, args.seconds, seed in controls)
        print(json.dumps({"seed": seed, "images": images, "program": prog, "control": ctl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
