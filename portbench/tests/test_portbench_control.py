"""The control, on the card at each cell's own size: the reference
computed in TF32 in the program's place fails the cell's check, on three
seeds, while the program passes it on the same seeds.  Run on the card
with ``python3 -m pytest portbench/tests -m cuda``."""

from __future__ import annotations

import pytest

from portbench import spec

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["metaseg_folder_2048"])
def test_the_tf32_control_fails_the_check_and_the_program_passes_it(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size on the card")
    from portbench.readings import read_seed
    from portbench.run import prepare_env

    prepare_env(False)
    bench = spec.load_benchmark()
    limits = spec.config(bench, spec.workload(bench, workload)["config"], [spec.PKG])["check"]["limits"]
    for seed in SEEDS:
        images, prog, ctl = read_seed(bench, workload, seed, 3.0, control=True)
        assert images > 0
        assert all(prog[k] <= limits[k] for k in limits), (seed, prog)
        assert any(ctl[k] > limits[k] for k in limits), (seed, ctl)
