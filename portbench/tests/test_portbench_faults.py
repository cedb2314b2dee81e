"""A run with the timed path broken underneath comes out not correct, once
for each fault the cell can have: a step that returns its state unchanged
(metaseg's post skipped), half of the work left out (half of each
forward's patches) and an answer altered where it is produced (the ecDNA
count).  Each run skips the look for a card and runs on the CPU at a small
size; the check is the real one, limits and all."""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.run import Run, run_cell


def _run(root, workload, tmp_path):
    bench = spec.load_benchmark(os.path.join(root, "BENCHMARK.json"))
    run = Run(bench, workload, 2**31 + 11, 1.0, False, "cpu", [root, spec.PKG], str(tmp_path), log=lambda *a: None)
    return run_cell(run, time.perf_counter())


def _metaseg_post_skipped(monkeypatch):
    from ecseg_torch.ops.meta_post_gpu import count_roots_gpu
    from ecseg_torch.pipelines import metaseg

    monkeypatch.setattr(metaseg, "post_group", lambda raws: [
        (r.numpy().astype(np.int64), int(count_roots_gpu(r == 3)), True) for r in raws])


def _metaseg_half_the_patches(monkeypatch):
    from ecseg_torch.pipelines import metaseg

    plain = metaseg.segment_group

    def half(model, stacks, positions):
        halves = [np.concatenate([s[: len(s) // 2], s[: len(s) - len(s) // 2]]) for s in stacks]
        return plain(model, halves, positions)

    monkeypatch.setattr(metaseg, "segment_group", half)


def _metaseg_count_altered(monkeypatch):
    from ecseg_torch.pipelines import metaseg

    plain = metaseg.decode_post_blob
    monkeypatch.setattr(metaseg, "decode_post_blob", lambda blob, w: (lambda ok, lab, n: (ok, lab, n + 1))(*plain(blob, w)))


@pytest.mark.parametrize("fault", [_metaseg_post_skipped, _metaseg_half_the_patches, _metaseg_count_altered])
def test_a_broken_path_is_not_correct(cells, tmp_path, monkeypatch, fault):
    root, _ = cells
    torch.manual_seed(0)
    fault(monkeypatch)
    result = _run(root, "small_metaseg", tmp_path)
    assert result["correct"] is False, result["checks"]


def test_the_unbroken_path_is_correct(cells, tmp_path):
    root, _ = cells
    result = _run(root, "small_metaseg", tmp_path)
    assert result["correct"] is True, result["checks"]
