"""The port's stat_fish bench (``python -m ecseg_torch.bench_stat_fish``,
ecseg_torch/bench_stat_fish.py): its synthetic images against
``scripts/bench_stat_fish.py``'s (each file read by its own package's
stat_fish reader), and its JSON line with the pipeline run stubbed."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from ecseg_tpu.core import imgio as jax_imgio
from ecseg_torch import bench_stat_fish
from ecseg_torch.core import imgio
from ecseg_torch.runtime import trace

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "seconds_per_image", "n_images", "top_stage", "stages_s", "wall_s"}


@pytest.fixture
def jax_script(monkeypatch):
    """scripts/bench_stat_fish.py as a module; it sets ECSEG_TRACE when it
    loads, which is undone after the test."""
    monkeypatch.setenv("ECSEG_TRACE", os.environ.get("ECSEG_TRACE", "0"))
    spec = importlib.util.spec_from_file_location("jax_bench_stat_fish", os.path.join(REPO, "scripts", "bench_stat_fish.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("hw,seed", [(512, 0), (448, 3)])
def test_images_equal_the_jax_scripts(tmp_path, jax_script, hw, seed):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    os.makedirs(ours)
    os.makedirs(theirs)
    bench_stat_fish.make_images(str(ours), 2, hw=hw, seed=seed)
    jax_script.make_images(str(theirs), 2, hw=hw, seed=seed)
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names == ["bench_00.tif", "bench_01.tif"]
    for name in names:
        got = imgio.imread_bgr8(str(ours / name))
        want = jax_imgio.imread_bgr8(str(theirs / name))
        assert got.shape == (hw, hw, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert (got[..., 0] >= 190).any() and (got[..., 1] >= 170).any() and (got[..., 2] >= 170).any()


def test_json_line(monkeypatch, capsys, tmp_path):
    """Two passes with the tracer reset between them: the line reports the
    second pass's stages and wall time; ``--out`` writes the same record."""
    monkeypatch.setenv("ECSEG_TRACE", "1")  # main sets it when unset; restored after the test
    monkeypatch.setattr(trace, "_tracer", trace.Tracer(enabled=True))
    passes = []

    def fake_run_once(inpath, device=None):
        passes.append(device)
        t = trace.tracer()
        t._times["stat_fish.min_cut"].append(0.5 * len(passes))
        t._times["stat_fish.region_stats"].append(0.25)
        return 4.0

    monkeypatch.setattr(bench_stat_fish, "make_images", lambda d, n: None)
    monkeypatch.setattr(bench_stat_fish, "run_once", fake_run_once)
    out_path = tmp_path / "rec.json"
    assert bench_stat_fish.main(["5", "--out", str(out_path)], device="cpu") == 0
    assert passes == [torch.device("cpu")] * 2
    cap = capsys.readouterr()
    lines = [ln for ln in cap.out.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == KEYS
    assert rec["metric"].startswith("stat_fish 2048^2 images/s/chip (end-to-end")
    assert rec["value"] == 1.25 and rec["unit"] == "images/s/chip" and rec["n_images"] == 5
    assert rec["seconds_per_image"] == 0.8 and rec["wall_s"] == 4.0
    assert rec["stages_s"] == {"stat_fish.min_cut": 1.0, "stat_fish.region_stats": 0.25}
    assert rec["top_stage"] == "stat_fish.min_cut (1.0s of 4.0s)"
    assert "[ecseg trace]" in cap.err
    assert json.loads(out_path.read_text()) == rec
    assert trace.tracer().times() == {}


def test_default_image_count(monkeypatch, capsys):
    monkeypatch.setenv("ECSEG_TRACE", "1")
    monkeypatch.setattr(trace, "_tracer", trace.Tracer(enabled=True))
    monkeypatch.setattr(bench_stat_fish, "make_images", lambda d, n: None)
    monkeypatch.setattr(bench_stat_fish, "run_once", lambda inpath, device=None: 3.0)
    assert bench_stat_fish.main([], device="cpu") == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["n_images"] == 6 and rec["value"] == 2.0 and rec["top_stage"] == "n/a (0.0s of 3.0s)"


def test_main_without_cuda_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_stat_fish.main(["1"]) == 1
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and cap.out == ""
