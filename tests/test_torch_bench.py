"""The port's bench (``python -m ecseg_torch.bench``, ecseg_torch/bench.py).

- Its full-pipeline program against the JAX package's, composed as
  ``bench.py:146-185`` composes ``group_fn_full``: the bf16 forward,
  ``quantize_u8_jax`` and argmax, ``stitch_labels_pallas`` (interpret mode
  here), ``meta_inference_tpu`` and ``count_roots_tpu``; at narrow widths
  with ``bench._realistic_params``'s surgery, on a group of two 320x384
  tiles of bench's recipe (4 patches a tile, so the JAX side takes
  seconds).  The labels, canvases, post-processed maps, counts and each
  stage's result must be equal.
- The kernel calls per canvas of the full program at each stage, which
  chip_smoke.py holds the card's launch counters to.
- The harness on the CPU at a small size, and its JSON lines with
  ``measure`` and ``_probe_device`` stubbed, as tests/test_bench_emission.py
  pins bench.py's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench as jax_bench
import chip_smoke
from ecseg_tpu.models import metaseg_unet as ju
from ecseg_tpu.ops import tiling as jt
from ecseg_tpu.ops.cc_pallas import stitch_labels_pallas
from ecseg_tpu.ops.meta_post_tpu import count_roots_tpu, meta_inference_tpu
from ecseg_torch import bench
from ecseg_torch.models.weights import params_from_numpy
from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import meta_post_gpu, morphology_gpu, tiling
from ecseg_torch.pipelines import tile_count

from _torchutil import bench_realistic_params, single_torch_thread  # noqa: F401 (autouse fixture)

WIDTHS, BOTT = (4, 8), 16
H, W = 320, 384
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def case():
    """The weights in both packages and a group of two 320x384 tiles (bench's
    recipe on a 384^2 side, cropped)."""
    params = bench_realistic_params(WIDTHS, BOTT)
    model = params_from_numpy(jax.tree.map(np.asarray, params)).to(torch.bfloat16).eval()
    tiles = tile_count.synthetic_tiles(2, 0, W)[:, :H]
    group, positions = tile_count.tile_patches(tiles)
    assert group.shape == (2, 4, 256, 256, 1)
    return params, model, group, positions


@pytest.fixture(scope="module")
def jax_chain(case):
    """Every intermediate of the JAX program on the group: patch labels,
    canvases, post-processed maps, counts (``group_fn_full`` at stage
    "full"; the earlier stages' results are read off these)."""
    params, _, group, positions = case
    flat = jnp.asarray(group.reshape((-1,) + group.shape[2:]))
    probs = ju.forward(params, flat, dtype=jnp.bfloat16)
    labels = jnp.argmax(jt.quantize_u8_jax(probs), -1).astype(jnp.int32)
    labels = labels.reshape((group.shape[0], -1) + labels.shape[1:])
    canvases, posts, oks, counts = [], [], [], []
    for lab in labels:
        canvas = stitch_labels_pallas(lab, positions)
        post, ok = meta_inference_tpu(canvas)
        canvases.append(np.asarray(canvas))
        posts.append(np.asarray(post))
        oks.append(bool(ok))
        counts.append(int(count_roots_tpu(post == 3)))
    return {"labels": np.asarray(labels), "canvas": canvases, "post": posts, "ok": oks, "count": counts}


def _stage_want(chain, stage):
    if stage == "fwd":
        return chain["labels"][:, 0, 0, 0]
    if stage == "stitch":
        return np.array([c[0, 0] + c[-1, -1] for c in chain["canvas"]])
    if stage == "meta":
        return np.array([p[0, 0] + p[-1, -1] for p in chain["post"]])
    return np.array(chain["count"])


def test_full_program_intermediates_match_the_jax_program(case, jax_chain):
    _, model, group, positions = case
    x = torch.from_numpy(group)
    with torch.no_grad():
        labels = tiling.patch_labels(model(x.reshape(-1, 256, 256, 1), dtype=torch.bfloat16))
    np.testing.assert_array_equal(labels.reshape(jax_chain["labels"].shape).numpy(), jax_chain["labels"])
    labels = labels.reshape(group.shape[:2] + (256, 256))
    for k in range(len(group)):
        canvas = K.stitch_labels(labels[k], positions)
        assert canvas.shape == (H, W)
        np.testing.assert_array_equal(canvas.numpy(), jax_chain["canvas"][k])
        post, ok = meta_post_gpu.meta_inference_gpu(canvas)
        assert bool(ok) and jax_chain["ok"][k]
        np.testing.assert_array_equal(post.numpy(), jax_chain["post"][k])
        assert int(meta_post_gpu.count_roots_gpu(post == 3)) == jax_chain["count"][k]
    assert min(jax_chain["count"]) > 10  # bench's validity check (bench.py:234)


@pytest.mark.parametrize("stage", bench.STAGES)
def test_full_program_stage_matches_the_jax_program(case, jax_chain, stage):
    _, model, group, positions = case
    got = bench.full_program(model, torch.from_numpy(group), positions, stage)
    assert got.shape == (len(group),)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), _stage_want(jax_chain, stage).astype(np.int64))


def _count_calls(monkeypatch):
    """Count each kernel wrapper's calls where the bench and the post call it."""
    calls = dict.fromkeys(K.LAUNCHES, 0)
    for key, (_, fname, *_rest) in chip_smoke.KERNELS.items():
        fn = getattr(K, fname)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        for m in (bench, meta_post_gpu, morphology_gpu):
            if getattr(m, fname, None) is fn:
                monkeypatch.setattr(m, fname, counted)
    return calls


@pytest.mark.parametrize("stage", bench.STAGES)
def test_kernel_calls_per_canvas(case, monkeypatch, stage):
    """Per canvas the full program calls what metaseg calls for one image
    (chip_smoke.PER_IMAGE_LAUNCHES), cut at the stage
    (``chip_smoke.bench_stage_launches``, which chip_smoke.py holds the
    card's counters to): no kernel through ``fwd``, B1 through ``stitch``,
    the count's B2 only in ``full``."""
    for var in chip_smoke.FORM_VARS:
        monkeypatch.delenv(var, raising=False)
    _, model, group, positions = case
    calls = _count_calls(monkeypatch)
    bench.full_program(model, torch.from_numpy(group), positions, stage)
    assert calls == {k: len(group) * v for k, v in chip_smoke.bench_stage_launches(stage).items()}
    if stage == "full":
        assert chip_smoke.bench_stage_launches(stage) == chip_smoke.PER_IMAGE_LAUNCHES["default"]


def test_build_runs_the_chunks_and_passes(monkeypatch):
    """``build``'s ``run`` on the CPU at narrow widths and a 320^2 side: one
    row of counts a chunk and pass, the passes equal, each count the full
    program's on that chunk; ``ECSEG_BENCH_FULL_TILES`` sets the group."""
    monkeypatch.setitem(tile_count.ARCHS, "default", (WIDTHS, BOTT, 1))
    monkeypatch.setattr(bench, "BATCH_TILES", 2)
    monkeypatch.delenv("ECSEG_BENCH_FULL_TILES", raising=False)
    run, chunks = bench.build(full=True, device="cpu", nchunks=1, passes=2, side=320)
    assert tuple(chunks.shape) == (1, 2, 4, 256, 256, 1) and chunks.dtype == torch.uint8
    counts = run()
    assert counts.shape == (2, 2)
    np.testing.assert_array_equal(counts[0], counts[1])
    model = tile_count.realistic_model("default", torch.Generator().manual_seed(0))
    positions = tuple(map(tuple, tiling.patch_positions(320, 320)))
    np.testing.assert_array_equal(counts[0], bench.full_program(model, chunks[0], positions).numpy())
    assert (counts > 10).all()
    monkeypatch.setenv("ECSEG_BENCH_FULL_TILES", "1")
    _, chunks = bench.build(full=True, device="cpu", nchunks=1, passes=1, side=320)
    assert chunks.shape[1] == 1
    _, chunks = bench.build(full=False, device="cpu", nchunks=1, passes=1, side=320)
    assert chunks.shape[1] == 2  # the tile program ignores it


def test_measure_on_the_cpu(monkeypatch):
    monkeypatch.setitem(tile_count.ARCHS, "default", (WIDTHS, BOTT, 1))
    monkeypatch.setattr(bench, "BATCH_TILES", 1)
    rate = bench.measure("default", device="cpu", nchunks=1, passes=1, reps=1)
    assert rate > 0


def test_measure_rejects_a_degenerate_mask(monkeypatch):
    monkeypatch.setattr(bench, "build", lambda *a, **k: ((lambda: np.zeros((1, 1), np.int64)), torch.zeros((1, 1))))
    with pytest.raises(RuntimeError, match="degenerated"):
        bench.measure("default", device="cpu")
    bench.measure("default", full=True, full_stage="meta", device="cpu", reps=1)  # no count before "full"


# --------------------------------------------------------------------------
# the JSON lines
# --------------------------------------------------------------------------


def _fake_measure(calls):
    def measure(arch, full=False, fused_tail=False, full_stage="full", **kw):
        calls.append((arch, full, fused_tail, full_stage, kw.get("device")))
        if full:
            return {"fwd": 200.0, "stitch": 190.0, "meta": 50.0, "full": 40.0}[full_stage]
        if fused_tail:
            return 170.0
        return 57.0 if arch == "xl" else 160.0

    return measure


def _run_main(monkeypatch, capsys, argv):
    calls = []
    monkeypatch.setattr(bench, "measure", _fake_measure(calls))
    monkeypatch.setattr(bench, "_probe_device", lambda *a, **k: None)
    assert bench.main(argv, device="cpu") == 0
    cap = capsys.readouterr()
    merged = [json.loads(ln) for ln in (cap.err + cap.out).strip().splitlines() if ln.startswith("{")]
    out = [json.loads(ln) for ln in cap.out.strip().splitlines() if ln.startswith("{")]
    return merged, out, calls


def test_default_run_prints_the_scored_line_last(monkeypatch, capsys):
    merged, out, calls = _run_main(monkeypatch, capsys, [])
    assert len(merged) == 3
    assert merged[-1]["value"] == 160.0 and out == [merged[-1]]
    assert merged[0]["metric"].endswith(" [full-pipeline: + device meta_inference]") and merged[0]["value"] == 40.0
    assert merged[1]["metric"].endswith(" [arch=xl]") and merged[1]["value"] == 57.0
    assert [c[:4] for c in calls] == [("default", False, False, "full"), ("default", True, False, "full"), ("xl", False, False, "full")]
    assert all(c[4] == torch.device("cpu") for c in calls)
    for line in merged:
        assert "vs_baseline" not in line and "workload_note" not in line
        assert line["unit"] == "tiles/s/chip" and line["forward_mfu"] is None and line["device"] == "cpu"


@pytest.mark.parametrize("flag,lines", [("--no-full", 2), ("--flagship-only", 2)])
def test_skip_flags(monkeypatch, capsys, flag, lines):
    merged, out, _ = _run_main(monkeypatch, capsys, [flag])
    assert len(merged) == lines and out == [merged[-1]] and merged[-1]["value"] == 160.0


def test_arch_xl_goes_to_stderr_only(monkeypatch, capsys):
    merged, out, calls = _run_main(monkeypatch, capsys, ["--arch", "xl"])
    assert out == []
    assert [m["value"] for m in merged] == [40.0, 57.0]  # full-pipeline at xl, then the scored xl line
    assert merged[-1]["metric"].endswith("[arch=xl]") and merged[-1]["arch"] == "unet-classic-130gflop"
    assert {c[0] for c in calls} == {"xl"}


def test_fused_tail_line(monkeypatch, capsys):
    merged, out, calls = _run_main(monkeypatch, capsys, ["--fused-tail"])
    assert out == [] and len(merged) == 1
    assert merged[0]["metric"] == jax_bench._result("default", 1.0, 1)["metric"] + " [fused-tail]"
    assert merged[0]["value"] == 170.0
    assert [c[:4] for c in calls] == [("default", False, True, "full")]


def test_itemize_full_line(monkeypatch, capsys):
    merged, out, calls = _run_main(monkeypatch, capsys, ["--itemize-full"])
    assert out == [] and len(merged) == 1
    line = merged[0]
    assert set(line) == {"metric", "forward+argmax", "stitch", "meta_inference", "count", "total", "device"}
    assert line["metric"] == "full-pipeline stage budget (ms/1024^2 tile)"
    assert line["forward+argmax"] == 5.0 and line["total"] == 25.0
    assert line["stitch"] == round(1e3 / 190 - 5.0, 2) and line["count"] == round(25.0 - 20.0, 2)
    assert [c[3] for c in calls] == list(bench.STAGES) and all(c[1] for c in calls)


@pytest.mark.parametrize("arch", ["default", "xl"])
def test_result_keys_match_bench_py(arch):
    """``metric``, ``value``, ``unit`` and ``arch`` as bench.py's; on the
    H100 SXM ``forward_mfu`` is the rate's share of 989 TFLOP/s."""
    want = jax_bench._result(arch, 123.456, 1)
    got = bench._result(arch, 123.456, torch.device("cpu"))
    for k in ("metric", "value", "unit", "arch"):
        assert got[k] == want[k]
    assert got["forward_mfu"] is None
    flops = ju.flops_per_patch(*((ju.ENC_WIDTHS_XL, ju.BOTTLENECK_XL) if arch == "xl" else ()))
    bench_mfu = want["forward_mfu"] * jax_bench._peak_bf16_flops() / 989e12
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "device_name", lambda dev: "NVIDIA H100 80GB HBM3")
        got = bench._result(arch, 123.456, torch.device("cpu"))
    assert got["forward_mfu"] == round(123.456 * 25 * flops / 989e12, 4)
    assert abs(got["forward_mfu"] - bench_mfu) < 1e-3 and 0 < got["forward_mfu"] <= 1


def test_sizes_match_bench_py():
    for arch in ("default", "xl"):
        assert bench._sizes(arch) == jax_bench._sizes(arch)
    assert (bench.BATCH_TILES, bench.NCHUNKS, bench.PASSES, bench.REPS) == (
        jax_bench.BATCH_TILES, jax_bench.NCHUNKS, jax_bench.PASSES, jax_bench.REPS
    )


def test_main_without_cuda_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main([]) == 1
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and "{" not in cap.out
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "ecseg_torch.bench"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "{" not in out.stdout
