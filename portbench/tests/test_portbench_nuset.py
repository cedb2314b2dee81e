"""The NuSeT cell's parts on the CPU: a dry run of a small NuSeT cell (the
contract line, no JAX), its arithmetic against a hand count, and each of
its metrics' readers on a synthetic ``ctx``.  The small cell is written
here, beside the harness's own throwaway cells: the real configuration at
a 320^2 folder of two images (96^2 after the prep)."""

from __future__ import annotations

import json
import os

import pytest

from portbench import arith, nuset_arith, spec
from portbench.tests._cells import dry_run

CFG = spec.load_json([spec.PKG], "configs", "nuset_unet_rpn")
NUSET_METRICS = ("nuset.prep_ms", "nuset.forward_ms", "nuset.forward_roofline", "nuset.proposals_ms",
                 "nuset.watershed_ms", "nuset.cleanup_ms", "nuset.decode_wait_ms", "nuset.fetch_bytes",
                 "nuset.watershed_redo_share", "nuset.mfu", "nuset.device_idle")


def write_nuset_cell(root: str) -> dict:
    """A small NuSeT cell under ``root``: its configuration, mix, weights
    and reference (re-exporting the real ones) and a benchmark file whose
    only cell it is."""
    for sub in ("configs", "traffic", "weights", "reference"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    cfg = dict(CFG, name="small_nuset", nuclei_size_T=200, check={"images": 2, "limits": CFG["check"]["limits"]})
    mix = spec.load_json([spec.PKG], "traffic", "interphase_rgb_2048")
    mix.update(images=2, warmup_images=1, height=320, width=320)
    mix["objects"][0].update(count=[3, 4], radius=[15, 25], margin=10)
    for obj in mix["objects"][1:]:
        obj.update(count=[3, 3])
    for name, data in (("configs/small_nuset", cfg), ("traffic/small_interphase", mix)):
        with open(os.path.join(root, name + ".json"), "w") as f:
            json.dump(data, f)
    for kind in ("weights", "reference"):
        with open(os.path.join(root, kind, "small_nuset.py"), "w") as f:
            f.write(f"from portbench.{kind}.nuset_unet_rpn import *  # noqa: F401,F403\n")
    bench = spec.load_benchmark()
    bench.pop("_dir")
    bench["configs"] = [{"name": "small_nuset", "source": "test", "file": "configs/small_nuset.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": "small_nuset_cell", "config": "small_nuset", "traffic": "small_interphase",
                           "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["small_nuset_cell"] if "nuset_segment_2048" in m["workloads"] else []
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


@pytest.fixture(scope="module")
def nuset_cell(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nuset_cell"))
    return root, write_nuset_cell(root)


@pytest.mark.parametrize("trace", [0, 1])
def test_cpu_dry_run_of_a_small_nuset_cell_prints_the_contract_line_and_loads_no_jax(nuset_cell, trace):
    root, _ = nuset_cell
    rc, line, err, forbidden = dry_run(root, "small_nuset_cell", trace=trace)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0, line
    assert forbidden == []
    assert set(line["checks"]) == {"mask_px_differ", "nuclei_count_differ"}
    if trace:
        # the spans and counters of the program (the CPU has no profile and no peak, and its readers run the prep)
        want = {"nuset.forward_ms", "nuset.proposals_ms", "nuset.watershed_ms", "nuset.cleanup_ms",
                "nuset.decode_wait_ms", "nuset.fetch_bytes", "nuset.watershed_redo_share"}
        assert set(line["metrics"]) == want, line["metrics"]
    else:
        assert set(line["metrics"]) == {"setup_s", "metaseg_images_per_s"}


def test_the_cell_is_declared_with_its_metrics():
    bench = spec.load_benchmark()
    wl = spec.workload(bench, "nuset_segment_2048")
    assert wl["chips"] == 1 and wl["config"] == "nuset_unet_rpn" and wl["traffic"] == "interphase_rgb_2048"
    assert [m["name"] for m in spec.metrics(bench, wl, False)] == ["setup_s", "metaseg_images_per_s"]
    assert [m["name"] for m in spec.metrics(bench, wl, True)] == list(NUSET_METRICS)
    assert spec.load_json([spec.PKG], "traffic", "interphase_rgb_2048")["driver"] == "nuset_folder"


def test_arith_by_hand_at_16_px():
    k = 2 * 9  # FLOPs a multiply-add of a 3x3 tap
    unet = [k * 256 * 1 * 64, k * 256 * 64 * 64,  # level 1, 16^2
            k * 64 * 64 * 128, k * 64 * 128 * 128,  # level 2, 8^2
            k * 16 * 128 * 256, k * 16 * 256 * 256,  # level 3, 4^2
            k * 4 * 256 * 512, k * 4 * 512 * 512,  # level 4, 2^2
            k * 1 * 512 * 1024, k * 1 * 1024 * 1024,  # bottleneck, 1^2
            k * 4 * 1024 * 512 // 4, k * 4 * 512 * 512, k * 4 * 512 * 512,  # deconv4 at 9/4 taps, no skip
            k * 16 * 512 * 256 // 4, k * 16 * 512 * 256, k * 16 * 256 * 256,
            k * 64 * 256 * 128 // 4, k * 64 * 256 * 128, k * 64 * 128 * 128,
            k * 256 * 128 * 64 // 4, k * 256 * 128 * 64, k * 256 * 64 * 64,
            k * 256 * 64 * 2]  # final, 3x3 to 2 classes
    rpn = [k * 1 * 512 * 512, 2 * 1 * 512 * 42, 2 * 1 * 512 * 84]  # the 1^2 feature
    assert arith.flops(nuset_arith.unet_rows(CFG, 16, 16)) == sum(unet)
    assert arith.flops(nuset_arith.rpn_rows(CFG, 16, 16)) == sum(rpn)
    assert nuset_arith.image_flops(CFG, 16, 16) == 2 * sum(unet) + sum(rpn)


def test_arith_at_the_cells_size():
    assert nuset_arith.prep_shape(2048, 2048, 0.3) == (608, 608)
    assert nuset_arith.prep_shape(320, 320, 0.3) == (96, 96)
    assert round(nuset_arith.image_flops(CFG, 608, 608) / 1e12, 4) == 1.0997
    assert round(arith.flops(nuset_arith.unet_rows(CFG, 608, 608)) / 1e9, 1) == 546.4
    rows = nuset_arith.forward_rows(CFG, 608, 608)
    assert len(rows) == 2 * len(nuset_arith.unet_rows(CFG, 608, 608)) and all(b > 0 for _, _, b in rows)


def _ctx(**over):
    rows = nuset_arith.forward_rows(CFG, 608, 608)
    ctx = {"cfg": CFG, "device_name": arith.H100, "setup_s": 20.0, "window_s": 50.0, "images": 320,
           "stages": {"nuset.prep": [0.002] * 320, "nuset.forward": [0.045] * 640, "nuset.fg_norm": [0.001] * 320,
                      "nuset.proposals": [0.02] * 320, "stat_fish.watershed": [0.015] * 320,
                      "stat_fish.cleanup": [0.012] * 320, "stat_fish.decode_wait": [0.001] * 340},
           "fetch": {"bytes": 320 * 6_200_000, "copies": 320 * 6, "seconds": 1.0},
           "fallbacks": {"fast_watershed_host_recompute": 80, "fast_watershed_uncertain_px": 9000},
           "profile": {"busy_s": 1.5, "window_s": 2.5, "images": 16, "device_ops": [], "idle_gaps": []},
           "nuset_forward_rows": rows, "nuset_flops_per_image": nuset_arith.image_flops(CFG, 608, 608)}
    ctx.update(over)
    return ctx


def _read(name, ctx):
    return spec.load_module([spec.PKG], "metrics", name).read(ctx)


def test_the_nuset_readers():
    ctx = _ctx()
    assert _read("nuset.prep_ms", ctx) == pytest.approx(2.0)
    assert _read("nuset.forward_ms", ctx) == pytest.approx(90.0)  # two passes an image
    assert _read("nuset.proposals_ms", ctx) == pytest.approx(20.0)
    assert _read("nuset.watershed_ms", ctx) == pytest.approx(15.0)
    assert _read("nuset.cleanup_ms", ctx) == pytest.approx(12.0)
    assert _read("nuset.decode_wait_ms", ctx) == pytest.approx(1e3 * 0.34 / 320)
    assert _read("nuset.fetch_bytes", ctx) == 6_200_000
    assert _read("nuset.watershed_redo_share", ctx) == pytest.approx(25.0)
    floor = arith.floor_s(ctx["nuset_forward_rows"], 67e12, 3.35e12)
    assert _read("nuset.forward_roofline", ctx) == pytest.approx(100 * floor * 320 / (0.045 * 640))
    assert _read("nuset.mfu", ctx) == pytest.approx(100 * 1.0997386e12 * 320 / 50 / 67e12, rel=1e-6)
    assert _read("nuset.device_idle", ctx) == pytest.approx(40.0)
    assert _read("metaseg_images_per_s", ctx) == pytest.approx(6.4)


@pytest.mark.parametrize("name", NUSET_METRICS)
def test_each_nuset_reader_reports_nothing_in_a_cell_without_nuset(name):
    """A metaseg cell's ``ctx`` (its stages, counters and profile, none of
    NuSeT's facts) and a CPU run's: nothing to read."""
    metaseg = {"cfg": CFG, "device_name": arith.H100, "setup_s": 12.0, "window_s": 20.0, "images": 80,
               "stages": {"metaseg.forward": [0.2] * 40, "metaseg.decode_wait": [0.01] * 41},
               "fetch": {"bytes": 80 * 1049088, "copies": 40, "seconds": 0.1}, "fallbacks": {},
               "profile": {"busy_s": 3.0, "window_s": 4.0, "images": 16, "device_ops": [], "idle_gaps": []},
               "patches_per_image": 100}
    assert _read(name, metaseg) is None
    cpu = _ctx(device_name="cpu", profile=None)
    if name in ("nuset.forward_roofline", "nuset.mfu", "nuset.device_idle"):
        assert _read(name, cpu) is None


@pytest.mark.cuda
def test_the_tf32_control_fails_the_nuset_check_and_the_program_passes_it():
    """On the card at the cell's own size (``python3 -m pytest portbench/tests -m cuda``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size on the card")
    from portbench.readings import read_seed
    from portbench.run import prepare_env

    prepare_env(False)
    bench = spec.load_benchmark()
    limits = CFG["check"]["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        images, prog, ctl = read_seed(bench, "nuset_segment_2048", seed, 3.0, control=True)
        assert images > 0
        assert all(prog[k] <= limits[k] for k in limits), (seed, prog)
        assert any(ctl[k] > limits[k] for k in limits), (seed, ctl)
