"""The yardstick's arithmetic (FLOP counts, peaks, floors), each metric's
reader on synthetic tracer times, counters and profiler records, and the
profile's completeness test.  CPU only."""

from __future__ import annotations


import pytest

from portbench import arith, profiling, spec

METASEG = {"widths": [32, 64, 128, 256], "bottleneck": 512, "num_classes": 4, "patch": 256, "in_channels": 1,
           "dtype": "float32", "overlap": 25}
CELL = spec.load_json([spec.PKG], "configs", "ecseg_metaseg_unet")


@pytest.mark.parametrize("cfg,gflop", [(METASEG, 25.42), (CELL, 101.58)], ids=["half_width", "cell"])
def test_metaseg_count_is_roofline_forwards(cfg, gflop):
    from ecseg_torch import roofline_forward

    ours = arith.metaseg_rows(cfg)
    theirs = roofline_forward.layers(tuple(cfg["widths"]), cfg["bottleneck"])
    assert [(n, f) for n, f, _ in ours] == [(n, f) for n, f, _ in theirs]
    # bytes: theirs at bf16 (2 B an element), ours at float32, the epilogue in float32 on both
    assert [b for n, _, b in ours if n != "epilogue"] == [2 * b for n, _, b in theirs if n != "epilogue"]
    assert round(arith.flops(ours) / 1e9, 2) == gflop


def test_metaseg_count_by_hand_at_16_px():
    k = 2 * 9  # FLOPs a multiply-add of a 3x3 tap
    rows = [k * 256 * 1 * 64, k * 256 * 64 * 64,  # level 1, 16^2
            k * 64 * 64 * 128, k * 64 * 128 * 128,  # level 2, 8^2
            k * 16 * 128 * 256, k * 16 * 256 * 256,  # level 3, 4^2
            k * 4 * 256 * 512, k * 4 * 512 * 512,  # level 4, 2^2
            k * 1 * 512 * 1024, k * 1 * 1024 * 1024,  # bottleneck, 1^2
            k * 4 * 1024 * 512 // 4, k * 4 * 1024 * 512, k * 4 * 512 * 512,  # up4 at 9/4 taps, dec4
            k * 16 * 512 * 256 // 4, k * 16 * 512 * 256, k * 16 * 256 * 256,
            k * 64 * 256 * 128 // 4, k * 64 * 256 * 128, k * 64 * 128 * 128,
            k * 256 * 128 * 64 // 4, k * 256 * 128 * 64, k * 256 * 64 * 64,
            2 * 256 * 64 * 4]  # the 1x1 head
    assert arith.flops(arith.metaseg_rows(dict(CELL, patch=16))) == sum(rows)


@pytest.mark.parametrize("h,w", [(2048, 2048), (256, 256), (462, 874), (463, 300), (1024, 2048)])
def test_patch_count_is_the_references_positions(h, w):
    from portbench.reference import ecseg_metaseg_unet as ref

    assert arith.patch_count(h, w) == len(ref.positions(h, w))


def test_floor_takes_each_layers_larger_bound():
    rows = [("a", 67, 0), ("b", 0, 335), ("c", 134, 335)]
    assert arith.floor_s(rows, 67.0, 335.0) == pytest.approx(1 + 1 + 2)
    assert arith.peaks("cpu") is None and arith.peaks(arith.H100)["float32"] == 67e12


def _ctx(**over):
    ctx = {"cfg": METASEG, "device_name": arith.H100, "setup_s": 12.5, "window_s": 20.0, "images": 80,
           "stages": {"metaseg.forward": [0.2] * 80, "metaseg.post": [0.05] * 40, "metaseg.stitch": [0.001] * 80},
           "fetch": {"bytes": 80 * 1049088, "copies": 40, "seconds": 0.1}, "profile": None,
           "patches_per_image": 100, "rows": arith.metaseg_rows(METASEG)}
    ctx.update(over)
    return ctx


def _read(name, ctx):
    return spec.load_module([spec.PKG], "metrics", name).read(ctx)


def test_the_metaseg_readers():
    ctx = _ctx()
    assert _read("setup_s", ctx) == 12.5
    assert _read("metaseg_images_per_s", ctx) == 4.0
    assert _read("metaseg.forward_ms", ctx) == pytest.approx(200.0)
    assert _read("metaseg.post_ms", ctx) == pytest.approx(25.0)
    assert _read("metaseg.fetch_bytes", ctx) == 1049088
    assert _read("metaseg.host_other_ms", ctx) == pytest.approx(1e3 * (20 - 16 - 2 - 0.08) / 80)
    floor = arith.floor_s(ctx["rows"], 67e12, 3.35e12)
    assert _read("metaseg.forward_roofline", ctx) == pytest.approx(100 * floor * 100 * 80 / (0.2 * 80))
    assert _read("metaseg.mfu", ctx) == pytest.approx(100 * arith.flops(ctx["rows"]) * 100 * 80 / 20 / 67e12)
    assert _read("metaseg.device_idle", _ctx(profile={"busy_s": 3.0, "window_s": 4.0})) == pytest.approx(25.0)


def test_readers_without_their_source_report_nothing():
    ctx = _ctx(stages={}, profile=None, device_name="cpu", fetch={"bytes": 0, "copies": 0, "seconds": 0})
    for name in ("metaseg.forward_ms", "metaseg.forward_roofline", "metaseg.post_ms", "metaseg.fetch_bytes",
                 "metaseg.host_other_ms", "metaseg.mfu", "metaseg.device_idle"):
        assert _read(name, ctx) is None, name


def _events():
    """A stretch of 1000 ns on the main thread (1): stage a holds b, three
    kernels and the trace's copy of an annotation on the device's line."""
    return [("portbench.stretch", False, 0, 1000, 1), ("stage:a", False, 100, 600, 1),
            ("stage:b", False, 200, 300, 1), ("stage:x", False, 0, 1000, 7),
            ("k1", True, 0, 150, 0), ("k2", True, 250, 400, 0), ("k1", True, 700, 800, 0),
            ("stage:a", True, 100, 600, 0), ("spin_kernel", True, 0, 1000, 0)]


def test_the_profile_reads_busy_time_idle_gaps_by_stage_and_top_operations():
    out = profiling.read(_events(), 2)
    assert out["window_s"] == pytest.approx(1e-6) and out["busy_s"] == pytest.approx(4e-7)
    assert out["device_ops"] == [["k1", pytest.approx(2.5e-7)], ["k2", pytest.approx(1.5e-7)]]
    assert dict(out["idle_gaps"]) == {"a": pytest.approx(3e-7), "outside stages": pytest.approx(2e-7),
                                      "b": pytest.approx(1e-7)}


def test_an_incomplete_profile_is_refused(monkeypatch):
    dev = profiling._device(_events())
    assert profiling.lost_share(dev, dev) == 0 and profiling.lost_share([], dev) == profiling.lost_share(dev, []) == 1
    # one k1 of two lost: half of k1's 250 ns, of the 400 ns of device time
    assert profiling.lost_share(dev, [e for e in dev if e[2] != 700]) == pytest.approx(125 / 400)
    assert profiling.lost_share([e for e in dev if e[2] != 700], dev) == 0  # the earlier stretch lost it
    # a few records of many: the stretch is used
    many = [("k", True, 10 * i, 10 * i + 5, 0) for i in range(10000)]
    assert profiling.lost_share(many, many[:-10]) <= profiling.LOST_SHARE < profiling.lost_share(many, many[:-30])
    full = _events()
    lossy = [e for e in full if e[0] != "k2"]
    passes = iter([(full, 2), (lossy, 2)] * 3)
    monkeypatch.setattr(profiling, "_record", lambda step: next(passes))
    assert profiling.profile(lambda: 1, log=lambda *a: None) is None
    passes = iter([(lossy, 2), (full, 2), (full, 2), (full, 2)])
    assert profiling.profile(lambda: 1, log=lambda *a: None)["busy_s"] == pytest.approx(4e-7)
