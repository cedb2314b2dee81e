"""The readers of the metaseg path's parts: the wait on the reader threads
(``metaseg.decode_wait_ms``, a program stage over the window) and the
device's idle time under the forward and the post
(``metaseg.forward_idle_ms``, ``metaseg.post_idle_ms``, the profile's idle
gaps of a stage and its dotted ranges over the profiled stretch's images).
On synthetic ``ctx``; CPU only."""

from __future__ import annotations

import pytest

from portbench import spec

READERS = ("metaseg.decode_wait_ms", "metaseg.forward_idle_ms", "metaseg.post_idle_ms")

# a profiled stretch of 16 images: the idle seconds by the innermost name open on the host
GAPS = [["metaseg.forward", 0.1], ["metaseg.post.device", 0.08], ["metaseg.forward.decoder", 0.2],
        ["outside stages", 0.05], ["metaseg.post", 0.04], ["metaseg.forward.encoder", 0.3],
        ["metaseg.forwardX", 7.0], ["metaseg.post_x", 9.0], ["metaseg.forward.head", 0.02],
        ["metaseg.post.decode", 0.04]]
PROFILE = {"busy_s": 10.0, "window_s": 11.0, "images": 16, "device_ops": [], "idle_gaps": GAPS}


def _ctx(**over):
    ctx = {"window_s": 20.0, "images": 40, "profile": PROFILE,
           "stages": {"metaseg.decode_wait": [0.01] * 41, "metaseg.forward": [0.4] * 40}}
    ctx.update(over)
    return ctx


def _read(name, ctx):
    return spec.load_module([spec.PKG], "metrics", name).read(ctx)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reports_nothing_without_its_input(name):
    assert _read(name, _ctx(stages={}, profile=None)) is None
    if name == "metaseg.decode_wait_ms":  # a program whose stage table lacks the wait
        assert _read(name, _ctx(stages={"metaseg.forward": [0.4] * 40})) is None


def test_the_wait_is_its_stages_self_time_over_the_windows_images():
    assert _read("metaseg.decode_wait_ms", _ctx()) == pytest.approx(1e3 * 0.41 / 40)
    assert _read("metaseg.decode_wait_ms", _ctx(images=20)) == pytest.approx(1e3 * 0.41 / 20)


@pytest.mark.parametrize("name,seconds", [("metaseg.forward_idle_ms", 0.1 + 0.2 + 0.3 + 0.02),
                                          ("metaseg.post_idle_ms", 0.08 + 0.04 + 0.04)])
def test_the_idle_readers_sum_a_stage_and_its_dotted_ranges_only(name, seconds):
    # metaseg.forwardX and metaseg.post_x share the prefix and are not the stage's parts
    assert _read(name, _ctx()) == pytest.approx(1e3 * seconds / 16)


@pytest.mark.parametrize("name", ["metaseg.forward_idle_ms", "metaseg.post_idle_ms"])
def test_the_idle_readers_divide_by_the_profiles_images_not_the_windows(name):
    one = _read(name, _ctx())
    assert _read(name, _ctx(images=400)) == pytest.approx(one)
    assert _read(name, _ctx(profile=dict(PROFILE, images=32))) == pytest.approx(one / 2)


@pytest.mark.parametrize("name", ["metaseg.forward_idle_ms", "metaseg.post_idle_ms"])
def test_a_profile_with_no_gap_under_the_stage_reads_zero(name):
    """A profile whose gaps all fell elsewhere reads 0; one of a program
    that names its stages alone, without their ranges, reads the stage."""
    assert _read(name, _ctx(profile=dict(PROFILE, idle_gaps=[["outside stages", 0.5]]))) == 0.0
    stages_only = [["metaseg.forward", 0.55], ["metaseg.post", 0.26], ["outside stages", 0.1]]
    got = _read(name, _ctx(profile=dict(PROFILE, idle_gaps=stages_only)))
    assert got == pytest.approx(1e3 * (0.55 if "forward" in name else 0.26) / 16)
