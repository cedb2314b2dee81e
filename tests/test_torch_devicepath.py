"""The port's branch switches (``ecseg_torch/runtime/devicepath.py``) against
the JAX package's (``ecseg_tpu/runtime/devicepath.py``): the watershed mode,
the fast-path and check flags for every documented value of
``ECSEG_FAST_WATERSHED`` with ``ECSEG_DEVICE_PIPELINE`` at 1 and at 0, and
``use_device_path`` for the values both packages parse.  Unset or not
understood, the JAX package takes the device path only on a TPU backend and
the port always takes its own."""

import pytest

from ecseg_tpu.runtime import devicepath as jdp
from ecseg_torch.runtime import devicepath as tdp

WATERSHED_VALUES = [None, "", "default", "0", "false", "no", "off", "host", "HOST", "auto", " Auto ", "check", "1", "true", "yes", "on", "fast"]


def _set(monkeypatch, var, value):
    if value is None:
        monkeypatch.delenv(var, raising=False)
    else:
        monkeypatch.setenv(var, value)


@pytest.mark.parametrize("pipeline", ["1", "0"])
@pytest.mark.parametrize("value", WATERSHED_VALUES, ids=lambda v: repr(v))
def test_watershed_mode_table_matches_jax(monkeypatch, pipeline, value):
    monkeypatch.setenv("ECSEG_DEVICE_PIPELINE", pipeline)
    _set(monkeypatch, "ECSEG_FAST_WATERSHED", value)
    assert tdp.fast_watershed_mode() == jdp.fast_watershed_mode()
    assert tdp.fast_watershed() == jdp.fast_watershed()
    assert tdp.fast_watershed_check() == jdp.fast_watershed_check()


@pytest.mark.parametrize("value", ["1", "true", " YES ", "on", "0", "false", "no", "Off"])
def test_device_pipeline_values_match_jax(monkeypatch, value):
    monkeypatch.setenv("ECSEG_DEVICE_PIPELINE", value)
    assert tdp.use_device_path() == jdp.use_device_path()


@pytest.mark.parametrize("value", [None, "", "maybe"])
def test_device_path_by_default(monkeypatch, capsys, value):
    """The port's default: its device path (the JAX package's on this CPU
    backend: the host); a value not understood warns as the JAX package
    warns."""
    _set(monkeypatch, "ECSEG_DEVICE_PIPELINE", value)
    monkeypatch.delenv("ECSEG_FAST_WATERSHED", raising=False)
    assert tdp.use_device_path() is True
    port_err = capsys.readouterr().err
    assert jdp.use_device_path() is False
    assert port_err == capsys.readouterr().err
    assert ("not understood" in port_err) == (value == "maybe")
    assert tdp.fast_watershed_mode() == "auto"
