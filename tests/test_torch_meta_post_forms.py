"""The port's device meta_inference in each post-processing form that the
JAX package's variables select -- default (multiclass labels and flood,
kernels B5/B6), ``ECSEG_MC_LABEL=0`` (per class, B2/B4) and
``ECSEG_MC_MERGE=1`` (fused label+flood merge, B9) -- against
meta_inference_tpu in the same form and against the host oracle, on the
cases of tests/test_torch_meta_post.py; the variables parsed as the JAX
package parses them; and the kernel calls per image through ``main`` in
each form, which must equal the launch counts chip_smoke.py checks on the
card (on the CPU the wrappers take their twins, so the calls are counted)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from ecseg_tpu.ops import meta_post_tpu
from ecseg_tpu.ops.meta_post import meta_inference as jax_oracle
from ecseg_tpu.ops.meta_post_tpu import meta_inference_tpu
from ecseg_torch.core import imgio
from ecseg_torch.core.config import Config
from ecseg_torch.models.demo import demo_metaseg_params
from ecseg_torch.models.weights import params_to_numpy, save_npz
from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import meta_post_gpu, morphology_gpu
from ecseg_torch.pipelines import metaseg
from ecseg_torch.runtime import fallbacks

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_meta_post import CASES

FORMS = sorted(chip_smoke.FORM_ENV)
# two map shapes, (180, 220) and (96, 128), so each form compiles the JAX
# twin twice; JAX's ``ok`` is True on all of them
JAX_CASES = ["random0", "random1", "all_ec", "nuclei_no_chrom", "chrom_no_ec", "dyadic_edge"]


def _set_form(monkeypatch, form):
    for var in chip_smoke.FORM_VARS:
        monkeypatch.delenv(var, raising=False)
    for var, value in chip_smoke.FORM_ENV[form].items():
        monkeypatch.setenv(var, value)


@pytest.fixture
def jax_form(monkeypatch):
    """Select a form for both packages.  meta_inference_tpu is module-jitted
    and reads the variables when it traces, so its cache is cleared before
    and after (as tests/test_meta_post_tpu.py does)."""
    meta_inference_tpu.clear_cache()
    yield lambda form: _set_form(monkeypatch, form)
    meta_inference_tpu.clear_cache()


def _port(img):
    out, ok = meta_post_gpu.meta_inference_gpu(torch.from_numpy(img))
    assert out.dtype == torch.int64
    return out.numpy(), bool(ok)


@pytest.mark.parametrize("form", FORMS)
def test_form_matches_jax_twin_in_the_same_form(jax_form, form):
    jax_form(form)
    for name in JAX_CASES:
        img = CASES[name]
        jout, jok = meta_inference_tpu(jnp.asarray(img))
        out, ok = _port(img)
        assert bool(jok) and ok, name
        np.testing.assert_array_equal(out, np.asarray(jout).astype(np.int64), err_msg=name)
        np.testing.assert_array_equal(out, jax_oracle(img.copy()), err_msg=name)


@pytest.mark.parametrize("form", FORMS)
def test_form_matches_host_oracle(monkeypatch, form):
    _set_form(monkeypatch, form)
    for name, img in sorted(CASES.items()):
        out, ok = _port(img)
        assert ok, name
        np.testing.assert_array_equal(out, jax_oracle(img.copy()), err_msg=name)


@pytest.mark.parametrize("form", FORMS)
def test_budget_overflow_lowers_ok_in_every_form(monkeypatch, form):
    _set_form(monkeypatch, form)
    img = np.zeros((96, 128), np.int64)
    img[::2, ::2] = 2  # 3072 single-pixel chromosomes > MAX_CHROM
    _, ok = _port(img)
    assert not ok


@pytest.mark.parametrize("value", [None, "", "1", "on", "yes", "true", "0", "false", "no", "off", " OFF ", "False", "2"])
def test_mc_label_parsed_as_the_jax_package_parses_it(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("ECSEG_MC_LABEL", raising=False)
    else:
        monkeypatch.setenv("ECSEG_MC_LABEL", value)
    assert meta_post_gpu.use_multiclass() == meta_post_tpu._use_mc()


@pytest.mark.parametrize(
    "value,fused", [(None, False), ("", False), ("0", False), ("on", False), ("yes", False), ("1", True), ("true", True), (" TRUE ", True)]
)
def test_mc_merge_parsed_as_the_jax_package_parses_it(monkeypatch, value, fused):
    """meta_post_tpu._merge_comp: ``.strip().lower() in ("1", "true")``."""
    if value is None:
        monkeypatch.delenv("ECSEG_MC_MERGE", raising=False)
    else:
        monkeypatch.setenv("ECSEG_MC_MERGE", value)
    assert meta_post_gpu.use_fused_merge() is fused


def _count_wrapper_calls(monkeypatch):
    """Count each kernel wrapper's calls where the port's modules call it."""
    calls = dict.fromkeys(K.LAUNCHES, 0)
    for key, (_, fname, *_rest) in chip_smoke.KERNELS.items():
        fn = getattr(K, fname)

        def counted(*a, _fn=fn, _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)

        patched = [m for m in (meta_post_gpu, morphology_gpu, metaseg) if getattr(m, fname, None) is fn]
        assert patched, f"no port module calls {fname}"
        for m in patched:
            monkeypatch.setattr(m, fname, counted)
    return calls


@pytest.mark.parametrize("form", FORMS)
def test_kernel_calls_per_image_match_chip_smoke(tmp_path, monkeypatch, form):
    """``main`` on two small synthetic DAPI images (one crowded, so its
    device post-processing overflows and is redone on the host) with a
    narrow crafted U-Net: the wrapper calls per image are the form's
    PER_IMAGE_LAUNCHES, which chip_smoke.py holds the card's counters to."""
    _set_form(monkeypatch, form)
    os.makedirs(tmp_path / "models")
    model = demo_metaseg_params(torch.Generator().manual_seed(0), widths=(8, 16), bottleneck=32)
    save_npz(str(tmp_path / "models" / "metaseg.npz"), params_to_numpy(model))
    monkeypatch.chdir(tmp_path)
    folder = tmp_path / "imgs"
    os.makedirs(folder)
    rng = np.random.default_rng(0)
    for k in range(2):
        imgio.write_tiff(str(folder / f"img{k}.tif"), chip_smoke.synthetic_dapi(rng, 320, 352, crowded=k == 1))
    calls = _count_wrapper_calls(monkeypatch)
    redos = fallbacks.counts().get(fallbacks.META_POST_OK, 0)
    assert metaseg.main(config=Config(raw={"metaseg": {"inpath": str(folder)}}), device="cpu") == 0
    assert fallbacks.counts()[fallbacks.META_POST_OK] == redos + 1
    assert calls == {key: 2 * n for key, n in chip_smoke.PER_IMAGE_LAUNCHES[form].items()}
