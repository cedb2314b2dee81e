"""The port's TensorFlow-free weight converters against the JAX package's
TensorFlow scripts, on the TensorFlow-written fixtures of
``tests/fixtures/tf/`` (``make_tf_fixtures.py``):

- ``python -m ecseg_torch.convert_tf1_ckpt``: the NuSeT checkpoint pair's
  ``nuset.npz``, key for key, dtype, shape and bytes equal to
  ``scripts/convert_tf1_ckpt.py``'s;
- ``python -m ecseg_torch.convert_savedmodel``: the two SavedModels'
  ``.h5``, read by both packages' ``import_keras_h5`` (h5py on the JAX
  side), with the layers, weight names and bit-equal weights of
  ``scripts/convert_savedmodel.py``'s ``.h5`` and its ``model_config`` but
  for the initializers' ``module``/``registered_name``; the port's and the
  JAX executor's forward from it equal to Keras's stored output;
- each JAX script run again in a subprocess (TensorFlow needed) on the
  committed inputs, its output equal to the committed one;
- the card phase's writers (``chip_smoke.nuset_tf1_checkpoints``,
  ``write_keras_savedmodel``) through the converters at small widths."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from ecseg_torch import convert_savedmodel, convert_tf1_ckpt
from ecseg_torch.core import hdf5
from ecseg_torch.models import keras_import as tk
from ecseg_torch.models.weights import load_npz
from ecseg_tpu.models import keras_import as jk

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

FIX = pathlib.Path(__file__).parent / "fixtures" / "tf"
REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-5  # tests/test_torch_keras_import.py's
MODELS = ("seq", "func")
INITIALIZER_ONLY_KEYS = ("module", "registered_name")  # what the .h5 adds to each serialized initializer


def _npz_equal(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_tf1_converter_writes_the_jax_scripts_npz(tmp_path, capsys):
    out = tmp_path / "nuset.npz"
    assert convert_tf1_ckpt.main([str(FIX / "nuset"), str(out)]) == 0
    assert capsys.readouterr().out == f"wrote {out}\n"
    _npz_equal(out, FIX / "nuset.npz")
    tree = load_npz(str(out))
    assert sorted(tree) == ["fg", "whole"] and sorted(tree["fg"]) == ["rpn", "unet"]
    assert sorted(tree["fg"]["rpn"]) == ["rpn_bbox_pred", "rpn_cls_score", "rpn_conv"]
    assert list(tree["whole"]["final"]) == ["kernel"]  # no bias
    assert tree["whole"]["deconv1"]["kernel"].shape == (3, 3, 2, 2) and tree["whole"]["deconv4"]["kernel"].shape == (3, 3, 4, 4)


def test_tf1_converter_defaults_and_unknown_rpn_scope(tmp_path, monkeypatch):
    """No arguments: ``models/nuset`` to ``models/nuset.npz`` in the working
    directory; an RPN scope it does not know raises, as the script's does."""
    shutil.copytree(FIX / "nuset", tmp_path / "models" / "nuset")
    monkeypatch.chdir(tmp_path)
    assert convert_tf1_ckpt.main([]) == 0
    _npz_equal(tmp_path / "models" / "nuset.npz", FIX / "nuset.npz")
    bad = tmp_path / "bad"
    bad.mkdir()
    w = np.ones((1, 1, 2, 2), np.float32)
    chip_smoke.write_tf_bundle(str(bad / "whole_norm.ckpt"), {"model_U-Net/final/kernel": w})
    chip_smoke.write_tf_bundle(str(bad / "foreground.ckpt"), {"model_U-Net/final/kernel": w, "model_RPN/rpn_other/kernel": w})
    with pytest.raises(ValueError, match="unrecognized RPN variable scope 'model_RPN/rpn_other/kernel'"):
        convert_tf1_ckpt.convert(str(bad), str(tmp_path / "bad.npz"))


def _strip_initializer_keys(value, seen):
    if isinstance(value, dict):
        seen.update(k for k in INITIALIZER_ONLY_KEYS if k in value)
        return {k: _strip_initializer_keys(v, seen) for k, v in value.items() if k not in INITIALIZER_ONLY_KEYS}
    if isinstance(value, list):
        return [_strip_initializer_keys(v, seen) for v in value]
    return value


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    d = tmp_path_factory.mktemp("h5")
    for name in MODELS:
        assert convert_savedmodel.main([str(FIX / name), str(d / f"{name}.h5")]) == 0
    return d


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


@pytest.mark.parametrize("name", MODELS)
def test_savedmodel_h5_has_the_jax_scripts_layers_and_weights(converted, name):
    ours, theirs = str(converted / f"{name}.h5"), str(FIX / f"{name}.h5")
    with hdf5.File(ours) as a, h5py.File(theirs, "r") as b:
        names = [_decode(n) for n in b["model_weights"].attrs["layer_names"]]
        assert [_decode(n) for n in a["model_weights"].attrs["layer_names"]] == names
        assert _decode(a.attrs["keras_version"]) == _decode(b.attrs["keras_version"])
        for layer in names:
            wnames = [_decode(n) for n in b["model_weights"][layer].attrs["weight_names"]]
            assert [_decode(n) for n in a["model_weights"][layer].attrs["weight_names"]] == wnames, layer
            for w in wnames:
                x, y = np.array(a["model_weights"][layer][w]), np.array(b["model_weights"][layer][w])
                assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), (layer, w)
    # both executors, on both files: the same weights, bit for bit
    for got, want in ((tk.import_keras_h5(ours, device="cpu"), tk.import_keras_h5(theirs, device="cpu")),):
        assert list(got.state_dict()) == list(want.state_dict())
        assert all(torch.equal(got.state_dict()[k], want.state_dict()[k]) for k in want.state_dict())
    jg, jw = jk.import_keras_h5(ours).params, jk.import_keras_h5(theirs).params
    import jax

    flat_g, tree_g = jax.tree_util.tree_flatten(jg)
    flat_w, tree_w = jax.tree_util.tree_flatten(jw)
    assert tree_g == tree_w and all(np.asarray(g).tobytes() == np.asarray(w).tobytes() for g, w in zip(flat_g, flat_w))


@pytest.mark.parametrize("name", MODELS)
def test_savedmodel_h5_config_is_the_jax_scripts(converted, name):
    with hdf5.File(str(converted / f"{name}.h5")) as a, h5py.File(str(FIX / f"{name}.h5"), "r") as b:
        ours, theirs = json.loads(_decode(a.attrs["model_config"])), json.loads(_decode(b.attrs["model_config"]))
    seen = set()
    assert ours == _strip_initializer_keys(theirs, seen)
    assert seen == set(INITIALIZER_ONLY_KEYS)  # the only difference, and it is there
    assert "__tuple__" not in json.dumps(ours) and "shared_object_id" not in json.dumps(ours)


@pytest.mark.parametrize("name", MODELS)
def test_forward_from_the_converted_h5_matches_keras_and_jax(converted, name):
    data = np.load(FIX / "keras.npz")
    x, y = data[f"x_{name}"], data[f"y_{name}"]
    path = str(converted / f"{name}.h5")
    with torch.no_grad():
        got = tk.import_keras_h5(path, device="cpu")(x).numpy()
    np.testing.assert_allclose(got, y, rtol=RTOL, atol=ATOL)
    import jax.numpy as jnp

    np.testing.assert_allclose(got, np.asarray(jk.import_keras_h5(path)(jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def test_savedmodel_converter_refuses_what_has_no_h5(tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(FIX / "seq" / "variables", bare / "variables")
    with pytest.raises(ValueError, match="has no keras_metadata.pb"):
        convert_savedmodel.convert(str(bare), str(tmp_path / "x.h5"))
    # a subclassed model: the root's metadata holds no model_config
    node = chip_smoke._pb(3, "root") + chip_smoke._pb(4, "_tf_keras_model") + chip_smoke._pb(5, json.dumps({"name": "net", "class_name": "Net"}))
    (bare / "keras_metadata.pb").write_bytes(chip_smoke._pb(1, node))
    with pytest.raises(ValueError, match="no model_config"):
        convert_savedmodel.convert(str(bare), str(tmp_path / "x.h5"))
    assert convert_savedmodel.main([str(bare)]) == 2


def test_chip_smoke_writers_through_the_converters(tmp_path, monkeypatch):
    """The card phase's inputs at small widths: the demo NuSeT tree written
    as the reference's checkpoints converts back to itself, array for
    array; ecSeg-i and ecSeg-c written as SavedModels convert to ``.h5``
    files whose config is ``chip_smoke``'s and whose forward equals the
    port's classifiers from the same trees."""
    from ecseg_torch.models.demo import demo_ecseg_c_tree, demo_ecseg_i_tree
    from ecseg_torch.models.weights import classifier_from_numpy
    from ecseg_torch.pipelines.interseg import preprocess_ecseg_c

    tree = load_npz(str(FIX / "nuset.npz"))  # a NuSeT tree at narrow widths
    os.makedirs(tmp_path / "models" / "nuset")
    for file, tensors in chip_smoke.nuset_tf1_checkpoints(tree).items():
        chip_smoke.write_tf_bundle(str(tmp_path / "models" / "nuset" / file), tensors)
    monkeypatch.chdir(tmp_path)
    assert convert_tf1_ckpt.main([]) == 0
    got = load_npz("models/nuset.npz")

    def leaves(t, p=()):
        for k, v in t.items():
            yield from leaves(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)]

    want = dict(leaves(tree))
    assert dict(leaves(got)).keys() == want.keys()
    assert all(v.dtype == want[k].dtype and v.shape == want[k].shape and v.tobytes() == want[k].tobytes() for k, v in leaves(got))

    rng = np.random.default_rng(0)
    rgb = (rng.random((2, 256, 256, 3)) * 255).astype(np.uint8)
    for name, cfg, t, inp in (("interseg", chip_smoke.ecseg_i_keras_config(), demo_ecseg_i_tree(), rgb[..., 0]),
                              ("ecseg_c", chip_smoke.ecseg_c_keras_config(), demo_ecseg_c_tree(), np.stack([preprocess_ecseg_c(c) for c in rgb]))):
        t["conv2"]["kernel"] = rng.standard_normal(t["conv2"]["kernel"].shape).astype(np.float32) * 0.05
        chip_smoke.write_keras_savedmodel(str(tmp_path / "sm" / name), cfg, chip_smoke.classifier_keras_weights(t))
        assert convert_savedmodel.main([str(tmp_path / "sm" / name), f"{name}.h5"]) == 0
        with hdf5.File(f"{name}.h5") as f:
            assert json.loads(_decode(f.attrs["model_config"])) == cfg
        with torch.no_grad():
            got = tk.import_keras_h5(f"{name}.h5", device="cpu")(torch.from_numpy(inp)).numpy()
            want = classifier_from_numpy(t)(torch.from_numpy(inp)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _run_jax_script(args):
    pytest.importorskip("tensorflow")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_jax_tf1_script_reproduces_the_committed_npz(tmp_path):
    out = tmp_path / "nuset.npz"
    _run_jax_script(["scripts/convert_tf1_ckpt.py", str(FIX / "nuset"), str(out)])
    _npz_equal(out, FIX / "nuset.npz")


def test_jax_savedmodel_script_reproduces_the_committed_h5(tmp_path):
    out = tmp_path / "func.h5"
    _run_jax_script(["scripts/convert_savedmodel.py", str(FIX / "func"), str(out)])
    with h5py.File(out, "r") as a, h5py.File(FIX / "func.h5", "r") as b:
        assert json.loads(a.attrs["model_config"]) == json.loads(b.attrs["model_config"])
        arrays = {}
        b["model_weights"].visititems(lambda n, o: arrays.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset) else None)
        got = {}
        a["model_weights"].visititems(lambda n, o: got.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset) else None)
        assert got.keys() == arrays.keys() and all(got[k].tobytes() == arrays[k].tobytes() for k in arrays)
