"""The port's imported-Keras executor (ecseg_torch/models/keras_import.py)
against the JAX package's (ecseg_tpu/models/keras_import.py) on the same
Keras files, written with h5py in Keras's layouts (as
tests/test_keras_import.py writes them): a legacy H5 save
(``model_config`` attr, ``model_weights/<layer>`` groups with their
``weight_names``) and a Keras 3 ``.keras`` zip (``config.json`` and
``model.weights.h5`` with ``layers/<snake_class>/vars/<i>``).  One case per
supported layer type (stride 1 and 2 where the layer takes a stride; odd
sizes, so 'SAME' pads unevenly), the graph forms (Sequential, Functional with
Concatenate/Add, a nested sub-model, a multi-output sub-model read at tensor
index 1, a shared layer, Flatten -> Dense), a ``.keras`` zip, an unsupported
type, and the metaseg loader's ``.h5``-first order.  Tolerance: outputs
within 1e-5 absolute + 1e-5 relative of the JAX executor's (float32, both
on the CPU).  The port reads every file with its own HDF5 reader
(``core/hdf5.py``), the JAX package with h5py.  Also chip_smoke's Keras
configs of the metaseg U-Net, ecSeg-i and ecSeg-c, through its dict-backed
fetcher, against ``MetasegUNet``, ``EcsegI`` and ``EcsegC`` at small
widths; Keras 3.13's own saves (``tests/fixtures/keras3_small.*``) through
both executors; files written by core/hdf5.py's writer, read alike by
h5py and the port's reader and run alike by both executors; and
``metaseg.main`` from such a ``metaseg.h5`` against the same weights'
``metaseg.npz``, byte for byte."""

import io
import json
import os
import zipfile

import h5py
import numpy as np
import pytest
import torch

import chip_smoke
from ecseg_tpu.models import keras_import as jk
from ecseg_torch.core.hdf5 import write_keras_h5
from ecseg_torch.models import keras_import as tk

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

RTOL = ATOL = 1e-5
X_SHAPE = (2, 9, 11, 3)  # odd sides: 'SAME' at stride 2 pads the bottom/right


def L(cls, name, inbound=None, **cfg):
    """A layer entry of a Keras config (``inbound``: legacy inbound nodes)."""
    entry = {"class_name": cls, "config": {"name": name, **cfg}}
    if inbound is not None:
        entry["inbound_nodes"] = inbound
    return entry


def sequential(*layers, name="seq"):
    return {"class_name": "Sequential", "config": {"name": name, "layers": [L("InputLayer", "in0")] + list(layers)}}


def functional(layers, outputs, inputs=("inp",), name="fn"):
    ins = [L("InputLayer", n, []) for n in inputs]
    return {
        "class_name": "Functional",
        "config": {"name": name, "layers": ins + list(layers), "input_layers": [[n, 0, 0] for n in inputs], "output_layers": outputs},
    }


def ref(name, node=0, tensor=0):
    return [name, node, tensor, {}]


def conv(name, filters, k, stride=1, padding="same", activation="linear", use_bias=True, inbound=None, cls="Conv2D"):
    return L(cls, name, inbound, filters=filters, kernel_size=[k, k], strides=[stride, stride], padding=padding,
             activation=activation, use_bias=use_bias)


def write_legacy_h5(path, config, weights):
    """``weights``: top-level layer name -> [(path relative to its group,
    array)], the layer's own weights (``"c/kernel:0"``) or a nested model's
    (``"subconv/kernel:0"``), in Keras's order."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(config)
        mw = f.create_group("model_weights")
        for layer, items in weights.items():
            g = mw.create_group(layer)
            for rel, arr in items:
                g.create_dataset(rel, data=arr)
            g.attrs["weight_names"] = [rel.encode() for rel, _ in items]


def _arr(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def kernel_weights(rng, name, shape, bias=True):
    w = [(f"{name}/kernel:0", _arr(rng, *shape))]
    return w + [(f"{name}/bias:0", _arr(rng, shape[-1]))] if bias else w


def _layer_case(rng, layer, weights=()):
    """A one-layer Sequential after the input: (config, weights, x)."""
    return sequential(layer), ({layer["config"]["name"]: list(weights)} if weights else {}), _arr(rng, *X_SHAPE, scale=1.0)


def _bn(rng, scale, center):
    ws = ([("bn/gamma:0", _arr(rng, 3) + 1)] if scale else []) + ([("bn/beta:0", _arr(rng, 3))] if center else [])
    ws += [("bn/moving_mean:0", _arr(rng, 3)), ("bn/moving_variance:0", np.abs(_arr(rng, 3)) + 0.1)]
    return _layer_case(rng, L("BatchNormalization", "bn", scale=scale, center=center), ws)


def _conv_case(rng, k, stride, padding="same", bias=True, activation="relu"):
    return _layer_case(rng, conv("c", 4, k, stride, padding, activation, bias), kernel_weights(rng, "c", (k, k, 3, 4), bias))


def _depthwise_case(rng, stride):
    layer = L("DepthwiseConv2D", "dw", kernel_size=[3, 3], strides=[stride, stride], padding="same", depth_multiplier=2,
              activation="linear", use_bias=True)
    return _layer_case(rng, layer, [("dw/depthwise_kernel:0", _arr(rng, 3, 3, 3, 2)), ("dw/bias:0", _arr(rng, 6))])


def _separable_case(rng, stride):
    layer = L("SeparableConv2D", "sep", filters=5, kernel_size=[3, 3], strides=[stride, stride], padding="same",
              depth_multiplier=2, activation="relu", use_bias=True)
    ws = [("sep/depthwise_kernel:0", _arr(rng, 3, 3, 3, 2)), ("sep/pointwise_kernel:0", _arr(rng, 1, 1, 6, 5)), ("sep/bias:0", _arr(rng, 5))]
    return _layer_case(rng, layer, ws)


def _deconv_case(rng, k, stride):
    layer = L("Conv2DTranspose", "up", filters=4, kernel_size=[k, k], strides=[stride, stride], padding="same",
              activation="relu", use_bias=True)
    # Keras stores a transpose conv's kernel as (H, W, out, in)
    return _layer_case(rng, layer, [("up/kernel:0", _arr(rng, k, k, 4, 3)), ("up/bias:0", _arr(rng, 4))])


def _pool_case(rng, cls, size, stride, padding):
    return _layer_case(rng, L(cls, "pool", pool_size=[size, size], strides=[stride, stride], padding=padding))


def _flatten_dense(rng):
    """Conv -> Flatten -> Dense -> softmax: Flatten must read NHWC order."""
    cfg = sequential(conv("c", 4, 3, 2), L("Flatten", "flat"), L("Dense", "d", units=3, activation="softmax", use_bias=True))
    ws = {"c": kernel_weights(rng, "c", (3, 3, 3, 4)), "d": [("d/kernel:0", _arr(rng, 5 * 6 * 4, 3)), ("d/bias:0", _arr(rng, 3))]}
    return cfg, ws, _arr(rng, *X_SHAPE, scale=1.0)


def _reshape_permute(rng):
    cfg = sequential(L("Reshape", "r", target_shape=[11, 9, 3]), L("Permute", "p", dims=[3, 1, 2]), L("Flatten", "f"))
    return cfg, {}, _arr(rng, *X_SHAPE, scale=1.0)


def _gap_dense(rng):
    cfg = sequential(conv("c", 4, 3), L("GlobalAveragePooling2D", "gap"), L("Dense", "d", units=2, activation="sigmoid"))
    return cfg, {"c": kernel_weights(rng, "c", (3, 3, 3, 4)), "d": [("d/kernel:0", _arr(rng, 4, 2)), ("d/bias:0", _arr(rng, 2))]}, _arr(rng, *X_SHAPE)


def _concat_add(rng):
    """Functional: two convs, Concatenate on the channel axis and on W, Add."""
    layers = [
        conv("a", 4, 3, inbound=[[ref("inp")]]),
        conv("b", 4, 1, activation="relu", inbound=[[ref("inp")]]),
        L("Concatenate", "cat", [[ref("a"), ref("b")]], axis=-1),
        L("Concatenate", "catw", [[ref("a"), ref("b")]], axis=2),
        L("Add", "add", [[ref("a"), ref("b")]]),
        conv("head", 2, 1, activation="softmax", inbound=[[ref("cat")]]),
    ]
    ws = {"a": kernel_weights(rng, "a", (3, 3, 3, 4)), "b": kernel_weights(rng, "b", (1, 1, 3, 4)), "head": kernel_weights(rng, "head", (1, 1, 8, 2))}
    return functional(layers, [["head", 0, 0], ["catw", 0, 0], ["add", 0, 0]]), ws, _arr(rng, *X_SHAPE)


def _nested_multi_output(rng):
    """A nested Functional with two outputs, the outer graph reading output
    1 (legacy format: the nested model's first call is node 1)."""
    sub = functional(
        [conv("s1", 4, 3, inbound=[[ref("sub_in")]]), conv("s2", 2, 3, 2, activation="relu", inbound=[[ref("s1")]])],
        [["s1", 0, 0], ["s2", 0, 0]], inputs=("sub_in",), name="sub",
    )
    sub_layer = {"class_name": "Functional", "config": sub["config"], "inbound_nodes": [[ref("c0")]]}
    sub_layer["config"]["name"] = "sub"
    layers = [conv("c0", 3, 1, inbound=[[ref("inp")]]), sub_layer, conv("c1", 3, 3, inbound=[[ref("sub", 1, 1)]])]
    ws = {
        "c0": kernel_weights(rng, "c0", (1, 1, 3, 3)),
        "sub": kernel_weights(rng, "s1", (3, 3, 3, 4)) + kernel_weights(rng, "s2", (3, 3, 4, 2)),
        "c1": kernel_weights(rng, "c1", (3, 3, 2, 3)),
    }
    return functional(layers, [["c1", 0, 0]]), ws, _arr(rng, *X_SHAPE)


def _nested_sequential(rng):
    """A nested Sequential inside a Functional, called twice (a shared
    sub-model: nodes 1 and 2)."""
    sub = sequential(conv("sc", 3, 3, activation="relu"), L("MaxPooling2D", "sp", pool_size=[2, 2], strides=[2, 2], padding="same"), name="tower")
    tower = {"class_name": "Sequential", "config": sub["config"], "inbound_nodes": [[ref("inp")], [ref("pre")]]}
    layers = [conv("pre", 3, 1, inbound=[[ref("inp")]]), tower, L("Add", "add", [[ref("tower", 1), ref("tower", 2)]])]
    ws = {"pre": kernel_weights(rng, "pre", (1, 1, 3, 3)), "tower": kernel_weights(rng, "sc", (3, 3, 3, 3))}
    return functional(layers, [["add", 0, 0]]), ws, _arr(rng, *X_SHAPE)


def _ecseg_like_sequential(rng):
    """A small classifier as a Sequential: conv/pool blocks, GAP, softmax."""
    cfg = sequential(
        L("Rescaling", "scale", scale=1 / 255.0, offset=0.0),
        conv("c1", 4, 3, activation="relu"), L("MaxPooling2D", "p1", pool_size=[2, 2], strides=[2, 2], padding="same"),
        conv("c2", 6, 3, activation="relu"), L("MaxPooling2D", "p2", pool_size=[2, 2], strides=[2, 2], padding="same"),
        L("Dropout", "drop", rate=0.5), L("GlobalAveragePooling2D", "gap"), L("Dense", "head", units=3, activation="softmax"),
    )
    ws = {"c1": kernel_weights(rng, "c1", (3, 3, 3, 4)), "c2": kernel_weights(rng, "c2", (3, 3, 4, 6)),
          "head": [("head/kernel:0", _arr(rng, 6, 3)), ("head/bias:0", _arr(rng, 3))]}
    return cfg, ws, (rng.random(X_SHAPE) * 255).astype(np.uint8)


CASES = {
    "conv_k3_s1": lambda r: _conv_case(r, 3, 1),
    "conv_k3_s2": lambda r: _conv_case(r, 3, 2),
    "conv_k2_s2_no_bias": lambda r: _conv_case(r, 2, 2, bias=False),
    "conv_k3_s1_valid": lambda r: _conv_case(r, 3, 1, "valid", activation="sigmoid"),
    "conv_k3_s2_valid": lambda r: _conv_case(r, 3, 2, "valid", activation="softmax"),
    "depthwise_s1": lambda r: _depthwise_case(r, 1),
    "depthwise_s2": lambda r: _depthwise_case(r, 2),
    "separable_s1": lambda r: _separable_case(r, 1),
    "separable_s2": lambda r: _separable_case(r, 2),
    "deconv_k3_s2": lambda r: _deconv_case(r, 3, 2),
    "deconv_k2_s2": lambda r: _deconv_case(r, 2, 2),
    "deconv_k4_s2": lambda r: _deconv_case(r, 4, 2),
    "deconv_k3_s1": lambda r: _deconv_case(r, 3, 1),
    "maxpool_2_s2_same": lambda r: _pool_case(r, "MaxPooling2D", 2, 2, "same"),
    "maxpool_3_s1_same": lambda r: _pool_case(r, "MaxPooling2D", 3, 1, "same"),
    "maxpool_3_s2_valid": lambda r: _pool_case(r, "MaxPooling2D", 3, 2, "valid"),
    "avgpool_2_s2_same": lambda r: _pool_case(r, "AveragePooling2D", 2, 2, "same"),
    "avgpool_3_s1_same": lambda r: _pool_case(r, "AveragePooling2D", 3, 1, "same"),
    "avgpool_3_s2_valid": lambda r: _pool_case(r, "AveragePooling2D", 3, 2, "valid"),
    "upsample_nearest_2": lambda r: _layer_case(r, L("UpSampling2D", "u", size=[2, 3], interpolation="nearest")),
    "upsample_bilinear_2": lambda r: _layer_case(r, L("UpSampling2D", "u", size=[2, 2], interpolation="bilinear")),
    "upsample_bilinear_3": lambda r: _layer_case(r, L("UpSampling2D", "u", size=[3, 3], interpolation="bilinear")),
    "activation_relu": lambda r: _layer_case(r, L("Activation", "a", activation="relu")),
    "activation_sigmoid": lambda r: _layer_case(r, L("Activation", "a", activation="sigmoid")),
    "activation_softmax": lambda r: _layer_case(r, L("Activation", "a", activation="softmax")),
    "activation_tanh": lambda r: _layer_case(r, L("Activation", "a", activation="tanh")),
    "activation_elu": lambda r: _layer_case(r, L("Activation", "a", activation="elu")),
    "activation_gelu": lambda r: _layer_case(r, L("Activation", "a", activation="gelu")),
    "activation_swish": lambda r: _layer_case(r, L("Activation", "a", activation="swish")),
    "activation_linear": lambda r: _layer_case(r, L("Activation", "a", activation="linear")),
    "relu": lambda r: _layer_case(r, L("ReLU", "a")),
    "leaky_relu": lambda r: _layer_case(r, L("LeakyReLU", "a", alpha=0.2)),
    "batchnorm": lambda r: _bn(r, True, True),
    "batchnorm_no_scale": lambda r: _bn(r, False, True),
    "batchnorm_no_center": lambda r: _bn(r, True, False),
    "dropout": lambda r: _layer_case(r, L("Dropout", "d", rate=0.5)),
    "zero_padding_int": lambda r: _layer_case(r, L("ZeroPadding2D", "z", padding=2)),
    "zero_padding_pairs": lambda r: _layer_case(r, L("ZeroPadding2D", "z", padding=[[1, 2], [0, 3]])),
    "cropping": lambda r: _layer_case(r, L("Cropping2D", "cr", cropping=[[1, 2], [3, 0]])),
    "rescaling": lambda r: _layer_case(r, L("Rescaling", "s", scale=0.25, offset=-1.5)),
    "flatten_dense": _flatten_dense,
    "reshape_permute": _reshape_permute,
    "gap_dense": _gap_dense,
    "sequential_classifier": _ecseg_like_sequential,
    "functional_concat_add": _concat_add,
    "nested_multi_output": _nested_multi_output,
    "nested_sequential_shared": _nested_sequential,
}


def _assert_close(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _port_run(model, x):
    with torch.no_grad():
        out = model(x)
    return [o.numpy() for o in out] if isinstance(out, list) else out.numpy()


def _jax_run(model, x):
    """The JAX executor's forward, to numpy (its ``predict_on_batch`` takes
    one output only)."""
    import jax.numpy as jnp

    out = model(jnp.asarray(x))
    return [np.asarray(o) for o in out] if isinstance(out, list) else np.asarray(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_and_graph_cases_match_jax(tmp_path, case):
    cfg, ws, x = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
    path = str(tmp_path / "m.h5")
    write_legacy_h5(path, cfg, ws)
    want = _jax_run(jk.import_keras_h5(path), x)
    got = _port_run(tk.import_keras_h5(path, device="cpu"), x)
    _assert_close(got, want)


def test_dense_on_4d_contracts_the_channel_axis(tmp_path, rng):
    """Keras applies Dense to the last axis of a 4-D tensor.  The JAX
    executor's ``lax.dot`` raises on rank > 2 under this JAX (a documented
    deviation, ROADMAP §C); the port computes Keras's result, held against
    numpy."""
    k, b = _arr(rng, 3, 5), _arr(rng, 5)
    cfg, ws, x = _layer_case(rng, L("Dense", "d", units=5, activation="tanh", use_bias=True), [("d/kernel:0", k), ("d/bias:0", b)])
    path = str(tmp_path / "m.h5")
    write_legacy_h5(path, cfg, ws)
    with pytest.raises(ValueError, match="dimension_numbers"):
        jk.import_keras_h5(path).predict_on_batch(x)
    got = _port_run(tk.import_keras_h5(path, device="cpu"), x)
    np.testing.assert_allclose(got, np.tanh(x @ k + b), rtol=RTOL, atol=ATOL)


def test_keras3_archive_matches_jax(tmp_path, rng):
    """A ``.keras`` zip: Keras 3's dict-format inbound nodes, snake-cased
    deduplicated weight groups, a nested model with its own ``layers``
    level."""

    def k3(name, node=0, tensor=0):
        return {"args": [{"class_name": "__keras_tensor__", "config": {"keras_history": [name, node, tensor]}}], "kwargs": {}}

    def layer(cls, name, node=None, **cfg):
        return {"class_name": cls, "config": {"name": name, **cfg}, "inbound_nodes": [node] if node else []}

    conv_cfg = dict(kernel_size=[3, 3], strides=[1, 1], padding="same", use_bias=True)
    sub = {
        "class_name": "Functional",
        "config": {
            "name": "subnet",
            "layers": [layer("InputLayer", "sin"), layer("Conv2D", "sc", k3("sin"), filters=4, activation="relu", **conv_cfg)],
            "input_layers": [["sin", 0, 0]],
            "output_layers": [["sc", 0, 0]],
        },
        "inbound_nodes": [k3("conv2d")],
    }
    cat = {"class_name": "Concatenate", "config": {"name": "cat", "axis": -1},
           "inbound_nodes": [{"args": [[k3("conv2d")["args"][0], k3("subnet")["args"][0]]], "kwargs": {}}]}
    cfg = {
        "class_name": "Functional",
        "config": {
            "name": "outer",
            "layers": [
                layer("InputLayer", "inp"),
                layer("Conv2D", "conv2d", k3("inp"), filters=3, activation="linear", **conv_cfg),
                sub,
                cat,
                layer("Conv2D", "conv2d_1", k3("cat"), filters=2, activation="softmax", **conv_cfg),
            ],
            "input_layers": [["inp", 0, 0]],
            "output_layers": ["conv2d_1", 0, 0],
        },
    }
    buf = io.BytesIO()
    with h5py.File(buf, "w") as f:
        lg = f.create_group("layers")
        for group, shapes in (("conv2d", [(3, 3, 3, 3), (3,)]), ("conv2d_1", [(3, 3, 7, 2), (2,)])):
            v = lg.create_group(group).create_group("vars")
            for i, shape in enumerate(shapes):
                v.create_dataset(str(i), data=_arr(rng, *shape))
        v = lg.create_group("functional").create_group("layers").create_group("conv2d").create_group("vars")
        v.create_dataset("0", data=_arr(rng, 3, 3, 3, 4))
        v.create_dataset("1", data=_arr(rng, 4))
    path = str(tmp_path / "m.keras")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("config.json", json.dumps(cfg))
        z.writestr("model.weights.h5", buf.getvalue())
    x = _arr(rng, *X_SHAPE)
    want = _jax_run(jk.import_keras_file(path), x)
    model = tk.import_keras_file(path, device="cpu")
    _assert_close(_port_run(model, x), want)
    assert len([n for n, _ in model.named_buffers() if n != "anchor"]) == 6  # both convs' and the nested conv's weights


def test_unsupported_layer_raises_the_same_message(tmp_path):
    path = str(tmp_path / "m.h5")
    write_legacy_h5(path, sequential(L("LSTM", "rnn", units=4)), {})
    with pytest.raises(NotImplementedError) as want:
        jk.import_keras_h5(path)
    with pytest.raises(NotImplementedError) as got:
        tk.import_keras_h5(path, device="cpu")
    assert str(got.value) == str(want.value) == "Keras layer type not supported: LSTM (rnn)"


def test_metaseg_load_model_prefers_h5_as_the_jax_loader_does(tmp_path, rng):
    """A folder with both ``metaseg.h5`` and ``metaseg.npz``: both loaders
    run the ``.h5``, on the patches cast to float32, and the port's module
    returns what ``segment_raw`` reads."""
    from ecseg_tpu.models.keras_import import save_npz_pytree
    from ecseg_tpu.pipelines import metaseg as jmeta
    from ecseg_torch.pipelines import metaseg as tmeta

    from _torchutil import numpy_metaseg_tree

    cfg = sequential(L("Rescaling", "scale", scale=1 / 255.0), conv("c", 8, 3, activation="relu"), conv("head", 4, 1, activation="softmax"))
    write_legacy_h5(str(tmp_path / "metaseg.h5"), cfg, {"c": kernel_weights(rng, "c", (3, 3, 1, 8)), "head": kernel_weights(rng, "head", (1, 1, 8, 4))})
    save_npz_pytree(str(tmp_path / "metaseg.npz"), numpy_metaseg_tree((4, 8), 16))
    x = (rng.random((3, 256, 256, 1)) * 255).astype(np.uint8)
    params, fwd = jmeta.load_model(str(tmp_path))
    want = np.asarray(fwd(params, x, np.float32))
    model = tmeta.load_model(str(tmp_path), device="cpu")
    assert isinstance(model, tk.KerasModel)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 256, 256, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# --- chip_smoke's configs, rehearsed on the CPU at small widths ---------


def test_chip_smoke_unet_config_matches_metaseg_unet():
    """``chip_smoke.unet_keras_config`` + ``DictFetcher`` (the metaseg U-Net
    as a Keras Functional graph) against ``MetasegUNet`` on the same
    weights: the stitched labels' inputs, argmax of the quantized
    probabilities, equal; probabilities within the tolerance."""
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.models.weights import params_to_numpy
    from ecseg_torch.ops import tiling

    unet = demo_metaseg_params(torch.Generator().manual_seed(0), widths=(4, 8), bottleneck=16)
    tree = params_to_numpy(unet)
    model = tk.import_from_config(chip_smoke.unet_keras_config((4, 8), 16, 4), chip_smoke.DictFetcher(chip_smoke.unet_keras_weights(tree)), "cpu")
    x = (np.random.default_rng(5).random((3, 64, 64, 1)) * 255).astype(np.uint8)
    with torch.no_grad():
        got, want = model(torch.from_numpy(x)), unet(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(tiling.patch_labels(got), tiling.patch_labels(want))


def test_chip_smoke_ecseg_i_config_matches_ecseg_i():
    from ecseg_torch.models.demo import demo_ecseg_i_tree
    from ecseg_torch.models.weights import classifier_from_numpy

    tree = demo_ecseg_i_tree()
    tree["conv2"]["kernel"] = np.random.default_rng(1).standard_normal(tree["conv2"]["kernel"].shape).astype(np.float32) * 0.05
    model = tk.import_from_config(chip_smoke.ecseg_i_keras_config(), chip_smoke.DictFetcher(chip_smoke.classifier_keras_weights(tree)), "cpu")
    x = (np.random.default_rng(2).random((2, 256, 256)) * 255).astype(np.uint8)
    with torch.no_grad():
        got, want = model(torch.from_numpy(x)), classifier_from_numpy(tree)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_chip_smoke_ecseg_c_config_matches_ecseg_c():
    """``chip_smoke.ecseg_c_keras_config`` (ecSeg-c as a Keras Sequential
    on ``preprocess_ecseg_c``'s floats) against ``EcsegC`` on the same
    weights: probabilities within the tolerance, the same side of 0.5."""
    from ecseg_torch.models.classifiers import EcsegC
    from ecseg_torch.models.demo import demo_ecseg_c_tree
    from ecseg_torch.models.weights import classifier_from_numpy
    from ecseg_torch.pipelines.interseg import preprocess_ecseg_c

    tree = demo_ecseg_c_tree()
    tree["conv2"]["kernel"] = np.random.default_rng(3).standard_normal(tree["conv2"]["kernel"].shape).astype(np.float32) * 0.05
    model = tk.import_from_config(chip_smoke.ecseg_c_keras_config(), chip_smoke.DictFetcher(chip_smoke.classifier_keras_weights(tree)), "cpu")
    rng = np.random.default_rng(4)
    x = np.stack([preprocess_ecseg_c((rng.random((256, 256, 3)) * 255 * s).astype(np.uint8)) for s in (0.2, 1.0)])
    ecseg_c = classifier_from_numpy(tree)
    assert isinstance(ecseg_c, EcsegC)
    with torch.no_grad():
        got, want = model(torch.from_numpy(x)), ecseg_c(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got > 0.5, want > 0.5)


# --- files: Keras 3's own saves and core/hdf5.py's writer ----------------

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.mark.parametrize("name", ["keras3_small.h5", "keras3_small.keras"])
def test_keras3_fixture_matches_jax(name):
    """A file Keras 3.13's ``model.save`` wrote (Conv2D, BatchNormalization,
    Conv2DTranspose, softmax head): the JAX executor reading it with h5py
    against the port's reading it with ``core.hdf5``."""
    path = os.path.join(FIXTURES, name)
    x = np.load(os.path.join(FIXTURES, "keras3_small.npz"))["x"]
    want = _jax_run(jk.import_keras_file(path), x)
    _assert_close(_port_run(tk.import_keras_file(path, device="cpu"), x), want)


def _writer_cases():
    from ecseg_torch.models.demo import demo_ecseg_i_tree

    from test_torch_metaseg_pipeline import _crafted_tiny_params

    itree = demo_ecseg_i_tree()
    itree["conv2"]["kernel"] = np.random.default_rng(1).standard_normal(itree["conv2"]["kernel"].shape).astype(np.float32) * 0.05
    rng = np.random.default_rng(6)
    return {
        "unet": (chip_smoke.unet_keras_config((8, 16), 32, 4), chip_smoke.unet_keras_weights(_crafted_tiny_params()),
                 (rng.random((2, 64, 64, 1)) * 255).astype(np.uint8)),
        "ecseg_i": (chip_smoke.ecseg_i_keras_config(), chip_smoke.classifier_keras_weights(itree), (rng.random((2, 256, 256)) * 255).astype(np.uint8)),
    }


@pytest.mark.parametrize("case", ["unet", "ecseg_i"])
def test_chip_smoke_h5_writer_files_read_alike(tmp_path, case):
    """``hdf5.write_keras_h5`` (the legacy layout TF-Keras 2 writes):
    h5py and the port's reader give the same attributes and arrays, the
    arrays those written; the JAX executor on the file matches the
    port's."""
    from ecseg_torch.core import hdf5

    cfg, weights, x = _writer_cases()[case]
    path = str(tmp_path / "m.h5")
    size = write_keras_h5(path, cfg, weights)
    assert size == os.path.getsize(path)
    with h5py.File(path, "r") as f, hdf5.File(path) as r:
        assert json.loads(f.attrs["model_config"]) == json.loads(r.attrs["model_config"]) == cfg
        assert type(r.attrs["model_config"]) is type(f.attrs["model_config"]) is np.bytes_
        layers = [lc["config"]["name"] for lc in cfg["config"]["layers"]]
        assert [n.decode() for n in f["model_weights"].attrs["layer_names"]] == layers
        np.testing.assert_array_equal(r["model_weights"].attrs["layer_names"], f["model_weights"].attrs["layer_names"])
        for layer in layers:
            names_f, names_r = f["model_weights"][layer].attrs["weight_names"], r["model_weights"][layer].attrs["weight_names"]
            assert names_f.dtype == names_r.dtype and list(names_f) == list(names_r)
            for k, wname in enumerate(names_f):
                got, want = r["model_weights"][layer][wname.decode()][()], f["model_weights"][layer][wname.decode()][()]
                assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
                np.testing.assert_array_equal(got, weights[layer][k])
            assert len(names_f) == len(weights.get(layer, []))
    want = _jax_run(jk.import_keras_h5(path), x)
    _assert_close(_port_run(tk.import_keras_h5(path, device="cpu"), x), want)


def test_metaseg_main_from_h5_writes_the_npz_runs_bytes(tmp_path, monkeypatch):
    """``metaseg.main(device="cpu")`` on a folder, once with
    ``models/metaseg.h5`` (core/hdf5.py's writer, the crafted (8, 16) U-Net)
    and once with ``models/metaseg.npz`` of the same weights: the same
    ``labels/*.npy``, ``labels/*.png`` and CSV bytes."""
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.weights import save_npz
    from ecseg_torch.pipelines import metaseg

    from test_torch_metaseg_pipeline import _crafted_tiny_params, _make_folder

    tree = _crafted_tiny_params()
    outputs = {}
    for kind in ("h5", "npz"):
        work = tmp_path / kind
        os.makedirs(work / "models")
        if kind == "h5":
            write_keras_h5(str(work / "models" / "metaseg.h5"), chip_smoke.unet_keras_config((8, 16), 32, 4), chip_smoke.unet_keras_weights(tree))
        else:
            save_npz(str(work / "models" / "metaseg.npz"), tree)
        _make_folder(str(work / "imgs"))
        monkeypatch.chdir(work)
        for var in ("ECSEG_DEVICE_PIPELINE", "ECSEG_MC_LABEL", "ECSEG_MC_MERGE"):
            monkeypatch.delenv(var, raising=False)
        model = metaseg.load_model(device="cpu")
        assert isinstance(model, tk.KerasModel) == (kind == "h5")
        assert metaseg.main(config=Config(raw={"metaseg": {"inpath": str(work / "imgs")}}), device="cpu") == 0
        files = sorted(os.listdir(work / "imgs" / "labels"))
        outputs[kind] = {f: open(work / "imgs" / "labels" / f, "rb").read() for f in files}
        outputs[kind]["csv"] = open(work / "imgs" / "ec_quantification.csv", "rb").read()
    assert len(outputs["h5"]) > 2 and outputs["h5"] == outputs["npz"]
