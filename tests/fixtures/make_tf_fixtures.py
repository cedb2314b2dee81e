"""Writes the TensorFlow fixtures that ``tests/test_torch_tfbundle.py`` and
``tests/test_torch_convert.py`` read, into ``tests/fixtures/tf/``, with
TensorFlow's and TF-Keras's own writers:

- ``nuset/whole_norm.ckpt.*`` and ``nuset/foreground.ckpt.*``: a TF1 V2
  checkpoint pair under the reference NuSeT graph's variable names
  (``model_U-Net/conv1-1/kernel``, ``model_U-Net/conv2d_transpose_3/kernel``
  in (H, W, out, in), ``model_RPN/rpn_conv/3x3/kernel``, the bias-free
  ``final``), made with ``tf.compat.v1.get_variable`` under variable scopes
  at narrow widths, with Adam's slots, ``beta1_power``, ``beta2_power`` and
  ``global_step`` (each graph's ``.meta`` is removed: no reader needs it);
- ``dtypes.ckpt.*``: one variable of each dtype the port's reader reads
  (and a string tensor); ``partitioned.ckpt.*``: a variable saved in two
  slices;
- ``seq/`` and ``func/``: TF-Keras SavedModels, an ecSeg-i-shaped
  Sequential (Reshape, Rescaling, Conv2D, MaxPooling2D,
  GlobalAveragePooling2D, Dense) and a compiled, once-fitted Functional
  model (BatchNormalization, Conv2DTranspose, SeparableConv2D,
  DepthwiseConv2D, Concatenate, a ``use_bias=False`` conv and a nested
  Sequential with a ``scale=False`` BatchNormalization);
- the outputs of the JAX package's converters on them:
  ``nuset.npz`` (``scripts/convert_tf1_ckpt.py``), ``seq.h5`` and
  ``func.h5`` (``scripts/convert_savedmodel.py``);
- ``reader.json``: what TensorFlow's ``NewCheckpointReader`` reads from
  every bundle above: each entry's shape, dtype name and value, the value
  as its numpy dtype, shape and the sha256 of its bytes (bfloat16 as
  float32; a string tensor's elements each with its length);
  ``keras.npz``: a seeded input to each model and Keras's output on it.

Not run by the tests (they need no TensorFlow to read the files):

    python tests/fixtures/make_tf_fixtures.py [OUT_DIR]
"""

import json
import os
import shutil
import subprocess
import sys

os.environ.setdefault("TF_USE_LEGACY_KERAS", "1")

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WIDTHS, BOTTLENECK, RPN_ANCHORS = (2, 2, 4, 4), 4, 21


def nuset_unet_variables(widths=WIDTHS, bottleneck=BOTTLENECK):
    """[(scope, kernel shape, has bias)] of the reference U-Net, in graph
    order; transpose convs hold (H, W, out, in) kernels."""
    out, c = [], 1
    for i, w in enumerate(widths, start=1):
        out += [(f"conv{i}-1", (3, 3, c, w), True), (f"conv{i}-2", (3, 3, w, w), True)]
        c = w
    out += [("conv5-1", (3, 3, c, bottleneck), True), ("conv5-2", (3, 3, bottleneck, bottleneck), True)]
    up_in = bottleneck
    for k, (i, w) in enumerate(zip((4, 3, 2, 1), widths[::-1])):
        out.append(("conv2d_transpose" + (f"_{k}" if k else ""), (3, 3, w, up_in), True))
        out += [(f"conv{i}-3", (3, 3, 2 * w, w), True), (f"conv{i}-4", (3, 3, w, w), True)]
        up_in = w
    return out + [("final", (3, 3, widths[0], 2), False)]


def write_nuset_checkpoint(tf, prefix, with_rpn, seed):
    tf1 = tf.compat.v1
    rng = np.random.default_rng(seed)
    graph = tf.Graph()
    with graph.as_default():
        def var(name, shape):
            return tf1.get_variable(name, initializer=tf.constant(rng.standard_normal(shape).astype(np.float32)))

        with tf1.variable_scope("model_U-Net"):
            for scope, shape, bias in nuset_unet_variables():
                with tf1.variable_scope(scope):
                    var("kernel", shape)
                    if bias:
                        var("bias", shape[2] if scope.startswith("conv2d_transpose") else shape[3])
        if with_rpn:
            w = WIDTHS[-1]
            with tf1.variable_scope("model_RPN"):
                for scope, shape in (("rpn_conv/3x3", (3, 3, w, w)), ("rpn_cls_score", (1, 1, w, 2 * RPN_ANCHORS)),
                                     ("rpn_bbox_pred", (1, 1, w, 4 * RPN_ANCHORS))):
                    with tf1.variable_scope(scope):
                        var("kernel", shape)
                        var("bias", shape[3])
        step = tf1.train.get_or_create_global_step()
        loss = tf.add_n([tf.reduce_sum(v) for v in tf1.trainable_variables()])
        train = tf1.train.AdamOptimizer(1e-3).minimize(loss, global_step=step)
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            sess.run(train)
            tf1.train.Saver().save(sess, prefix)
    os.remove(prefix + ".meta")


def write_dtype_checkpoints(tf, out):
    tf1 = tf.compat.v1
    rng = np.random.default_rng(3)
    graph = tf.Graph()
    with graph.as_default():
        for name, dtype in (("f16", np.float16), ("f32", np.float32), ("f64", np.float64), ("i8", np.int8), ("i16", np.int16),
                            ("i32", np.int32), ("i64", np.int64), ("u8", np.uint8), ("u16", np.uint16)):
            vals = rng.standard_normal((3, 5)) * 100
            tf1.get_variable(f"dtypes/{name}", initializer=tf.constant(vals.astype(dtype)))
        tf1.get_variable("dtypes/bf16", initializer=tf.cast(tf.constant(rng.standard_normal(7).astype(np.float32)), tf.bfloat16))
        tf1.get_variable("dtypes/bool", initializer=tf.constant(rng.random((2, 3)) > 0.5))
        tf1.get_variable("dtypes/scalar", initializer=tf.constant(2.5, tf.float32))
        tf1.get_variable("dtypes/empty", initializer=tf.zeros((0, 4), tf.float32))
        tf1.get_variable("dtypes/string", initializer=tf.constant([[b"", b"ab"], [b"\x00\xff", b"x" * 300]]))
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            tf1.train.Saver().save(sess, os.path.join(out, "dtypes.ckpt"))
    graph = tf.Graph()
    with graph.as_default():
        tf1.get_variable("sharded/w", initializer=tf.constant(rng.standard_normal((6, 3)).astype(np.float32)),
                         partitioner=tf1.fixed_size_partitioner(2))
        tf1.get_variable("sharded/plain", initializer=tf.constant(rng.standard_normal(4).astype(np.float32)))
        with tf1.Session() as sess:
            sess.run(tf1.global_variables_initializer())
            tf1.train.Saver().save(sess, os.path.join(out, "partitioned.ckpt"))
    for p in ("dtypes", "partitioned"):
        os.remove(os.path.join(out, p + ".ckpt.meta"))


def build_seq(keras):
    L = keras.layers
    return keras.Sequential([
        keras.Input((16, 16)),
        L.Reshape((16, 16, 1), name="chan"),
        L.Rescaling(1 / 255.0, name="scale"),
        L.Conv2D(4, 3, padding="same", activation="relu", name="conv1"),
        L.MaxPooling2D(2, name="pool1"),
        L.Conv2D(8, 3, padding="same", activation="relu", name="conv2"),
        L.MaxPooling2D(2, name="pool2"),
        L.GlobalAveragePooling2D(name="gap"),
        L.Dense(3, activation="softmax", name="head"),
    ], name="ecseg_i_small")


def build_func(keras):
    L = keras.layers
    inp = keras.Input((8, 8, 2), name="inp")
    x = L.Conv2D(4, 3, padding="same", activation="relu", name="conv")(inp)
    x = L.BatchNormalization(name="bn")(x)
    y = L.Conv2D(4, 3, padding="same", use_bias=False, name="nobias")(x)
    sub = keras.Sequential([keras.Input((8, 8, 4)), L.Conv2D(3, 1, name="subconv"),
                            L.BatchNormalization(scale=False, name="subbn")], name="sub")
    z = sub(y)
    u = L.Conv2DTranspose(3, 3, strides=2, padding="same", activation="relu", name="up")(z)
    s = L.SeparableConv2D(2, 3, padding="same", name="sep")(u)
    d = L.DepthwiseConv2D(3, padding="same", name="dw")(u)
    out = L.Concatenate(name="cat")([s, d])
    return keras.Model(inp, out, name="func_small")


def seeded_weights(model, seed):
    """Non-trivial weights and batch statistics, so every array is read."""
    rng = np.random.default_rng(seed)
    model.set_weights([(np.abs(rng.standard_normal(w.shape)) + 0.5 if "variance" in w.name else rng.standard_normal(w.shape) * 0.5).astype(np.float32)
                       for w in model.weights])


def value_digest(value) -> dict:
    """A tensor's value as the tests compare it: numpy dtype, shape and the
    sha256 of its bytes (a string tensor's: each element's length, then
    its bytes)."""
    import hashlib

    value = np.asarray(value)
    if value.dtype == object:
        data = b"".join(len(b).to_bytes(8, "little") + b for b in value.reshape(-1))
    else:
        data = np.ascontiguousarray(value).tobytes()
    return {"dtype": value.dtype.str, "shape": list(value.shape), "sha256": hashlib.sha256(data).hexdigest()}


def record_reader(tf, prefixes, out):
    from tensorflow.python.training import py_checkpoint_reader

    meta = {}
    for rel in prefixes:
        reader = py_checkpoint_reader.NewCheckpointReader(os.path.join(out, rel))
        shapes = reader.get_variable_to_shape_map()
        dtypes = {k: v.name for k, v in reader.get_variable_to_dtype_map().items()}
        values = {}
        for name in shapes:
            value = reader.get_tensor(name)  # a partitioned variable's slices joined
            if dtypes[name] == "string":
                value = np.array(value, dtype=object)
            values[name] = value_digest(np.asarray(value, np.float32) if dtypes[name] == "bfloat16" else value)
        meta[rel] = {"shapes": {k: list(v) for k, v in shapes.items()}, "dtypes": dtypes, "values": values}
    with open(os.path.join(out, "reader.json"), "w") as f:
        json.dump(meta, f, sort_keys=True)


def main(out):
    import tensorflow as tf
    import tf_keras as keras

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "nuset"))
    write_nuset_checkpoint(tf, os.path.join(out, "nuset", "whole_norm.ckpt"), False, 1)
    write_nuset_checkpoint(tf, os.path.join(out, "nuset", "foreground.ckpt"), True, 2)
    os.remove(os.path.join(out, "nuset", "checkpoint"))
    write_dtype_checkpoints(tf, out)
    os.remove(os.path.join(out, "checkpoint"))

    arrays = {}
    for name, build, shape, seed in (("seq", build_seq, (2, 16, 16), 4), ("func", build_func, (2, 8, 8, 2), 5)):
        model = build(keras)
        if name == "func":  # optimizer slots and a metric in the bundle, a training_config in the metadata
            model.compile(optimizer="adam", loss="mse")
            model.fit(np.zeros((2, 8, 8, 2), np.float32), np.zeros((2, 16, 16, 5), np.float32), verbose=0)
        seeded_weights(model, seed)
        x = (np.random.default_rng(seed).random(shape) * (255 if name == "seq" else 2)).astype(np.float32)
        arrays[f"x_{name}"], arrays[f"y_{name}"] = x, np.asarray(model.predict(x, verbose=0))
        model.save(os.path.join(out, name))
        shutil.rmtree(os.path.join(out, name, "assets"), ignore_errors=True)  # empty
    arrays["tf_version"], arrays["keras_version"] = np.array(tf.__version__), np.array(keras.__version__)
    np.savez(os.path.join(out, "keras.npz"), **arrays)

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    run = lambda *a: subprocess.run([sys.executable, *a], cwd=REPO, env=env, check=True)
    run("scripts/convert_tf1_ckpt.py", os.path.join(out, "nuset"), os.path.join(out, "nuset.npz"))
    for name in ("seq", "func"):
        run("scripts/convert_savedmodel.py", os.path.join(out, name), os.path.join(out, f"{name}.h5"))
    record_reader(tf, ["nuset/whole_norm.ckpt", "nuset/foreground.ckpt", "dtypes.ckpt", "partitioned.ckpt",
                       "seq/variables/variables", "func/variables/variables"], out)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(os.path.abspath(__file__)), "tf"))
