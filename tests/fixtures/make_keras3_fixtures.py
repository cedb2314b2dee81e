"""Writes the Keras 3 fixtures that ``tests/test_torch_hdf5.py`` and
``tests/test_torch_keras_import.py`` read: a small Functional model (Conv2D,
BatchNormalization, Conv2DTranspose, a softmax head) saved by Keras 3's own
``model.save`` as a legacy ``.h5`` (``keras3_small.h5``) and as a ``.keras``
archive (``keras3_small.keras``), and ``keras3_small.npz``: every weight
under its ``.h5`` path, a seeded input ``x`` and Keras's output ``y`` on it.
Not run by the tests (they need neither Keras nor h5py to read the files).

    python tests/fixtures/make_keras3_fixtures.py [OUT_DIR]
"""

import os
import sys

import numpy as np


def build(keras):
    inp = keras.Input((8, 8, 2), name="inp")
    x = keras.layers.Conv2D(4, 3, padding="same", activation="relu", name="conv")(inp)
    x = keras.layers.BatchNormalization(name="bn")(x)
    x = keras.layers.Conv2DTranspose(3, 3, strides=2, padding="same", activation="relu", name="up")(x)
    out = keras.layers.Conv2D(3, 1, activation="softmax", name="head")(x)
    model = keras.Model(inp, out, name="small")
    rng = np.random.default_rng(0)
    # non-trivial batch statistics, so the BatchNormalization is read
    model.set_weights([(rng.standard_normal(w.shape) * 0.5 + (1.0 if "variance" in w.path else 0.0)).astype(np.float32) ** (2 if "variance" in w.path else 1)
                       for w in model.weights])
    return model


def main(out_dir: str) -> None:
    import h5py
    import keras

    model = build(keras)
    h5_path = os.path.join(out_dir, "keras3_small.h5")
    model.save(h5_path)
    model.save(os.path.join(out_dir, "keras3_small.keras"))
    arrays = {}
    with h5py.File(h5_path, "r") as f:
        f["model_weights"].visititems(lambda name, obj: arrays.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 2)).astype(np.float32)
    arrays.update(x=x, y=np.asarray(model.predict(x, verbose=0)), keras_version=np.array(keras.__version__))
    np.savez(os.path.join(out_dir, "keras3_small.npz"), **arrays)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.abspath(__file__)))
