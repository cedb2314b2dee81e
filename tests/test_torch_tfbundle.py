"""``ecseg_torch/core/tfbundle.py``, the port's TensorFlow checkpoint reader
(no TensorFlow), against TensorFlow's own ``NewCheckpointReader``: on the
files TensorFlow wrote in ``tests/fixtures/tf/`` (a NuSeT-named TF1
checkpoint pair with Adam's slots, every dtype the reader reads, a
partitioned variable, two TF-Keras SavedModels' variables), the shape,
dtype and value of every entry equal what ``make_tf_fixtures.py`` recorded
from TensorFlow.  Also crc32c, flipped bytes, the checkpoints it refuses
(written by ``chip_smoke.write_tf_bundle``, the card phase's writer), and
that writer's files read back by this reader and, in a subprocess, by
TensorFlow."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from ecseg_torch.core import tfbundle as tb

FIX = pathlib.Path(__file__).parent / "fixtures" / "tf"
RECORDED = json.loads((FIX / "reader.json").read_text())


def digest(value) -> dict:
    """``make_tf_fixtures.value_digest``: numpy dtype, shape, sha256."""
    value = np.asarray(value)
    if value.dtype == object:
        data = b"".join(len(b).to_bytes(8, "little") + b for b in value.reshape(-1))
    else:
        data = np.ascontiguousarray(value).tobytes()
    return {"dtype": value.dtype.str, "shape": list(value.shape), "sha256": hashlib.sha256(data).hexdigest()}


@pytest.mark.parametrize("bundle", sorted(RECORDED))
def test_every_entry_equals_tensorflows_reading(bundle):
    reader = tb.CheckpointReader(FIX / bundle)
    want = RECORDED[bundle]
    assert reader.get_variable_to_shape_map() == want["shapes"]
    assert reader.get_variable_to_dtype_map() == want["dtypes"]
    for name, value in want["values"].items():
        if bundle == "partitioned.ckpt" and name == "sharded/w":
            with pytest.raises(NotImplementedError, match="sharded/w is a partitioned variable"):
                reader.get_tensor(name)
            continue
        assert digest(reader.get_tensor(name)) == value, name


def _data_blocks(path):
    """The data blocks' contents of a table."""
    with open(path, "rb") as f:
        footer = f.read()[-tb.FOOTER_SIZE :]
        index, _ = tb._handle(footer, tb._handle(footer, 0)[1])
        return [tb._block(f, tb._handle(v, 0)[0], path) for _, v in tb._block_entries(tb._block(f, index, path), path)]


def test_the_fixtures_cover_the_formats_edges():
    """A block of several restart points (keys prefix-compressed across
    them); a string scalar (the object graph) and a string matrix; every
    dtype.  (TensorFlow writes a bundle's index in one data block; the
    writer's tests below cover several.)"""
    blocks = _data_blocks(str(FIX / "nuset" / "foreground.ckpt.index"))
    assert max(int.from_bytes(b[-4:], "little") for b in blocks) > 4
    assert set(RECORDED["dtypes.ckpt"]["dtypes"].values()) >= {
        "float16", "float32", "float64", "bfloat16", "int8", "int16", "int32", "int64", "uint8", "uint16", "bool", "string"}
    assert RECORDED["seq/variables/variables"]["dtypes"]["_CHECKPOINTABLE_OBJECT_GRAPH"] == "string"


def test_crc32c_and_its_mask():
    assert tb.crc32c(b"123456789") == 0xE3069283  # the standard check value
    assert tb.crc32c(b"") == 0 and tb.crc32c(bytes(32)) == 0x8A9136AA  # RFC 3720's test vector
    rng = np.random.default_rng(0)

    def bitwise(data):
        c = 0xFFFFFFFF
        for b in data:
            c ^= b
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        return c ^ 0xFFFFFFFF

    for n in (1, 4095, 4096, 9999, 65537):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert tb.crc32c(data) == tb.crc32c(data.tobytes()) == bitwise(data.tobytes()), n
        assert tb.crc32c(data[n // 3 :], tb.crc32c(data[: n // 3])) == tb.crc32c(data), n
    for crc in (0, 1, 0xE3069283, 0xFFFFFFFF):
        assert tb.unmask(tb.mask(crc)) == crc


def _copy(prefix: pathlib.Path, tmp_path) -> pathlib.Path:
    for f in prefix.parent.glob(prefix.name + ".*"):
        shutil.copy(f, tmp_path)
    return tmp_path / prefix.name


def _flip(path, pos):
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0x10]))


def test_every_flipped_data_byte_raises(tmp_path):
    """Each byte of the dtypes checkpoint's data, flipped: the tensor that
    holds it fails its checksum (a string tensor's lengths, their checksum
    or its bytes), and no other tensor does."""
    prefix = _copy(FIX / "dtypes.ckpt", tmp_path)
    reader = tb.CheckpointReader(prefix)
    data = pathlib.Path(f"{prefix}.data-00000-of-00001")
    spans = {name: (e.offset, e.offset + e.size) for name, e in reader._entries.items()}
    for pos in range(data.stat().st_size):
        _flip(data, pos)
        for name, (a, b) in spans.items():
            if a <= pos < b:
                with pytest.raises(OSError, match=name):
                    reader.get_tensor(name)
        _flip(data, pos)
    assert all(reader.get_tensor(name) is not None for name in spans)


def test_every_flipped_index_byte_raises(tmp_path):
    """Each byte of the index's blocks and trailers, and of the footer's
    magic, flipped: opening the checkpoint raises ``OSError``."""
    prefix = _copy(FIX / "dtypes.ckpt", tmp_path)
    index = pathlib.Path(f"{prefix}.index")
    size = index.stat().st_size
    for pos in list(range(size - tb.FOOTER_SIZE)) + list(range(size - 8, size)):
        _flip(index, pos)
        with pytest.raises(OSError):
            tb.CheckpointReader(prefix)
        _flip(index, pos)
    tb.CheckpointReader(prefix)


def _tensors(rng):
    out = {f"layer{i:03d}/kernel": rng.standard_normal((3, 3, 2, i % 5 + 1)).astype(np.float32) for i in range(300)}
    out.update({"f64": rng.standard_normal(7), "i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
                "u8": rng.integers(0, 255, 11).astype(np.uint8), "i64": np.array(7, np.int64), "bool": rng.random(5) > 0.5,
                "empty": np.zeros((0, 3), np.float32), "strings": [b"", b"abc", bytes(range(256))], "graph": b"\x0a\x00"})
    return out


@pytest.mark.parametrize("shards", [1, 3])
def test_chip_smoke_writer_round_trips(tmp_path, rng, shards):
    """``chip_smoke.write_tf_bundle`` (several blocks, 300 prefix-shared
    keys, shards) read back by the reader, value for value."""
    tensors = _tensors(rng)
    prefix = str(tmp_path / "m.ckpt")
    chip_smoke.write_tf_bundle(prefix, tensors, num_shards=shards)
    assert len(_data_blocks(prefix + ".index")) > 3
    reader = tb.CheckpointReader(prefix)
    assert sorted(reader.get_variable_to_shape_map()) == sorted(tensors)
    for name, value in tensors.items():
        got = reader.get_tensor(name)
        if isinstance(value, (bytes, list)):
            assert list(got.reshape(-1)) == ([value] if isinstance(value, bytes) else value)
            assert got.shape == (() if isinstance(value, bytes) else (len(value),))
        else:
            assert got.dtype == value.dtype and got.shape == value.shape and np.array_equal(got, value), name


@pytest.mark.parametrize(
    "case, error, match",
    [
        ("big_endian", NotImplementedError, "big-endian"),
        ("sliced", NotImplementedError, "w is a partitioned variable"),
        ("snappy", NotImplementedError, "snappy-compressed"),
        ("v1", NotImplementedError, "V1 checkpoint"),
        ("missing", FileNotFoundError, "no checkpoint"),
        ("not_a_table", OSError, "no table magic"),
        ("complex", NotImplementedError, "w: complex64 tensors are not read"),
        ("newer_version", NotImplementedError, "min consumer 2"),
        ("bad_consumer", NotImplementedError, r"bad consumers \[1\]"),
    ],
)
def test_refused_checkpoints_raise(tmp_path, case, error, match):
    prefix = str(tmp_path / "m.ckpt")
    tensors = {"w": np.ones(3, np.float32)}
    if case == "complex":
        chip_smoke.write_tf_bundle(prefix, {"w": np.ones(3, np.complex64)})
    elif case in ("big_endian", "sliced", "snappy"):
        chip_smoke.write_tf_bundle(prefix, tensors, big_endian=case == "big_endian", sliced={"w"} if case == "sliced" else (),
                                   compression=1 if case == "snappy" else 0)
    elif case == "v1":
        chip_smoke.write_table(prefix, [(b"w", b"\x00")])  # one table at the prefix itself
    elif case == "not_a_table":
        pathlib.Path(prefix + ".index").write_bytes(bytes(100))
    elif case in ("newer_version", "bad_consumer"):  # a VersionDef this reader must not read; bad_consumers packed
        pb = chip_smoke._pb
        version = pb(1, 2) + (pb(2, 2) if case == "newer_version" else pb(3, b"\x01"))
        chip_smoke.write_table(prefix + ".index", [(b"", pb(1, 1) + pb(3, version))])
    with pytest.raises(error, match=match):
        tb.CheckpointReader(prefix).get_tensor("w")


def test_tensorflow_reads_chip_smokes_writers(tmp_path, rng):
    """TensorFlow's reader, in a subprocess, on ``chip_smoke``'s files: a
    checkpoint of every kind of tensor over 3 shards, and a SavedModel's
    variables and ``keras_metadata.pb`` (ecSeg-i's config) parsed by
    TensorFlow's and TF-Keras's protobuf classes."""
    pytest.importorskip("tensorflow")
    from ecseg_torch.models.demo import demo_ecseg_i_tree

    tensors = _tensors(rng)
    chip_smoke.write_tf_bundle(str(tmp_path / "m.ckpt"), tensors, num_shards=3)
    chip_smoke.write_keras_savedmodel(str(tmp_path / "sm"), chip_smoke.ecseg_i_keras_config(),
                                      chip_smoke.classifier_keras_weights(demo_ecseg_i_tree()))
    code = """
import json, sys
import numpy as np
from tensorflow.python.training import py_checkpoint_reader
from tensorflow.core.protobuf import trackable_object_graph_pb2
from tf_keras.protobuf import saved_metadata_pb2
out = {}
r = py_checkpoint_reader.NewCheckpointReader("m.ckpt")
out["m"] = {k: [r.get_variable_to_dtype_map()[k].name, list(v)] for k, v in r.get_variable_to_shape_map().items()}
vals = {}
for k in out["m"]:
    v = r.get_tensor(k)
    vals[k] = [b.hex() for b in np.array(v, dtype=object).reshape(-1)] if out["m"][k][0] == "string" else np.asarray(v).tolist()
out["values"] = vals
r = py_checkpoint_reader.NewCheckpointReader("sm/variables/variables")
g = trackable_object_graph_pb2.TrackableObjectGraph()
g.ParseFromString(r.get_tensor("_CHECKPOINTABLE_OBJECT_GRAPH"))
out["graph"] = [[[[c.local_name, c.node_id] for c in n.children], [[a.full_name, a.checkpoint_key] for a in n.attributes]] for n in g.nodes]
out["sm_keys"] = sorted(r.get_variable_to_shape_map())
m = saved_metadata_pb2.SavedMetadata()
m.ParseFromString(open("sm/keras_metadata.pb", "rb").read())
out["metadata"] = [[n.node_path, n.identifier, json.loads(n.metadata)] for n in m.nodes]
print(json.dumps(out))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out["m"]) == sorted(tensors)
    for name, value in tensors.items():
        if isinstance(value, (bytes, list)):
            assert out["m"][name][0] == "string"
            assert out["values"][name] == [b.hex() for b in ([value] if isinstance(value, bytes) else value)]
        else:
            assert out["m"][name] == [tb.DTYPES[chip_smoke.TF_DTYPES[value.dtype.str]][0], list(value.shape)]
            assert np.array_equal(np.asarray(out["values"][name], dtype=value.dtype).reshape(value.shape), value), name
    ours = tb.object_graph(tb.CheckpointReader(str(tmp_path / "sm" / "variables" / "variables")))
    assert [[list(map(list, n["children"])), [[a[1], a[2]] for a in n["attributes"]]] for n in ours] == out["graph"]
    assert [[p, i] for p, i, _ in out["metadata"]][:2] == [["root", "_tf_keras_sequential"], ["root.layer-0", "_tf_keras_layer"]]
    assert out["metadata"][0][2]["model_config"]["config"]["layers"][1]["config"]["target_shape"] == {"class_name": "__tuple__", "items": [256, 256, 1]}
