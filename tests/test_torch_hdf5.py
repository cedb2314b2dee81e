"""The port's HDF5 reader (``ecseg_torch/core/hdf5.py``) against h5py.

Files written by h5py under its default ``libver`` hold every datatype the
reader reads (fixed-point of 1-8 bytes and IEEE floats of 2-8 bytes in both
byte orders, fixed-length strings under each padding, variable-length
strings), scalar, zero-sized and null dataspaces, a group of 300 members
(a two-level B-tree), a group of 200 attributes (continuation blocks),
compact, contiguous, unallocated and chunked datasets (deflate, shuffle and
fletcher32, edge chunks, unwritten chunks, a two-level chunk B-tree), a
user block, and a bytes buffer as the file.  Every dataset and attribute
must read as h5py reads it: value, dtype, shape and Python type, and
``visititems`` must give h5py's names in h5py's order.  A hypothesis test
draws random trees of these.  Files the reader does not read (h5py's
``libver="latest"``, soft and external links, compound and enum values)
raise ``NotImplementedError``.  Keras 3.13's own saves
(``tests/fixtures/keras3_small.*``, written by
``tests/fixtures/make_keras3_fixtures.py``) read without h5py or Keras.
"""

import io
import os
import zipfile

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ecseg_torch.core import hdf5
from ecseg_torch.models import keras_import as tk

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

h5py = pytest.importorskip("h5py")

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
NUMERIC = [f"{o}{k}{n}" for o in "<>" for k, n in [("u", 1), ("u", 2), ("u", 4), ("u", 8), ("i", 1), ("i", 2), ("i", 4), ("i", 8),
                                                     ("f", 2), ("f", 4), ("f", 8)]]
SHAPES = [(), (0,), (3,), (2, 3, 4)]
KERAS3_ATOL = 1e-6  # the port's float32 executor against Keras's own output on the fixture's input


def _values(dtype, shape, rng):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        v = rng.standard_normal(shape) * 100
        v.flat[: min(v.size, 2)] = [np.inf, -0.0][: min(v.size, 2)]
        return np.asarray(v, dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, dtype=dt.newbyteorder("="), endpoint=True).astype(dt)


def _same(got, want, where):
    """``got`` (the reader's) is ``want`` (h5py's): Python type, dtype,
    shape and value."""
    if isinstance(want, h5py.Empty):
        assert isinstance(got, hdf5.Empty) and got.dtype == want.dtype, where
        return
    assert type(got) is type(want), f"{where}: {type(got)} != {type(want)}"
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.dtype.str == want.dtype.str, f"{where}: {got.dtype!r} != {want.dtype!r}"
        assert got.shape == want.shape, where
        if want.dtype == object:
            assert [type(v) for v in got.ravel()] == [type(v) for v in want.ravel()], where
            assert list(got.ravel()) == list(want.ravel()), where
        else:
            assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), where
    else:
        assert got == want, where


def _compare(source, h5_source):
    """Every object, dataset and attribute of the file, the reader's
    reading of ``source`` against h5py's of ``h5_source``."""
    with h5py.File(h5_source, "r") as f, hdf5.File(source) as r:
        want_names, got_names = [], []
        f.visititems(lambda n, o: want_names.append((n, type(o).__name__)))
        r.visititems(lambda n, o: got_names.append((n, type(o).__name__)))
        assert got_names == want_names
        for name, kind in [("/", "Group")] + want_names:
            fo, ro = f[name], r[name]
            assert list(fo.attrs.keys()) == list(ro.attrs.keys()), name
            for key in fo.attrs:
                _same(ro.attrs[key], fo.attrs[key], f"{name} attr {key}")
                assert key in ro.attrs
            if kind == "Group":
                assert list(fo.keys()) == list(ro.keys()) and len(fo) == len(ro), name
            else:
                assert ro.shape == fo.shape and ro.dtype == fo.dtype and ro.dtype.str == fo.dtype.str, name
                _same(ro[()], fo[()], name)
                if fo.shape is not None:
                    _same(np.array(ro), np.array(fo), name)


def _numeric(f, rng):
    for dt in NUMERIC:
        for k, shape in enumerate(SHAPES):
            name = f"{dt.replace('<', 'le_').replace('>', 'be_')}_{k}"
            v = _values(dt, shape, rng)
            f.create_dataset(name, data=v)
            f.attrs[name] = v


def _strings(f, rng):
    g = f.create_group("s")
    for pad, tag in ((h5py.h5t.STR_NULLTERM, "nullterm"), (h5py.h5t.STR_NULLPAD, "nullpad"), (h5py.h5t.STR_SPACEPAD, "spacepad")):
        for cset in (h5py.h5t.CSET_ASCII, h5py.h5t.CSET_UTF8):
            tid = h5py.h5t.C_S1.copy()
            tid.set_size(6)
            tid.set_strpad(pad)
            tid.set_cset(cset)
            for shape in ((), (4,), (2, 2)):
                sid = h5py.h5s.create_simple(shape) if shape else h5py.h5s.create(h5py.h5s.SCALAR)
                data = np.array(b"ab c" if not shape else np.reshape([b"x", b"ab  ", b"abcdef", b""], shape), dtype="S6")
                name = f"{tag}_{cset}_{len(shape)}".encode()
                h5py.h5a.create(g.id, name, tid, sid).write(data, mtype=tid)
                h5py.h5d.create(g.id, name, tid, sid).write(h5py.h5s.ALL, h5py.h5s.ALL, data, mtype=tid)
    for enc in ("utf-8", "ascii"):
        dt = h5py.string_dtype(enc)
        words = ["héllo", "", "a b "] if enc == "utf-8" else ["hello", "", "a b "]
        g.attrs.create(f"vlen_{enc}_0", words[0], dtype=dt)
        g.attrs.create(f"vlen_{enc}_1", words, dtype=dt)
        g.create_dataset(f"vlen_{enc}_0", data=words[0], dtype=dt)
        g.create_dataset(f"vlen_{enc}_1", data=np.array(words * 2, dtype=object).reshape(2, 3), dtype=dt)
    g.attrs["bytes_scalar"] = np.bytes_(b"model")
    g.attrs["bytes_list"] = [b"conv/kernel:0", b"conv/bias:0"]
    g.attrs["str_list"] = ["conv/kernel", "conv/bias"]
    g.attrs["long_vlen"] = "x" * 5000  # as long as a Keras model_config


def _empty(f, rng):
    for dt in ("<f4", ">i2", "S3"):
        tag = dt.replace("<", "le").replace(">", "be")
        f.attrs[f"empty_{tag}"] = h5py.Empty(dt)
        f.create_dataset(f"empty_{tag}", data=h5py.Empty(dt))
    f.attrs["zero_f8"] = np.zeros((0,))  # Keras 3's empty weight_names
    f.attrs["zero_2d"] = np.zeros((0, 3), ">i4")
    f.attrs["scalar"] = np.int16(-3)
    f.create_dataset("zero", data=np.zeros((0, 2), np.float32))


def _big_group(f, rng):
    g = f.create_group("big")
    for k in range(300):  # more than 32 SNODs of 8: a level-1 B-tree node
        g.create_dataset(f"m{k:03d}" if k % 3 else f"member_{k}", data=np.int32(k))
    g.create_group("sub").create_dataset("leaf", data=np.arange(4.0))


def _many_attrs(f, rng):
    g = f.create_group("attrs")
    for k in range(200):  # the header spills into continuation blocks
        g.attrs[f"a{k:03d}"] = _values(NUMERIC[k % len(NUMERIC)], (k % 5,), rng)


def _layouts(f, rng):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    v = _values("<i4", (3, 5), rng)
    ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I32LE, h5py.h5s.create_simple(v.shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, v)
    f.create_dataset("contiguous", data=_values(">f8", (4, 7), rng))
    f.create_dataset("unallocated", shape=(3, 4), dtype="<f4", fillvalue=7.5)
    f.create_dataset("unallocated_nofill", shape=(2,), dtype=">u2")
    v = _values("<f4", (25, 41), rng)
    f.create_dataset("chunked", data=v, chunks=(7, 9), compression="gzip", shuffle=True, fletcher32=True)
    f.create_dataset("chunked_plain", data=_values(">i8", (5, 6, 7), rng), chunks=(2, 4, 3))
    d = f.create_dataset("chunked_partial", shape=(20, 20), dtype="<i2", chunks=(6, 6), fillvalue=-9, compression="gzip")
    d[2:9, 13:] = 4  # some chunks written, the rest read as the fill value
    f.create_dataset("chunked_two_levels", data=_values("<u2", (100, 90), rng), chunks=(5, 9))  # 200 chunks
    # Fletcher-32's worst case: every word 0xffff, chunks far longer than 360 words
    f.create_dataset("fletcher_ones", data=np.full((3000,), 0xFFFF, "<u2"), chunks=(1111,), fletcher32=True)
    f.create_dataset("fletcher_odd", data=np.arange(1001, dtype="u1"), chunks=(333,), fletcher32=True)


WRITERS = {"numeric": _numeric, "strings": _strings, "empty": _empty, "big_group": _big_group, "many_attrs": _many_attrs, "layouts": _layouts}


@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_reads_what_h5py_reads(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    with h5py.File(path, "w") as f:
        WRITERS[kind](f, np.random.default_rng(sorted(WRITERS).index(kind)))
    _compare(path, path)


def test_user_block_and_buffers(tmp_path):
    path = str(tmp_path / "ub.h5")
    with h5py.File(path, "w", userblock_size=512) as f:
        _layouts(f, np.random.default_rng(5))
        f.attrs["model_config"] = '{"class_name": "Functional"}'
    with open(path, "r+b") as fh:
        fh.write(b"user block bytes")
    data = open(path, "rb").read()
    for source in (path, data, bytearray(data), memoryview(data), io.BytesIO(data)):
        _compare(source, path)
    with open(path, "rb") as fh:  # a file object the caller opened stays open
        with hdf5.File(fh) as r:
            assert r.keys()
        assert not fh.closed


def test_big_groups_need_a_second_btree_level(tmp_path):
    """The 300-member group's B-tree and the 200-chunk dataset's have a
    level-1 root, so the reader's descent is exercised."""
    path = str(tmp_path / "levels.h5")
    with h5py.File(path, "w") as f:
        _big_group(f, None)
        _layouts(f, np.random.default_rng(0))
    with hdf5.File(path) as r:
        reader = r._reader
        table = reader.cursor(reader.header(r["big"]._addr).first(0x11))
        assert reader.read(table.addr(), 8)[5] == 1
        assert len(r["big"]) == 301 and r["big/member_0"][()] == 0 and r["big/m299"][()] == 299
        assert r["/big/sub/leaf"].shape == (4,) and "big/sub/leaf" in r and "big/nothing" not in r


@pytest.mark.parametrize("dtype", ["<f4", ">f8", "<i1", ">u8", "S5", "vlen"])
def test_every_attribute_and_dataset_form_of_one_type(tmp_path, dtype):
    """One type in all shapes, written both as attribute and dataset."""
    path = str(tmp_path / "one.h5")
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        for k, shape in enumerate(SHAPES):
            if dtype == "vlen":
                v = np.array(["w" * k for k in range(int(np.prod(shape)))], dtype=object).reshape(shape)
                kw = {"dtype": h5py.string_dtype()}
            elif dtype.startswith("S"):
                v = np.array([b"ab"[: k % 3] + b"c" for k in range(int(np.prod(shape)))], dtype=dtype).reshape(shape)
                kw = {}
            else:
                v, kw = _values(dtype, shape, rng), {}
            f.attrs.create(f"a{k}", v, **kw)
            f.create_dataset(f"d{k}", data=v, **kw)
    _compare(path, path)


# --- random trees -----------------------------------------------------------

_NAMES = st.text(alphabet="abcXYZ_:0123é", min_size=1, max_size=6)
_DTYPES = st.sampled_from(NUMERIC + ["S4", "vlen"])
_SHAPE = st.lists(st.integers(0, 3), min_size=0, max_size=3).map(tuple)


@st.composite
def _values_st(draw):
    dt, shape = draw(_DTYPES), draw(_SHAPE)
    rng = np.random.default_rng(draw(st.integers(0, 2**16)))
    n = int(np.prod(shape))
    if dt == "vlen":
        return np.array(["é" * (k % 4) + str(k) for k in range(n)], dtype=object).reshape(shape), {"dtype": h5py.string_dtype()}
    if dt == "S4":
        return np.array([bytes([97 + k % 26]) * (1 + k % 4) for k in range(n)], dtype="S4").reshape(shape), {}
    return _values(dt, shape, rng), {}


@st.composite
def _trees(draw, depth=0):
    node = {"attrs": draw(st.dictionaries(_NAMES, _values_st(), max_size=4)), "members": {}}
    for name in draw(st.lists(_NAMES, max_size=4 if depth < 2 else 0, unique=True)):
        node["members"][name] = draw(_trees(depth + 1)) if draw(st.booleans()) else draw(_values_st())
    return node


def _write_tree(g, node):
    for name, (value, kw) in node["attrs"].items():
        g.attrs.create(name, value, **kw)
    for name, member in node["members"].items():
        if isinstance(member, dict):
            _write_tree(g.create_group(name), member)
        else:
            value, kw = member
            g.create_dataset(name, data=value, **kw)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large])
@given(tree=_trees())
def test_random_trees_read_as_h5py_reads_them(tree):
    buf = io.BytesIO()
    with h5py.File(buf, "w") as f:
        _write_tree(f, tree)
    _compare(buf.getvalue(), io.BytesIO(buf.getvalue()))


# --- what the reader refuses ------------------------------------------------


def test_libver_latest_is_refused(tmp_path):
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("g")
        for k in range(12):  # more than 8 links: dense storage
            g.create_dataset(f"d{k}", data=np.arange(3))
    with pytest.raises(NotImplementedError, match="superblock v2/v3"):
        hdf5.File(path)


def test_links_and_types_it_does_not_read_raise(tmp_path):
    path = str(tmp_path / "refused.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=np.arange(3))
        f["soft"] = h5py.SoftLink("/data")
        f.attrs["compound"] = np.zeros(2, dtype=[("a", "<i4"), ("b", "<f4")])
        f.attrs["enum"] = True
        f.create_dataset("z_compound", data=np.zeros(2, dtype=[("a", "<i4")]))
        g = f.create_group("z_group")
        g["ext"] = h5py.ExternalLink("other.h5", "/x")
    with hdf5.File(path) as r:
        assert r.keys() == ["data", "soft", "z_compound", "z_group"] and r.attrs.keys() == ["compound", "enum"]
        with pytest.raises(NotImplementedError, match="soft link /soft"):
            r["soft"]
        with pytest.raises(NotImplementedError, match="external link /z_group/ext"):
            r["z_group/ext"]
        with pytest.raises(NotImplementedError, match="soft link"):
            r.visititems(lambda name, obj: None)
        with pytest.raises(NotImplementedError, match="class 6 \\(compound\\)"):
            r.attrs["compound"]
        with pytest.raises(NotImplementedError, match="class 8 \\(enum\\)"):
            r.attrs["enum"]
        with pytest.raises(NotImplementedError, match="class 6 \\(compound\\)"):
            r["z_compound"]
        np.testing.assert_array_equal(np.array(r["data"]), np.arange(3))


def test_not_hdf5_and_cut_short_raise_oserror(tmp_path):
    path = str(tmp_path / "m.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=np.arange(1000.0))
    data = open(path, "rb").read()
    for bad in (b"", b"not an hdf5 file" * 40):
        with pytest.raises(OSError):
            hdf5.File(bad)
    with hdf5.File(data[:-100]) as r:
        with pytest.raises(OSError):
            r["d"][()]


# --- Keras 3's own files ----------------------------------------------------


def _fixture(name):
    return os.path.join(FIXTURES, name)


def test_keras3_h5_save_reads_without_h5py():
    """Keras 3.13's legacy ``.h5``: vlen string attributes (the
    model_config), vlen ``weight_names``, the empty ones as float64 (0,),
    and every weight equal to what Keras held."""
    arrays = np.load(_fixture("keras3_small.npz"))
    with hdf5.File(_fixture("keras3_small.h5")) as r:
        assert type(r.attrs["model_config"]) is str and r.attrs["keras_version"] == str(arrays["keras_version"])
        mw = r["model_weights"]
        assert mw["inp"].attrs["weight_names"].dtype == np.float64 and mw["inp"].attrs["weight_names"].shape == (0,)
        assert list(mw["conv"].attrs["weight_names"]) == ["conv/kernel", "conv/bias"]
        names = [k for k in arrays.files if "/" in k]
        for name in names:
            got = mw[name][()]
            assert got.dtype == np.float32 and np.array_equal(got, arrays[name]), name


@pytest.mark.parametrize("name", ["keras3_small.h5", "keras3_small.keras"])
def test_keras3_saves_run_through_the_executor(name):
    """Both of Keras 3's containers through ``import_keras_file``, against
    Keras's own output on the fixture's input."""
    arrays = np.load(_fixture("keras3_small.npz"))
    if name.endswith(".keras"):
        with zipfile.ZipFile(_fixture(name)) as z, hdf5.File(z.read("model.weights.h5")) as w:
            assert w["layers/conv2d/vars/0"].shape == arrays["conv/conv/kernel"].shape
    model = tk.import_keras_file(_fixture(name), device="cpu")
    with torch.no_grad():
        got = model(arrays["x"]).numpy()
    np.testing.assert_allclose(got, arrays["y"], rtol=0, atol=KERAS3_ATOL)
