"""``python -m ecseg_torch.make_demo_weights`` against the JAX repo's
``scripts/make_demo_weights.py``, each run in a working directory of its
own: the same four npz files with the same keys, shapes and dtypes; the
crafted entries (metaseg's level-1 convs and head, both NuSeT U-Nets'
level-1 convs and final conv) and both classifier trees bit-equal (the deep
random layers differ by design: torch generators against ``PRNGKey``
draws); the two example inputs equal, pixel for pixel by cv2 and byte for
byte; existing weights kept without ``--force``; ``--no-inputs``.

Then README's end-to-end demo on those files: the five pipelines of each
package on the CPU (the port with ``device="cpu"``, the JAX package as its
own tests run it: one device, the host post for metaseg, the fan-outs off)
on copies of the demo folder.  CSV and ``.npy`` bytes equal and TIFF/PNG
pixels equal, on the JAX script's files, on the port's files, and across
(each package on its own files: the crafted skip paths carry every output,
so the random deep layers reach none).  The five-task comparison is
``slow``; stat_fish alone stays in tier-1."""

import glob
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

import jax

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
WEIGHTS = ("models/metaseg.npz", "models/nuset.npz", "interseg_models/interseg.npz", "interseg_models/ecseg_c.npz")
INPUTS = ("example_interSeg/cells.tif", "example_ecSeg/input.tif")
CRAFTED = {  # npz file -> the keys both packages set by hand
    "models/metaseg.npz": [f"{n}/{p}" for n in ("enc1_1", "enc1_2", "dec1_1", "dec1_2", "head") for p in ("kernel", "bias")],
    "models/nuset.npz": [f"{u}/{n}/{p}" for u in ("whole", "fg/unet") for n in ("conv1-1", "conv1-2", "conv1-3", "conv1-4") for p in ("kernel", "bias")]
    + ["whole/final/kernel", "fg/unet/final/kernel"],
    "interseg_models/interseg.npz": None,  # every entry
    "interseg_models/ecseg_c.npz": None,
}
TASKS = ("metaseg", "meta_overlay", "stat_fish", "interseg", "fish_distance")


def _jax_script_main(argv):
    """``main`` of scripts/make_demo_weights.py, imported by path."""
    spec = importlib.util.spec_from_file_location("make_demo_weights_script", REPO / "scripts" / "make_demo_weights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


def _port_command(cwd, *args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run([sys.executable, "-m", "ecseg_torch.make_demo_weights", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, check=True).stdout


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """{"jax": dir, "port": dir}: each package's demo weights and inputs,
    written into an empty working directory."""
    root = tmp_path_factory.mktemp("demo_weights_port")
    dirs = {side: root / side for side in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    cwd = os.getcwd()
    os.chdir(dirs["jax"])
    try:
        assert _jax_script_main([]) == 0
    finally:
        os.chdir(cwd)
    out = _port_command(dirs["port"])
    assert out.splitlines() == [f"wrote {p}" for p in INPUTS + WEIGHTS]
    return dirs


@pytest.mark.parametrize("name", WEIGHTS)
def test_same_keys_shapes_and_dtypes(made, name):
    with np.load(made["jax"] / name) as a, np.load(made["port"] / name) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k


@pytest.mark.parametrize("name", WEIGHTS)
def test_crafted_entries_bit_equal(made, name):
    with np.load(made["jax"] / name) as a, np.load(made["port"] / name) as b:
        keys = CRAFTED[name] or a.files
        for k in keys:
            assert a[k].tobytes() == b[k].tobytes(), k
        if CRAFTED[name] is not None:  # the deep layers are each package's own draws
            assert any(not np.array_equal(a[k], b[k]) for k in a.files if k not in keys)


@pytest.mark.parametrize("name", INPUTS)
def test_example_inputs_equal(made, name):
    a, b = (cv2.imread(str(made[side] / name), cv2.IMREAD_UNCHANGED) for side in ("jax", "port"))
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert (made["jax"] / name).read_bytes() == (made["port"] / name).read_bytes()  # cv2's LZW bytes


def test_keeps_existing_weights_without_force(tmp_path):
    """tests/test_demo_weights.py's pin of the script: a file at a target
    path survives a rerun; only ``--force`` overwrites it."""
    from ecseg_torch import make_demo_weights

    mdir, idir = tmp_path / "models", tmp_path / "interseg_models"
    mdir.mkdir()
    idir.mkdir()
    sentinel = b"REAL-WEIGHTS-SENTINEL"
    (mdir / "metaseg.npz").write_bytes(sentinel)
    args = ["--model-dir", str(mdir), "--interseg-dir", str(idir), "--no-inputs"]
    out = _port_command(tmp_path, *args)
    assert f"kept existing {mdir / 'metaseg.npz'} (use --force to overwrite)" in out.splitlines()
    assert (mdir / "metaseg.npz").read_bytes() == sentinel
    assert (mdir / "nuset.npz").exists() and (idir / "interseg.npz").exists() and (idir / "ecseg_c.npz").exists()
    assert sorted(os.listdir(tmp_path)) == ["interseg_models", "models"]  # --no-inputs
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:  # the default directories, relative to the working directory
        assert make_demo_weights.main(["--no-inputs", "--force"]) == 0
    finally:
        os.chdir(cwd)
    assert (mdir / "metaseg.npz").read_bytes() != sentinel
    assert sorted(os.listdir(tmp_path)) == ["interseg_models", "models"]


# ---------------------------------------------------------------------------
# README's end-to-end demo, both packages
# ---------------------------------------------------------------------------


def _sections(d):
    ec, inter = os.path.join(d, "example_ecSeg"), os.path.join(d, "example_interSeg")
    return {
        "metaseg": {"inpath": ec},
        "meta_overlay": {"inpath": ec, "color_sensitivity": 85},
        "stat_fish": {"inpath": inter, "scale": 1, "use_min_cut": True, "nuclei_size_T": 5000},
        "interseg": {"inpath": inter, "FISH_color": "red", "has_centromeric_probe": False},
        "fish_distance_calculation": {"inpath": inter, "centromere_probe_color": "green", "fish_probe_color": "red",
                                      "max_centromeric_spots": 3},
    }


def _run_demo(package, weights_dir, out_dir, inputs_dir, tasks):
    """The tasks of README's demo, in its order, by ``package`` ("jax" or
    "port") with ``weights_dir``'s npz files on a copy of
    ``inputs_dir``'s example folders in ``out_dir``."""
    for sub in ("example_ecSeg", "example_interSeg"):
        shutil.copytree(os.path.join(inputs_dir, sub), os.path.join(out_dir, sub))
    raw = _sections(str(out_dir))
    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as m:
        m.chdir(weights_dir)
        for var in ("ECSEG_STAT_FISH_SHARD", "ECSEG_INTERSEG_SHARD", "ECSEG_OVERLAY_SHARD"):
            m.setenv(var, "0")
        for var in ("ECSEG_MC_LABEL", "ECSEG_MC_MERGE", "ECSEG_DEVICE_PIPELINE", "ECSEG_TIF_LZW", "ECSEG_NO_NATIVE",
                    "ECSEG_STAT_FISH_TAIL_WORKERS", "ECSEG_FAST_WATERSHED"):
            m.delenv(var, raising=False)
        if package == "jax":
            from ecseg_tpu.core.config import Config
            from ecseg_tpu.pipelines import fish_distance, interseg, meta_overlay, metaseg, stat_fish

            dev0 = jax.devices()[0]
            m.setattr(metaseg.jax, "devices", lambda *a, **k: [dev0])  # the single-device per-image program
            m.setenv("ECSEG_DEVICE_PIPELINE", "0")
            kw = {}
        else:
            from ecseg_torch.core.config import Config
            from ecseg_torch.pipelines import fish_distance, interseg, meta_overlay, metaseg, stat_fish

            kw = {"device": "cpu"}
        mains = {"metaseg": metaseg.main, "meta_overlay": meta_overlay.main, "stat_fish": stat_fish.main,
                 "interseg": interseg.main, "fish_distance": fish_distance.main}
        for task in tasks:
            rc = mains[task](config=Config(raw=raw), **({} if task == "fish_distance" else kw))
            assert rc == 0, (package, task)
    assert os.getcwd() == cwd


def _outputs(d):
    return {os.path.relpath(p, d): p for p in glob.glob(os.path.join(d, "**"), recursive=True)
            if os.path.isfile(p) and "/config_" not in p}


def _assert_same_outputs(got_dir, want_dir):
    got, want = _outputs(got_dir), _outputs(want_dir)
    assert sorted(got) == sorted(want)
    for key, path in want.items():
        if key.endswith((".tif", ".png")):
            a, b = cv2.imread(got[key], cv2.IMREAD_UNCHANGED), cv2.imread(path, cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and np.array_equal(a, b), key
        else:
            assert open(got[key], "rb").read() == open(path, "rb").read(), key


def _rows(path):
    return open(path).read().splitlines()[1:]


def _assert_readme_counts(d, tasks):
    """README's demo promise: 3 nuclei, each with 3 red foci and one green
    centromere -> 3 stat_fish rows, 3 ``EC-amp`` rows, 3 distances."""
    inter = os.path.join(d, "example_interSeg")
    if "metaseg" in tasks:
        assert _rows(os.path.join(d, "example_ecSeg", "ec_quantification.csv")) == ["input.tif,1"]
    if "meta_overlay" in tasks:
        assert len(_rows(os.path.join(d, "example_ecSeg", "fish_quantification.csv"))) == 1
    if "stat_fish" in tasks:
        rows = [r.split(",") for r in _rows(os.path.join(inter, "annotated", "stat_fish_lsq.csv"))]
        assert [r[0] for r in rows] == ["cells"] * 3
        assert [(r[3], r[7]) for r in rows] == [("1", "3")] * 3  # green foci, red foci
    if "interseg" in tasks:
        assert [r.split(",")[2:] for r in _rows(os.path.join(inter, "interphase_prediction_red.csv"))] == [["EC-amp", "EC-amp"]] * 3
    if "fish_distance" in tasks:
        assert len(_rows(os.path.join(inter, "centromere_distances.csv"))) == 3


def test_stat_fish_demo_matches_jax(made, tmp_path):
    """One task of the demo in tier-1: stat_fish on the JAX script's files
    (both packages) and the port on its own files, byte for byte."""
    runs = {("jax", "jax"): None, ("port", "jax"): None, ("port", "port"): None}  # (package, whose files)
    for package, files in runs:
        out = tmp_path / f"{package}_on_{files}"
        out.mkdir()
        _run_demo(package, made[files], out, made["jax"], ["stat_fish"])
        runs[package, files] = str(out)
    _assert_readme_counts(runs["port", "port"], ["stat_fish"])
    _assert_same_outputs(runs["port", "jax"], runs["jax", "jax"])
    _assert_same_outputs(runs["port", "port"], runs["jax", "jax"])


@pytest.fixture(scope="module")
def demo_runs(made, tmp_path_factory):
    """(package, whose weight files) -> the folder the five tasks wrote."""
    root = tmp_path_factory.mktemp("demo_e2e")
    runs = {}
    for package in ("jax", "port"):
        for files in ("jax", "port"):
            out = root / f"{package}_on_{files}"
            out.mkdir()
            _run_demo(package, made[files], out, made["jax"], TASKS)
            runs[package, files] = str(out)
    return runs


@pytest.mark.slow
@pytest.mark.parametrize("files", ["jax", "port"])
def test_demo_matches_jax_on_the_same_files(demo_runs, files):
    _assert_readme_counts(demo_runs["port", files], TASKS)
    _assert_same_outputs(demo_runs["port", files], demo_runs["jax", files])


@pytest.mark.slow
def test_demo_matches_jax_each_on_its_own_files(demo_runs):
    _assert_readme_counts(demo_runs["jax", "jax"], TASKS)
    _assert_same_outputs(demo_runs["port", "port"], demo_runs["jax", "jax"])
