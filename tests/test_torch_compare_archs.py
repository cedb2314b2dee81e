"""The port's two model scripts against the JAX repo's, on the CPU:
``python -m ecseg_torch.compare_archs`` against ``scripts/compare_archs.py``
and ``python -m ecseg_torch.roofline_forward`` against
``scripts/roofline_forward.py`` (both scripts loaded by importlib).

- ``synth_pair``: labels and image bytes equal to the script's at 256^2 and
  1024^2 over three seeds; ``gaussian_blur5`` equal to
  ``cv2.GaussianBlur(img, (5, 5), 1.2)`` bit for bit on random float32 at
  ragged shapes (odd widths, widths off a multiple of 8, 3-pixel edges);
- ``evaluate`` on a 512^2 field from the script's parameters carried across
  by ``models/weights.params_from_numpy`` at widths (4, 8): the IoUs and
  accuracy equal the script's ``evaluate``;
- three training steps from the same carried weights at batch 2: the port's
  ``train_model`` on one CPU entry against the script's ``train_arch`` over
  the 8-device virtual CPU mesh (batch padded to 8 with a ``valid`` mask):
  losses within rtol 1e-5 (float32 in both, Adam's update rounded in
  another order and the mesh's pad samples masked rather than absent;
  observed 1.6e-7 at the third step), and the result dicts equal but for
  ``train_s``;
- ``main(device="cpu")`` with ``--sweep``: the JSON keys in the script's
  order, the loss lines, the gap line and the sweep table's format (its
  times from the JSON lines' ``train_s``); ``python -m`` exits 1
  without a card; ``train_arch`` starts from the architecture drawn from
  ``--seed``;
- ``roofline_forward.layers`` equals the script's rows for both
  architectures, its printed rows and totals equal the script's own at the
  H100's peaks, and the peaks that ``bench`` and ``profile_layers`` read
  come from the shared table.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from ecseg_torch import bench, compare_archs, profile_layers, roofline_forward
from ecseg_torch.models import metaseg_unet
from ecseg_torch.models.weights import params_from_numpy
from ecseg_torch.parallel.mesh import make_mesh
from ecseg_torch.peaks import H100, PEAKS
from ecseg_torch.runtime.train import MeshTrainStep

from _meshutil import on_virtual_cpu_mesh, rerun_self_in_subprocess
from _torchutil import numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
NARROW = ((4, 8), 16)
KEYS = ["arch", "steps", "batch", "train_s", "iou_bg", "iou_nucleus", "iou_chromosome", "iou_ec", "mean_iou",
        "pixel_acc"]


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- the synthetic fields --------------------------------------------------------


@pytest.mark.parametrize("hw", [256, 1024])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synth_pair_equals_the_script(hw, seed):
    want_rng, got_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jax_script("compare_archs").synth_pair(want_rng, hw)
    got = compare_archs.synth_pair(got_rng, hw)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert got_rng.random() == want_rng.random()  # the same number of draws


@pytest.mark.parametrize("shape", [(3, 3), (5, 7), (4, 100), (16, 17), (37, 300), (129, 77), (300, 31), (255, 1023),
                                   (1024, 1024)])
def test_blur_equals_cv2(shape):
    rng = np.random.default_rng(shape[0] * 7919 + shape[1])
    for scale in (1.0, 255.0, 1e4):
        img = (rng.random(shape) * scale).astype(np.float32)
        got = compare_archs.gaussian_blur5(img)
        want = cv2.GaussianBlur(img, (5, 5), 1.2)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (shape, scale)


def _fma_exact(a, b, c):
    """float32 a * b + c rounded once to nearest, ties to even, from the
    exact rational value."""
    from fractions import Fraction

    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(v))
    cands = [r, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - v), int(x.view(np.uint32)) & 1))


def test_fma32_rounds_once():
    """Against the exact rational value: random triples, and sums that
    float64 puts on a float32 midpoint while the exact value lies past it
    (where rounding the float64 sum again goes the wrong way)."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(500).astype(np.float32) for _ in range(3))
    half = np.float32(1 + 2.0**-12)  # half * half = 1 + 2^-11 + 2^-24: a float32 midpoint
    a = np.concatenate([a, [half, half, -half]]).astype(np.float32)
    b = np.concatenate([b, [half, half, half]]).astype(np.float32)
    c = np.concatenate([c, [2.0**-60, -(2.0**-60), 2.0**-60]]).astype(np.float32)
    got = np.array([compare_archs._fma32(a[i:i + 1], b[i], c[i:i + 1])[0] for i in range(len(a))])
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    assert got.tobytes() == want.tobytes()
    assert got[-3] == np.float32(1 + 2.0**-11 + 2.0**-23) and got[-2] == np.float32(1 + 2.0**-11)
    naive = (np.float64(half) * np.float64(half) + np.float64(c[-3])).astype(np.float32)
    assert naive != got[-3]  # the case the two-sum repairs


# --- evaluation and training from carried weights --------------------------------


def _jax_params(tree):
    import jax.numpy as jnp

    return {name: {k: jnp.asarray(v) for k, v in leaves.items()} for name, leaves in tree.items()}


def test_evaluate_equals_the_script():
    import jax.numpy as jnp

    tree = numpy_metaseg_tree(*NARROW, seed=3)
    pairs = [compare_archs.synth_pair(np.random.default_rng(5), 512)]
    want_iou, want_acc = jax_script("compare_archs").evaluate(_jax_params(tree), pairs, jnp.float32)
    iou, acc = compare_archs.evaluate(params_from_numpy(tree), pairs)
    assert iou.tolist() == want_iou.tolist() and acc == want_acc
    assert 0 < acc < 1 and all(0 <= v <= 1 for v in iou)


def test_train_steps_match_the_script(monkeypatch):
    """Three Adam steps at lr 3e-4 from the same weights and crops: the
    port on one CPU entry, the script over the 8-device virtual mesh."""
    if not on_virtual_cpu_mesh(8):
        rerun_self_in_subprocess(__file__, "test_train_steps_match_the_script")
        return
    from ecseg_tpu.models import metaseg_unet as ju
    from ecseg_tpu.runtime import train as jtrain

    tree = numpy_metaseg_tree(*NARROW, seed=4)
    rng = np.random.default_rng(6)
    train_pairs = [compare_archs.synth_pair(rng, 320) for _ in range(2)]
    eval_pairs = [compare_archs.synth_pair(rng, 256)]
    steps, batch, lr, seed = 3, 2, 3e-4, 0

    jax_losses = []
    make_step = jtrain.jit_train_step_on_mesh

    def recording_jit_step(*a, **k):
        step_fn, *rest = make_step(*a, **k)

        def step(*args):
            out = step_fn(*args)
            jax_losses.append(float(out[2]))
            return out

        return (step, *rest)

    monkeypatch.setattr(jtrain, "jit_train_step_on_mesh", recording_jit_step)
    monkeypatch.setattr(ju, "init_params", lambda *a, **k: _jax_params(tree))
    with contextlib.redirect_stderr(io.StringIO()):
        want = jax_script("compare_archs").train_arch("default", train_pairs, eval_pairs, steps, batch, lr, seed)

    losses = []
    step_call = MeshTrainStep.__call__

    def recording_call(self, *args):
        loss = step_call(self, *args)
        losses.append(float(loss))
        return loss

    monkeypatch.setattr(MeshTrainStep, "__call__", recording_call)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        got = compare_archs.train_model(params_from_numpy(tree), "default", train_pairs, eval_pairs, steps, batch, lr,
                                        seed, make_mesh(["cpu"]))
    assert len(losses) == len(jax_losses) == steps
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    assert list(got) == list(want) == KEYS
    assert {k: v for k, v in got.items() if k != "train_s"} == {k: v for k, v in want.items() if k != "train_s"}
    assert [ln.split(" loss ")[0] for ln in err.getvalue().splitlines()] == ["[default] step    0", "[default] step    2"]


@pytest.mark.parametrize("arch", ["default", "xl"])
def test_train_arch_starts_from_the_seeded_model(arch, monkeypatch):
    """``train_arch`` hands ``train_model`` the architecture's widths drawn
    from a torch generator seeded ``seed``: one seed, one start; another
    seed, another."""
    from ecseg_torch.models.weights import params_to_numpy

    starts = []
    monkeypatch.setattr(compare_archs, "train_model", lambda model, *a: starts.append((model, a)) or {})
    mesh = make_mesh(["cpu"])
    for seed in (0, 0, 1):
        compare_archs.train_arch(arch, [], [], 1, 2, 3e-4, seed, mesh)
    widths, bottleneck = compare_archs.ARCHS[arch]
    for model, a in starts:
        assert model.widths == tuple(widths) and model.layers["bott_1"].weight.shape[0] == bottleneck
        assert a[0] == arch and a[-1] is mesh
    assert [a[-2] for _, a in starts] == [0, 0, 1]
    first, same, other = (params_to_numpy(m)["enc1_1"]["kernel"].tobytes() for m, _ in starts)
    assert first == same != other


# --- the command line --------------------------------------------------------------


def test_main_prints_the_script_lines(monkeypatch):
    monkeypatch.setattr(compare_archs, "ARCHS", {"default": NARROW, "xl": ((8, 16), 32)})
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = compare_archs.main(["--steps", "9", "--batch", "2", "--n-train", "1", "--n-eval", "1", "--sweep", "2"],
                                device="cpu")
    assert rc == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [list(r) for r in lines] == [KEYS, KEYS]
    assert [(r["arch"], r["steps"], r["batch"]) for r in lines] == [("default", 2, 2), ("xl", 2, 2)]
    for r in lines:
        assert all(0 <= r[k] <= 1 for k in KEYS[4:]) and r["train_s"] >= 0
    errs = err.getvalue().splitlines()
    assert errs[0] == "generating synthetic DAPI fields..."
    assert [ln.split(" loss ")[0] for ln in errs if " loss " in ln] == ["[default] step    0", "[default] step    1",
                                                                         "[xl] step    0", "[xl] step    1"]
    d, x = lines
    gap = (f"[2 steps] mean IoU: half-width {d['mean_iou']:.4f} vs xl {x['mean_iou']:.4f} "
           f"(gap {x['mean_iou'] - d['mean_iou']:+.4f}); ec IoU {d['iou_ec']:.4f} vs {x['iou_ec']:.4f}")
    assert gap in errs
    assert errs[-3:] == [
        "| steps | half mIoU | xl mIoU | half ec IoU | xl ec IoU | half train s | xl train s |",
        "|---|---|---|---|---|---|---|",
        f"| 2 | {d['mean_iou']:.3f} | {x['mean_iou']:.3f} | {d['iou_ec']:.3f} | {x['iou_ec']:.3f} | "
        f"{d['train_s']:.0f} | {x['train_s']:.0f} |",
    ]


def test_command_line_exits_1_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "ecseg_torch.compare_archs", "--steps", "1"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and out.stdout == ""
    assert out.stderr.strip() == "compare_archs: no CUDA device is available; aborting without a result"


# --- the roofline ------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["default", "xl"])
def test_roofline_layers_equal_the_script(arch):
    script = jax_script("roofline_forward")
    widths, bottleneck = compare_archs.ARCHS[arch]
    assert roofline_forward.layers(widths, bottleneck) == script.layers(widths, bottleneck)
    assert roofline_forward.layers((4, 8), 16, num_classes=3, patch=64, in_ch=2) == script.layers(
        (4, 8), 16, num_classes=3, patch=64, in_ch=2)


@pytest.mark.parametrize("arch", ["default", "xl"])
def test_roofline_prints_the_h100_totals(arch, monkeypatch):
    """The port's lines against the script's own at the H100's peaks (its
    ``PEAK_FLOPS`` and ``PEAK_BW`` set to ``PEAKS[H100]``): the layer rows
    equal but for ``TC`` where the script prints ``MXU``, the totals equal
    at the script's precision (the port prints the floors to 3 decimals)."""
    script = jax_script("roofline_forward")
    peak = PEAKS[H100]
    monkeypatch.setattr(script, "PEAK_FLOPS", peak["bfloat16"])
    monkeypatch.setattr(script, "PEAK_BW", peak["hbm_bytes_per_s"])
    monkeypatch.setattr(sys, "argv", ["roofline_forward.py", "--arch", arch])
    want, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(want):
        script.main()
    with contextlib.redirect_stdout(out):
        assert roofline_forward.main(["--arch", arch]) == 0
    want, lines = want.getvalue().splitlines(), out.getvalue().splitlines()
    assert lines[0].startswith(f"peaks of {H100} (H100 SXM): 989 TFLOP/s dense bf16, 3.35 TB/s")
    n = len(roofline_forward.layers(*compare_archs.ARCHS[arch]))
    assert [ln.replace(" TC", "MXU") for ln in lines[1:2 + n]] == want[:1 + n]
    assert lines[2 + n:-2] == want[1 + n:-2] == [""]

    def numbers(line):
        return [float(x) for x in re.findall(r"\d+\.\d+", line)]

    got_total, want_total = numbers(lines[-2]), numbers(want[-2])
    assert len(got_total) == len(want_total) == 4
    assert [round(v, 2) for v in got_total[1:3]] == want_total[1:3]
    assert got_total[::3] == want_total[::3]  # GFLOP a patch and tiles/s
    assert lines[-1] == want[-1]


def test_peaks_are_read_from_one_table():
    assert bench.PEAK_BF16 == {H100: 989e12} and PEAKS[H100]["bfloat16"] == 989e12
    assert profile_layers.PEAK == {"bfloat16": 989e12, "float32": 67e12}
    assert PEAKS[H100]["hbm_bytes_per_s"] == 3.35e12
    assert (metaseg_unet.ENC_WIDTHS, metaseg_unet.BOTTLENECK) == compare_archs.ARCHS["default"]
