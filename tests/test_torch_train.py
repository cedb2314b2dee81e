"""The port's metaseg trainer (``ecseg_torch/runtime/train.py``,
``runtime/checkpoint.py``, the Adam state bridge of ``models/weights.py``
and ``python -m ecseg_torch.pipelines.train_metaseg``) against the JAX
package's (``ecseg_tpu/runtime/train.py``, ``optax.adam``,
``scripts/train_metaseg.py``'s export), at widths (8, 16), bottleneck 32,
on 32^2 crops; weights from a seeded numpy tree through the bridge.

Tolerances, each with its reason:

- float32 loss: rtol 1e-6 (the same float32 arithmetic, convolutions
  summed in another order; measured 3e-7);
- float32 gradients: max |diff| <= ``F32_GRAD_TOL`` x max |g| per tensor
  (each element a sum over N*H*W*k^2 products in another order; measured
  1.2e-6);
- bf16 (``dtype=torch.bfloat16`` on float32 weights): the loss within one
  bf16 rounding, 2^-8, of JAX's bf16 loss.  Gradients: relative L2 error
  per tensor within ``BF16_GRAD_TOL`` = 4 L 2^-8 for the L convolution
  layers, since each layer rounds its conv output and its bias sum on the
  way forward and its input and weight cotangents on the way back, each
  rounding up to 2^-8 relative: the kernels' gradients against JAX's bf16
  gradients; and every gradient no farther than JAX's bf16 gradient from
  the float32 gradient (what both bf16 computations estimate), give or
  take the same bound.  JAX's bf16 bias gradients are not compared with
  the port's directly: XLA sums a bias's N*H*W bf16 cotangents into a bf16
  result (``reduce_sum`` to ``bf16[C]`` in the jaxpr), which puts them up
  to a third of their norm away from the float32 gradient at the head,
  where PyTorch accumulates in float32 and rounds once; bias gradients
  cancel heavily over the pixels, and reach 0.2-0.7 of their norm from
  the float32 gradient in both packages at these widths;
- Adam against optax over 3 updates on identical gradients: both against
  optax's formula in float64, torch within 1e-6 and optax within 1e-5 of
  each element's update scale (optax forms ``1 - 0.999^t`` in float32; see
  the test), the moments within rtol 1e-6;
- a whole step against JAX's with SGD, whose update is linear in the
  gradient (``tests/test_parallel.py:218-220``: Adam's step-1 update
  normalizes the gradient and amplifies reduction-order noise): rtol 1e-6,
  atol 1e-7, the JAX test's;
- remat against plain and padded + ``valid`` against unpadded: the JAX
  tests' tolerances (``tests/test_parallel.py:174-246``); resume against
  uninterrupted training: bit-equal.
"""

import copy
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ecseg_tpu.pipelines import metaseg as jax_metaseg
from ecseg_tpu.runtime import train as jt
from ecseg_torch.models.metaseg_unet import MetasegUNet
from ecseg_torch.models.weights import (
    adam_state_from_numpy, adam_state_to_numpy, load_npz, params_from_numpy, params_to_numpy,
)
from ecseg_torch.pipelines import metaseg as port_metaseg
from ecseg_torch.pipelines import train_metaseg
from ecseg_torch.runtime import checkpoint as ckpt
from ecseg_torch.runtime import train as tt

from _torchutil import numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)

WIDTHS, BOTTLENECK = (8, 16), 32
N_LAYERS = 5 * len(WIDTHS) + 3  # enc 2 a level, bott 2, up + dec 2 a level, head
F32_GRAD_TOL = 1e-5
BF16_GRAD_TOL = 4 * N_LAYERS * 2.0**-8

_JAX_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(jt.softmax_xent_loss), static_argnums=(3, 4))


def _tree(seed):
    return numpy_metaseg_tree(WIDTHS, BOTTLENECK, seed=seed)


def _batch(seed, n=3, size=32, lo=0, hi=4):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, size, size, 1)) * 255).astype(np.uint8)
    y = rng.integers(lo, hi, (n, size, size)).astype(np.int32)
    return x, y


def _grad_tree(model):
    """The model's gradients as a parameter tree in the JAX layout."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return params_to_numpy(g)


def _port_loss_and_grads(tree, x, y, dtype=torch.float32, valid=None, remat=False):
    model = params_from_numpy(tree)
    v = None if valid is None else torch.from_numpy(valid)
    loss = tt.softmax_xent_loss(model, torch.from_numpy(x), torch.from_numpy(y), dtype=dtype, remat=remat, valid=v)
    loss.backward()
    return float(loss.detach()), _grad_tree(model)


def _jax_loss_and_grads(tree, x, y, dtype=jnp.float32, valid=None):
    v = None if valid is None else jnp.asarray(valid)
    loss, g = _JAX_VALUE_AND_GRAD(tree, jnp.asarray(x), jnp.asarray(y), dtype, False, v)
    return float(loss), jax.tree.map(np.asarray, g)


def _leaves(tree):
    return [(f"{name}/{key}", tree[name][key]) for name in sorted(tree) for key in ("kernel", "bias")]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f32_cases():
    x, y = _batch(0)
    xo, yo = _batch(1, lo=-1, hi=5)
    assert (yo == -1).any() and (yo == 4).any()
    xp = np.concatenate([x, np.zeros((2,) + x.shape[1:], np.uint8)])
    yp = np.concatenate([y, np.zeros((2,) + y.shape[1:], np.int32)])
    return {
        "plain": (x, y, None),
        "labels_outside_0_4": (xo, yo, None),
        "valid_mask": (x, y, np.array([True, False, True])),
        "zero_pads_masked": (xp, yp, np.arange(5) < 3),
        "labels_outside_0_4_masked": (xo, yo, np.array([False, True, True])),
    }


@pytest.mark.parametrize("case", sorted(_f32_cases()))
def test_float32_loss_and_grads_match_jax(case):
    x, y, valid = _f32_cases()[case]
    tree = _tree(0)
    lt, gt = _port_loss_and_grads(tree, x, y, valid=valid)
    lj, gj = _jax_loss_and_grads(tree, x, y, valid=valid)
    np.testing.assert_allclose(lt, lj, rtol=1e-6)
    for (name, a), (_, b) in zip(_leaves(gt), _leaves(gj)):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= F32_GRAD_TOL, (name, err)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_loss_and_grads_match_jax(seed):
    x, y = _batch(seed + 10, lo=-1, hi=5)
    tree = _tree(seed)
    lt, gt = _port_loss_and_grads(tree, x, y, dtype=torch.bfloat16)
    lj, gj = _jax_loss_and_grads(tree, x, y, dtype=jnp.bfloat16)
    _, g32 = _jax_loss_and_grads(tree, x, y)
    assert abs(lt - lj) <= 2.0**-8 * abs(lj)
    for (name, a), (_, b), (_, c) in zip(_leaves(gt), _leaves(gj), _leaves(g32)):
        assert a.dtype == np.float32, name
        # no farther from the float32 gradient than JAX's bf16 gradient is,
        # give or take the bound
        assert _rel_l2(a, c) <= _rel_l2(b, c) + BF16_GRAD_TOL, (name, _rel_l2(a, c), _rel_l2(b, c))
        if name.endswith("kernel"):
            assert _rel_l2(a, b) <= BF16_GRAD_TOL, (name, "vs JAX bf16", _rel_l2(a, b))


@pytest.mark.parametrize("split", ["0", "1"])
def test_bf16_compute_on_float32_weights_is_the_bf16_model(monkeypatch, split):
    """``forward(x, dtype=bf16)`` on float32 weights computes what the bf16
    module (serving's ``.to(torch.bfloat16)``) computes, bit for bit: the
    kernels and biases round to bf16 once either way."""
    monkeypatch.setenv("ECSEG_SPLIT_CONCAT", split)
    model = params_from_numpy(_tree(2))
    x = torch.from_numpy(_batch(2, n=2, size=64)[0])
    with torch.no_grad():
        got = model(x, dtype=torch.bfloat16)
        want = copy.deepcopy(model).to(torch.bfloat16)(x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def _optax_state(count, mu, nu):
    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return (optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32), mu=to_j(mu), nu=to_j(nu)), optax.EmptyState())


def _adam_float64(params, mu, nu, grads, count, lr):
    """optax.adam's formula in float64 (the exact update both optimizers
    round): per step ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2)
    g^2``, ``p -= lr mu_hat / (sqrt(nu_hat) + eps)``.  Also returns the sum
    of the steps' update scales without the moments' cancellation,
    ``lr (b1 |mu| + (1 - b1) |g|) / (1 - b1^t) / (sqrt(nu_hat) + eps)``,
    against which a float32 implementation's rounding is measured."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    p, m, v = f64(params), f64(mu), f64(nu)
    scale = jax.tree.map(np.zeros_like, p)
    for t, g in enumerate(f64(grads), start=count + 1):
        denom = lambda vv: np.sqrt(b2 * vv[0] + (1 - b2) * vv[1] ** 2) / np.sqrt(1 - b2**t) + eps  # noqa: E731
        scale = jax.tree.map(lambda s, mm, gg, vv: s + lr * (b1 * np.abs(mm) + (1 - b1) * np.abs(gg)) / (1 - b1**t) / denom((vv, gg)), scale, m, g, v)
        m = jax.tree.map(lambda mm, gg: b1 * mm + (1 - b1) * gg, m, g)
        v = jax.tree.map(lambda vv, gg: b2 * vv + (1 - b2) * gg**2, v, g)
        p = jax.tree.map(lambda pp, mm, vv: pp - lr * (mm / (1 - b1**t)) / (np.sqrt(vv / (1 - b2**t)) + eps), p, m, v)
    return p, m, v, scale


def test_adam_matches_optax_from_a_carried_state():
    """Both optimizers from one carried state (the bridge), 3 updates on
    identical gradients, held against optax's formula in float64: torch's
    within ``1e-6`` of each element's update scale (a few float32 roundings),
    optax's within ``1e-5`` (it forms ``1 - 0.999^t`` in float32, which
    loses digits to cancellation at small ``t``: 2^-24 / (1 - 0.999^5) is
    1.2e-5 relative; measured 2.5e-7 and 8e-6).  Parameters start at 0, so
    a parameter is the sum of its updates and its rounding is the
    updates'."""
    rng = np.random.default_rng(3)
    p0 = jax.tree.map(np.zeros_like, _tree(3))
    mu = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2).astype(np.float32), p0)
    nu = jax.tree.map(lambda a: (rng.random(a.shape) * 1e-4).astype(np.float32), p0)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32), p0) for _ in range(3)]

    model = params_from_numpy(p0)
    opt = tt.make_optimizer(model, 1e-3)
    adam_state_from_numpy(model, opt, _optax_state(4, mu, nu))
    count, mu_rt, nu_rt = adam_state_to_numpy(model, opt)  # the bridge round-trips exactly
    assert count == 4
    for (_, a), (_, b) in zip(_leaves(mu_rt) + _leaves(nu_rt), _leaves(mu) + _leaves(nu)):
        np.testing.assert_array_equal(a, b)

    ox = optax.adam(1e-3)
    update = jax.jit(ox.update)
    params, state = jax.tree.map(jnp.asarray, p0), _optax_state(4, mu, nu)
    for g in grads:
        for p, q in zip(model.parameters(), params_from_numpy(g).parameters()):
            p.grad = q.detach().clone()
        opt.step()
        updates, state = update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    p64, m64, v64, scale = _adam_float64(p0, mu, nu, grads, 4, 1e-3)
    count, mu_t, nu_t = adam_state_to_numpy(model, opt)
    assert count == int(state[0].count) == 7
    leaves = zip(_leaves(params_to_numpy(model)), _leaves(jax.tree.map(np.asarray, params)), _leaves(p64), _leaves(scale))
    for (name, pt), (_, po), (_, pe), (_, sc) in leaves:
        assert (np.abs(pt - pe) <= 1e-6 * sc).all(), (name, "torch", (np.abs(pt - pe) / sc).max())
        assert (np.abs(po - pe) <= 1e-5 * sc).all(), (name, "optax", (np.abs(po - pe) / sc).max())
    for got, want, exact in ((mu_t, state[0].mu, m64), (nu_t, state[0].nu, v64)):
        for (name, a), (_, b), (_, e) in zip(_leaves(got), _leaves(jax.tree.map(np.asarray, want)), _leaves(exact)):
            # moments: a few float32 roundings of their largest term
            np.testing.assert_allclose(a, e, rtol=1e-6, atol=1e-6 * np.abs(e).max(), err_msg=name)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(e).max(), err_msg=name)


def test_sgd_step_matches_jax_step():
    """``train_step`` (float32, zero pads masked by ``valid``) against JAX's
    ``make_train_step`` with the same optimizer, SGD."""
    x, y, valid = _f32_cases()["zero_pads_masked"]
    tree = _tree(4)
    model = params_from_numpy(tree)
    loss = tt.train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), x, y, valid)
    sgd = optax.sgd(0.1)
    params = jax.tree.map(jnp.asarray, tree)
    p1, _, l1 = jax.jit(jt.make_train_step(sgd))(params, sgd.init(params), jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid))
    np.testing.assert_allclose(float(loss), float(l1), rtol=1e-6)
    for (name, a), (_, b) in zip(_leaves(params_to_numpy(model)), _leaves(jax.tree.map(np.asarray, p1))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)


def test_remat_step_matches_plain():
    x, y = _batch(5, n=2)
    out = []
    for remat in (False, True):
        model = params_from_numpy(_tree(5))
        loss = tt.train_step(model, tt.make_optimizer(model, 1e-3), x, y, remat=remat)
        out.append((float(loss), params_to_numpy(model)))
    (l0, p0), (l1, p1) = out
    np.testing.assert_allclose(l0, l1, rtol=1e-7)
    for (name, a), (_, b) in zip(_leaves(p0), _leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=name)


def test_zero_pads_with_valid_equal_the_unpadded_step():
    x, y = _batch(6)
    xp = np.concatenate([x, np.zeros((5,) + x.shape[1:], np.uint8)])
    yp = np.concatenate([y, np.zeros((5,) + y.shape[1:], np.int32)])
    out = []
    for bx, by, v in ((x, y, np.ones(3, bool)), (xp, yp, np.arange(8) < 3)):
        model = params_from_numpy(_tree(6))
        loss = tt.train_step(model, torch.optim.SGD(model.parameters(), lr=0.1), bx, by, v)
        out.append((float(loss), params_to_numpy(model)))
    (l0, p0), (l1, p1) = out
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    for (name, a), (_, b) in zip(_leaves(p0), _leaves(p1)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7, err_msg=name)


def test_loss_decreases_over_five_steps():
    x, y = _batch(7, n=4)
    y[:, 8:24, 8:24] = 1
    model = params_from_numpy(_tree(7))
    opt = tt.make_optimizer(model, 1e-3)
    losses = [float(tt.train_step(model, opt, x, y)) for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def _fresh(seed=8):
    model = params_from_numpy(_tree(seed))
    return model, tt.make_optimizer(model, 1e-3)


def test_checkpoint_round_trip_latest_and_temp_files(tmp_path):
    d = str(tmp_path / "ckpt")
    assert ckpt.latest_checkpoint(d) is None
    model, opt = _fresh()
    x, y = _batch(8, n=2)
    for step in (1, 2, 3):
        tt.train_step(model, opt, x, y)
        path = ckpt.save_checkpoint(d, step, model, opt)
        assert os.path.basename(path) == f"step_{step:08d}.pt"
    assert ckpt.save_checkpoint(d, 3, model, opt) == path  # a step saved again is overwritten
    (tmp_path / "ckpt" / "step_00000009.pt.tmp").write_bytes(b"partial")  # a crashed save
    (tmp_path / "ckpt" / "notes.txt").write_text("x")
    assert ckpt.latest_checkpoint(d) == path
    assert sorted(os.listdir(d)) == ["notes.txt", "step_00000001.pt", "step_00000002.pt", "step_00000003.pt", "step_00000009.pt.tmp"]
    model2, opt2 = _fresh(seed=9)
    assert ckpt.restore_checkpoint(path, model2, opt2) == 3
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
    c1, mu1, nu1 = adam_state_to_numpy(model, opt)
    c2, mu2, nu2 = adam_state_to_numpy(model2, opt2)
    assert c1 == c2 == 3
    for (_, a), (_, b) in zip(_leaves(mu1) + _leaves(nu1), _leaves(mu2) + _leaves(nu2)):
        np.testing.assert_array_equal(a, b)


def test_resume_is_bit_equal_to_uninterrupted_training(tmp_path):
    batches = [_batch(20 + k, n=2) for k in range(4)]
    model, opt = _fresh()
    for x, y in batches:
        tt.train_step(model, opt, x, y)
    first, first_opt = _fresh()
    for x, y in batches[:2]:
        tt.train_step(first, first_opt, x, y)
    path = ckpt.save_checkpoint(str(tmp_path), 2, first, first_opt)
    resumed = MetasegUNet(WIDTHS, BOTTLENECK, generator=torch.Generator().manual_seed(1))
    resumed_opt = tt.make_optimizer(resumed, 1e-3)
    assert ckpt.restore_checkpoint(path, resumed, resumed_opt) == 2
    for x, y in batches[2:]:
        tt.train_step(resumed, resumed_opt, x, y)
    for a, b in zip(model.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


def _training_folder(d, rng):
    """tests/test_training_e2e.py's folder: two 300x330 uint16 images."""
    (d / "labels").mkdir(parents=True)
    for k in range(2):
        img = (rng.random((300, 330)) * 4000).astype(np.uint16)
        img[60:200, 80:260] = 52000
        assert cv2.imwrite(str(d / f"t{k}.tif"), img)
        lab = np.zeros((300, 330), np.int64)
        lab[60:200, 80:260] = 1
        np.save(str(d / "labels" / f"t{k}.npy"), lab)
    return d


def test_command_line_trains_checkpoints_and_exports_for_both_packages(tmp_path, rng, capsys):
    folder = _training_folder(tmp_path / "data", rng)
    out = tmp_path / "models" / "metaseg.npz"
    argv = ["--inpath", str(folder), "--steps", "3", "--batch", "4", "--widths", "8", "16", "--bottleneck", "32",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(out)]
    assert train_metaseg.main(argv, device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "2 training images"
    losses = [float(ln.split()[-1]) for ln in lines if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines if ln.startswith("step ")] == ["0", "2"] and all(np.isfinite(losses))
    assert f"checkpoint: {tmp_path / 'ckpt' / 'step_00000002.pt'}" in lines
    assert lines[-1] == f"exported weights: {out}"
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000002.pt"]

    tree = load_npz(str(out))
    assert tree["enc1_1"]["kernel"].shape == (3, 3, 1, 8) and tree["head"]["kernel"].shape == (1, 1, 8, 4)
    port_model = port_metaseg.load_model(str(out.parent), device="cpu")
    image = str(folder / "t0.tif")
    patches, pos = port_metaseg._prepare_image(image, save_dapi=False)
    got, _, _ = port_metaseg.post_process(port_metaseg.segment_raw(port_model, patches, pos))
    want = jax_metaseg.meta_segment(jax_metaseg.load_model(str(out.parent)), image, save_dapi=False)
    assert got.shape == want.shape == (300, 330)
    np.testing.assert_array_equal(got, want)


def test_command_line_exits_2_on_a_folder_without_pairs(tmp_path, capsys):
    (tmp_path / "labels").mkdir()
    cv2.imwrite(str(tmp_path / "x.tif"), np.zeros((300, 300), np.uint8))  # no labels/x.npy
    assert train_metaseg.main(["--inpath", str(tmp_path)], device="cpu") == 2
    assert capsys.readouterr().out.strip() == f"no (image, labels/) training pairs under {tmp_path}"


def test_command_line_without_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_metaseg.main(["--inpath", str(tmp_path)])
