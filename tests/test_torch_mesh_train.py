"""The port's mesh train step (``runtime/train.train_step_on_mesh``) on a
(data 4, model 2) mesh of 8 CPU entries, at widths (8, 16), bottleneck 256
(so ``bott_1`` and ``bott_2`` are split over the model axis), 32^2 crops,
a batch of 8 of which 6 are valid; against the single-device
``train_step`` and the JAX package's ``jit_train_step_on_mesh`` on its
8-device virtual mesh of the same shape.

Tolerances, with their reasons:

- float32 loss: rtol 1e-6 against ``train_step`` and against JAX (the same
  float32 arithmetic, the rows' shares summed in another order);
- float32 gradients and SGD-step parameters: rtol 1e-6, atol 1e-7 against
  ``train_step`` (``tests/test_torch_train.py``'s bounds for
  ``train_step`` against JAX; each gradient element a sum over the batch
  in another order);
- bf16: the loss within one bf16 rounding (2^-8) and each gradient's
  relative L2 error within ``BF16_GRAD_TOL`` (``tests/test_torch_train.py``);
- remat against plain: the loss within rtol 1e-7, as the JAX test
  ``test_mesh_step_forwards_remat_and_masks_pads`` requires;
- the padded batch with its ``valid`` mask against the unpadded step: the
  bounds of ``test_zero_pads_with_valid_equal_the_unpadded_step``;
- Adam's moments after one step against the single-device optimizer's:
  the gradients' bounds scaled by (1 - beta);
- checkpoints: the layout round trip across mesh sizes and a resume on the
  same mesh are bit-equal; a resume on another mesh size within the
  float32 loss bound."""

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from ecseg_tpu.parallel.mesh import make_mesh as jmake_mesh
from ecseg_tpu.runtime.train import jit_train_step_on_mesh
from ecseg_torch.models.metaseg_unet import MetasegUNet
from ecseg_torch.models.weights import load_npz, params_from_numpy, params_to_numpy
from ecseg_torch.parallel.mesh import make_mesh
from ecseg_torch.pipelines import train_metaseg
from ecseg_torch.runtime import checkpoint as ckpt
from ecseg_torch.runtime import train as tt

from _meshutil import on_virtual_cpu_mesh, rerun_self_in_subprocess
from _torchutil import numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_train import BF16_GRAD_TOL, _training_folder

WIDTHS, BOTTLENECK = (8, 16), 256


def _mesh(devices=8, model_axis=2):
    return make_mesh(["cpu"] * devices, model_axis=model_axis)


def _tree(seed=0):
    return numpy_metaseg_tree(WIDTHS, BOTTLENECK, seed=seed)


def _batch(seed=0, n=8, n_valid=6):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 32, 32, 1)) * 255).astype(np.uint8)
    y = rng.integers(0, 4, (n, 32, 32)).astype(np.int32)
    x[n_valid:] = 0  # pad samples, as runtime/data.pad_to_multiple appends them
    y[n_valid:] = 0
    return x, y, np.arange(n) < n_valid


def _mesh_grads(step):
    """The summed gradients in the single-device layout (row 0's slots,
    split kernels concatenated)."""
    pieces = {}
    for name, _, p in step.model.slots(0):
        pieces.setdefault(name, []).append(p.grad)
    dims = step.model.shard_dims()
    return {n: torch.cat(g, dims.get(n, 0)) for n, g in pieces.items()}


def _sgd_pair(tree, x, y, valid, dtype=torch.float32, remat=False, mesh=None):
    """(single-device loss, model) and (mesh loss, step) after one SGD step."""
    ref = params_from_numpy(tree)
    l0 = tt.train_step(ref, torch.optim.SGD(ref.parameters(), lr=0.1), x, y, valid, dtype=dtype, remat=remat)
    m = params_from_numpy(tree)
    step = tt.train_step_on_mesh(mesh or _mesh(), m, 0.1, dtype=dtype, remat=remat, optimizer=torch.optim.SGD(m.parameters(), lr=0.1))
    return (float(l0), ref), (float(step(x, y, valid)), step)


def test_float32_step_matches_the_single_device_step():
    x, y, valid = _batch()
    (l0, ref), (l1, step) = _sgd_pair(_tree(), x, y, valid)
    assert step.model.shard_dims() == {"layers.bott_1.weight": 0, "layers.bott_2.weight": 0}
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    grads = _mesh_grads(step)
    for name, p in ref.named_parameters():
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
    for r in range(4):  # every row holds the summed gradient and steps on it
        for (name, _, p), (_, _, q) in zip(step.model.slots(r), step.model.slots(0)):
            assert torch.equal(p.grad, q.grad) and torch.equal(p, q), (r, name)
    for (name, a), (_, b) in zip(step.gather()[0].named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


def test_bf16_step_matches_the_single_device_step():
    x, y, valid = _batch(1)
    (l0, ref), (l1, step) = _sgd_pair(_tree(1), x, y, valid, dtype=torch.bfloat16)
    assert abs(l1 - l0) <= 2.0**-8 * abs(l0)
    grads = _mesh_grads(step)
    for name, p in ref.named_parameters():
        assert float((grads[name] - p.grad).norm() / p.grad.norm()) <= BF16_GRAD_TOL, name


def test_remat_equals_plain():
    x, y, valid = _batch(2)
    losses, params = [], []
    for remat in (False, True):
        m = params_from_numpy(_tree(2))
        step = tt.train_step_on_mesh(_mesh(), m, 1e-3, remat=remat)
        losses.append(float(step(x, y, valid)))
        params.append(params_to_numpy(step.gather()[0]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-7)
    for name in params[0]:
        for key in ("kernel", "bias"):
            np.testing.assert_allclose(params[1][name][key], params[0][name][key], rtol=1e-6, atol=1e-7, err_msg=name)


def test_zero_pads_with_valid_equal_the_unpadded_step():
    """3 real samples padded to 8 on the mesh against the unpadded 3 on one
    device."""
    x, y, valid = _batch(3, n_valid=3)
    ref = params_from_numpy(_tree(3))
    l0 = tt.train_step(ref, torch.optim.SGD(ref.parameters(), lr=0.1), x[:3], y[:3], np.ones(3, bool))
    m = params_from_numpy(_tree(3))
    step = tt.train_step_on_mesh(_mesh(), m, 0.1, optimizer=torch.optim.SGD(m.parameters(), lr=0.1))
    np.testing.assert_allclose(float(step(x, y, valid)), float(l0), rtol=1e-6)
    for (name, a), (_, b) in zip(step.gather()[0].named_parameters(), ref.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-7, err_msg=name)


def test_adam_moments_live_with_their_shards_and_gather_to_the_single_device_state():
    x, y, valid = _batch(4)
    ref = params_from_numpy(_tree(4))
    ref_opt = tt.make_optimizer(ref, 1e-3)
    tt.train_step(ref, ref_opt, x, y, valid)
    step = tt.train_step_on_mesh(_mesh(), params_from_numpy(_tree(4)), 1e-3)
    step(x, y, valid)
    assert len(step.optimizers) == 8  # one an entry: each holds a shard of bott_1 and bott_2
    for opt in step.optimizers:
        assert type(opt) is torch.optim.Adam and opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
        for p in opt.param_groups[0]["params"]:
            assert opt.state[p]["exp_avg"].shape == p.shape
    model, opt = step.gather()
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        got, want = opt.state[p], ref_opt.state[q]
        assert float(got["step"]) == float(want["step"]) == 1.0
        np.testing.assert_allclose(got["exp_avg"].numpy(), want["exp_avg"].numpy(), rtol=1e-6, atol=1e-8, err_msg=name)
        np.testing.assert_allclose(got["exp_avg_sq"].numpy(), want["exp_avg_sq"].numpy(), rtol=2e-6, atol=1e-12, err_msg=name)


def test_loss_matches_jax_mesh_step():
    """The loss of one step against ``jit_train_step_on_mesh`` on the JAX
    suite's (data 4, model 2) virtual mesh, from the same tree and batch."""
    if not on_virtual_cpu_mesh(8):
        rerun_self_in_subprocess(__file__, "test_loss_matches_jax_mesh_step")
        return
    x, y, valid = _batch(5)
    tree = _tree(5)
    jmesh = jmake_mesh(8, model_axis=2)
    params = jax.tree.map(jnp.asarray, tree)
    jstep, p_shard, b_shard, opt = jit_train_step_on_mesh(jmesh, optax.adam(1e-3), params_example=params)
    p = jax.device_put(params, p_shard)
    _, _, jloss = jstep(p, opt.init(p), jax.device_put(jnp.asarray(x), b_shard), jnp.asarray(y), jnp.asarray(valid))
    step = tt.train_step_on_mesh(_mesh(), params_from_numpy(tree), 1e-3)
    np.testing.assert_allclose(float(step(x, y, valid)), float(jloss), rtol=1e-6)


def test_steps_repeat_bit_for_bit():
    x, y, valid = _batch(6)
    runs = []
    for _ in range(2):
        step = tt.train_step_on_mesh(_mesh(), params_from_numpy(_tree(6)), 1e-3)
        losses = [step(x, y, valid) for _ in range(2)]
        runs.append((losses, list(step.gather()[0].parameters())))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_checkpoint_round_trip_across_mesh_sizes(tmp_path):
    """Two steps on (data 4, model 2), saved in the single-device layout:
    restored on one device, re-laid on (data 2, model 1) and (data 2,
    model 4) and gathered, the model and Adam's state are the saved ones bit
    for bit; the resumed (data 4, model 2) run's third step is bit-equal to
    the uninterrupted run's; on (data 2, model 1) its loss is within the
    float32 bound."""
    batches = [_batch(10 + k) for k in range(3)]
    step = tt.train_step_on_mesh(_mesh(), params_from_numpy(_tree(7)), 1e-3)
    for b in batches[:2]:
        step(*b)
    path = ckpt.save_checkpoint(str(tmp_path), 2, *step.gather())
    want_loss = float(step(*batches[2]))
    want_params = list(step.gather()[0].parameters())

    def restored():
        model = MetasegUNet(WIDTHS, BOTTLENECK, generator=torch.Generator().manual_seed(1))
        opt = tt.make_optimizer(model, 1e-3)
        assert ckpt.restore_checkpoint(path, model, opt) == 2
        return model, opt

    saved_model, saved_opt = restored()
    for devices, model_axis in ((2, 1), (8, 4)):
        model, opt = restored()
        again = tt.train_step_on_mesh(_mesh(devices, model_axis), model, 1e-3, optimizer=opt)
        m2, o2 = again.gather()
        for (name, a), b in zip(m2.named_parameters(), saved_model.parameters()):
            assert torch.equal(a, b), name
            sa, sb = o2.state[a], saved_opt.state[b]
            assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa), name

    model, opt = restored()
    resumed = tt.train_step_on_mesh(_mesh(), model, 1e-3, optimizer=opt)
    assert float(resumed(*batches[2])) == want_loss
    assert all(torch.equal(a, b) for a, b in zip(resumed.gather()[0].parameters(), want_params))
    model, opt = restored()
    other = tt.train_step_on_mesh(_mesh(2, 1), model, 1e-3, optimizer=opt)
    np.testing.assert_allclose(float(other(*batches[2])), want_loss, rtol=1e-6)


def test_command_line_over_two_cpu_entries(tmp_path, rng, capsys):
    """``train_metaseg.main`` over ``["cpu"] * 2`` with a batch of 3, padded
    to 4 for the data axis: the single-device command line's output lines,
    checkpoint and exported tree, the same losses as the single-device run
    to the printed digits and the same weights within the float32 step
    bound."""
    folder = _training_folder(tmp_path / "data", rng)
    outs = {}
    for tag, kw in (("one", {"device": "cpu"}), ("mesh", {"devices": ["cpu"] * 2})):
        out = tmp_path / tag / "metaseg.npz"
        argv = ["--inpath", str(folder), "--steps", "3", "--batch", "3", "--widths", "8", "16", "--bottleneck", "32",
                "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / tag / "ckpt"), "--out", str(out)]
        assert train_metaseg.main(argv, **kw) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == "2 training images" and lines[-1] == f"exported weights: {out}"
        assert f"checkpoint: {tmp_path / tag / 'ckpt' / 'step_00000002.pt'}" in lines
        outs[tag] = ([ln for ln in lines if ln.startswith("step ")], load_npz(str(out)))
    assert outs["mesh"][0] == outs["one"][0] and len(outs["mesh"][0]) == 2
    for name, leaves in outs["one"][1].items():
        for key, want in leaves.items():
            got = outs["mesh"][1][name][key]
            assert got.shape == want.shape and got.dtype == want.dtype, (name, key)
            # three Adam steps from the same weights and crops: the float32
            # step bound (observed: 3e-8 at most)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f"{name}/{key}")
