"""The port's (data, model) mesh (``ecseg_torch/parallel/mesh.py``) against
``ecseg_tpu.parallel.mesh`` on the JAX suite's 8-device virtual CPU mesh:
shapes, errors and the set of split kernels for the same parameter tree;
the device lists of ``ecseg_torch/device.py``; and the layout of a
``MetasegUNet`` on a mesh (``runtime/train.shard_params`` /
``gather_params``, ``ShardedConv``) against the plain layers."""

import copy

import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from ecseg_tpu.parallel import mesh as jmesh
from ecseg_torch.device import entry_devices, resolve_devices
from ecseg_torch.models.layers import SameConv2d, TFConvTranspose2d
from ecseg_torch.models.metaseg_unet import MetasegUNet
from ecseg_torch.models.weights import params_from_numpy
from ecseg_torch.parallel import mesh as tmesh
from ecseg_torch.runtime import train as tt

from _meshutil import on_virtual_cpu_mesh, rerun_self_in_subprocess
from _torchutil import numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)

CPU8 = ["cpu"] * 8
ARCHS = {"default": ((32, 64, 128, 256), 512), "xl": ((64, 128, 256, 512), 1024), "narrow_wide_bottleneck": ((8, 16), 256), "narrow": ((8, 16), 32)}


def _mesh_test(name):
    if on_virtual_cpu_mesh(8):
        return True
    rerun_self_in_subprocess(__file__, name)
    return False


def test_make_mesh_shapes_match_jax():
    if not _mesh_test("test_make_mesh_shapes_match_jax"):
        return
    for n, model_axis in ((8, 2), (8, 1), (8, 4), (4, 2), (6, 3)):
        got = tmesh.make_mesh(CPU8, n, model_axis)
        assert got.shape == dict(jmesh.make_mesh(n, model_axis).shape)
        assert len(got.flat()) == n and all(d == torch.device("cpu") for d in got.flat())
    assert tmesh.make_mesh(CPU8).shape == dict(jmesh.make_mesh().shape) == {"data": 8, "model": 1}


def test_make_mesh_rows_follow_the_device_list():
    devs = [f"cuda:{k}" for k in range(4)]
    mesh = tmesh.make_mesh(devs, model_axis=2)
    assert mesh.devices == ((torch.device("cuda:0"), torch.device("cuda:1")), (torch.device("cuda:2"), torch.device("cuda:3")))


@pytest.mark.parametrize("n,model_axis,match", [(512, 1, "needs 512 devices"), (8, 3, "8 devices not divisible by model axis 3")])
def test_make_mesh_errors_match_jax(n, model_axis, match):
    with pytest.raises(ValueError, match=match):
        jmesh.make_mesh(n, model_axis)
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh(CPU8, n, model_axis)


def test_device_lists():
    assert resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert entry_devices("cpu") == [torch.device("cpu")]
    assert entry_devices(devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="not both"):
        entry_devices("cpu", ["cpu"])
    with pytest.raises(ValueError, match="empty"):
        resolve_devices([])
    if not torch.cuda.is_available():
        for fn in (resolve_devices, entry_devices, tmesh.make_mesh):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()


@pytest.mark.parametrize("model_axis", [1, 2, 4])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_split_kernels_match_jax_param_shardings(arch, model_axis):
    """The kernels the rule splits over the model axis are those the JAX
    rule shards, on the same tree; the split dim holds the out-channels."""
    if not _mesh_test(f"test_split_kernels_match_jax_param_shardings[{arch}-{model_axis}]"):
        return
    widths, bottleneck = ARCHS[arch]
    tree = numpy_metaseg_tree(widths, bottleneck)
    jspecs = jmesh.param_shardings(tree, jmesh.make_mesh(8, model_axis))
    want = {name for name, leaves in jspecs.items() if leaves["kernel"].spec == P(None, None, None, "model")}
    assert all(leaves["bias"].spec == P() for leaves in jspecs.values())
    model = params_from_numpy(tree)
    dims = tmesh.param_shardings(model, tmesh.make_mesh(CPU8, 8, model_axis))
    assert {k.split(".")[1] for k, d in dims.items() if d is not None} == want
    for key, d in dims.items():
        if d is not None:
            name = key.split(".")[1]
            assert key.endswith(".weight") and model.get_parameter(key).shape[d] == tree[name]["kernel"].shape[-1]
            assert d == (1 if name.startswith("up") else 0)
    if arch == "default" and model_axis == 2:
        assert want == {"enc4_1", "enc4_2", "bott_1", "bott_2", "up4", "dec4_1", "dec4_2"}


@pytest.mark.parametrize("model_axis", [1, 2])
def test_shard_and_gather_round_trip_is_exact(model_axis):
    """Default widths on (data 2, model 2): every row a replica, the wide
    kernels (a transpose conv's among them) split on the out-channels, and
    gathering gives the model back bit for bit, at any mesh size."""
    model = MetasegUNet(generator=torch.Generator().manual_seed(3))
    mesh = tmesh.make_mesh(["cpu"] * (2 * model_axis), model_axis=model_axis)
    on_mesh = tt.shard_params(model, mesh)
    assert len(on_mesh.replicas) == 2
    split = on_mesh.shard_dims()
    assert split == ({} if model_axis == 1 else {f"layers.{n}.weight": int(n == "up4") for n in ("enc4_1", "enc4_2", "bott_1", "bott_2", "up4", "dec4_1", "dec4_2")})
    for r in range(2):
        slots = on_mesh.slots(r)
        assert [n for n, k, _ in slots if k == 0] == [n for n, _ in model.named_parameters()]
        assert sum(k > 0 for _, k, _ in slots) == len(split) * (model_axis - 1)
    back = tt.gather_params(on_mesh)
    assert type(back) is MetasegUNet
    for (n, a), (m, b) in zip(back.named_parameters(), model.named_parameters()):
        assert n == m and torch.equal(a, b), n
    assert [type(l) for l in back.layers.values()] == [type(l) for l in model.layers.values()]


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "transpose_conv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_conv_equals_the_plain_layer(transpose, dtype):
    """A 256-out-channel layer split over two entries: the forward (float32:
    ``forward``, bf16: ``forward_bias_after``) and the gradients equal the
    plain layer's within float32 (bf16) rounding."""
    torch.manual_seed(0)
    layer = TFConvTranspose2d(32, 256) if transpose else SameConv2d(32, 256, 3)
    with torch.no_grad():
        layer.bias.uniform_(-0.1, 0.1)
    sharded = tt.ShardedConv(copy.deepcopy(layer), [torch.device("cpu")] * 2, 1 if transpose else 0)
    x = torch.randn(2, 32, 8, 8)
    outs = []
    for m in (layer, sharded):
        xi = x.clone().to(dtype).requires_grad_(True)
        y = m(xi) if dtype == torch.float32 else m.forward_bias_after(xi)
        (y.float() ** 2).sum().backward()
        outs.append((y.float(), xi.grad.float(), m.weight.grad if m is layer else torch.cat([w.grad for w in m.shards], m.dim), m.bias.grad))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else dict(rtol=2**-7, atol=2**-7)
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), **tol)
    assert torch.equal(sharded.weight, layer.weight)


def test_split_batch():
    assert tmesh.split_batch(8, 4) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="pad it"):
        tmesh.split_batch(6, 4)
