"""Training of the metaseg U-Net on one card (twin of
``ecseg_tpu/runtime/train.py:26-76``).

The loss keeps the JAX package's arithmetic: the log of the clamped softmax
probabilities, a one-hot built by comparison (a label outside [0, C) gives
a zero row, so its pixel adds 0 and still counts in the mean), and with a
``valid`` mask the per-sample means weighted by it.  The step is autograd
through :class:`~ecseg_torch.models.metaseg_unet.MetasegUNet` (cuDNN's
convolutions and their gradients; no hand kernel lies on this path) and
``torch.optim.Adam`` with optax's defaults in place of ``optax.adam``.

In float32 the forward and the backward both run under
``layers.parity_flags`` (the JAX package computes both at
``Precision.HIGHEST``): autograd runs the backward after the forward's own
flags have been left, and PyTorch's default lets cuDNN use TF32 there.
``dtype=torch.bfloat16`` computes in bf16 on the float32 weights, which
stay the optimizer's master copy, as the JAX package's ``--bf16`` does.

:func:`train_step_on_mesh` is the counterpart of
``jit_train_step_on_mesh`` (``ecseg_tpu/runtime/train.py:79-112``) over a
``parallel/mesh.Mesh``: the batch split over the data axis, one replica of
the model a data row, its wide kernels split on their out-channels over the
row's model entries (``parallel/mesh.leaf_sharding_rule``), the gradients
summed over the data axis in row order, one optimizer a mesh entry over the
parameters and shards that live there.  :func:`gather_params` and
:func:`shard_params` carry a model between the single-device layout
(checkpoints, the exported ``.npz``) and the mesh.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import copy
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, pin_thread
from ..models.layers import add_bias, parity_flags
from ..models.metaseg_unet import MetasegUNet
from ..parallel.mesh import Mesh, leaf_sharding_rule, split_batch


def softmax_xent_loss(
    model: MetasegUNet,
    x: torch.Tensor,
    y: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean pixel cross-entropy of (N, H, W, 1) uint8 patches ``x`` against
    (N, H, W) integer labels ``y``.

    ``valid``: an optional (N,) bool mask that keeps pad samples (zeros
    appended by ``data.pad_to_multiple``) out of the loss and its gradient.
    ``remat=True`` recomputes the forward's activations during the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps the whole
    forward): less memory, about a third more convolution work, the same
    gradients."""
    xent = pixel_xent(model, x, y, dtype, remat)
    if valid is None:
        return xent.mean()
    per_sample = xent.mean(dim=(1, 2))
    vm = valid.to(per_sample.dtype)
    return (per_sample * vm).sum() / torch.clamp(vm.sum(), min=1.0)


def pixel_xent(model: nn.Module, x: torch.Tensor, y: torch.Tensor, dtype: torch.dtype, remat: bool) -> torch.Tensor:
    """The (N, H, W) pixel cross-entropies of :func:`softmax_xent_loss`."""
    if remat:
        probs = checkpoint(lambda inp: model(inp, dtype=dtype), x, use_reentrant=False)
    else:
        probs = model(x, dtype=dtype)
    logp = torch.log(torch.clamp(probs, min=1e-12))
    onehot = (y[..., None] == torch.arange(probs.shape[-1], device=y.device)).to(logp.dtype)
    return -(onehot * logp).sum(dim=-1)


def make_optimizer(model: MetasegUNet, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s counterpart: betas 0.9 / 0.999, eps 1e-8, no
    weight decay, no amsgrad.  The update formula is optax's; only the
    order of its roundings differs."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, amsgrad=False)


def train_step(
    model: MetasegUNet,
    optimizer: torch.optim.Optimizer,
    x,
    y,
    valid=None,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
) -> torch.Tensor:
    """One optimizer step on uint8 NHWC crops ``x`` and int32 labels ``y``
    (numpy arrays or tensors, moved to the model's device); steps the model
    in place and returns the loss, a scalar tensor on the device (reading
    it waits for the step)."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if valid is not None:
        valid = torch.as_tensor(valid).to(dev)
    optimizer.zero_grad(set_to_none=True)
    with parity_flags() if dtype == torch.float32 else contextlib.nullcontext():
        loss = softmax_xent_loss(model, x, y, dtype=dtype, remat=remat, valid=valid)
        loss.backward()
    optimizer.step()
    return loss.detach()


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------


class ShardedConv(nn.Module):
    """A wide convolution of one data row: its kernel split on the
    out-channels (dim ``dim``) over the row's model entries, shard ``k`` on
    ``devices[k]``, and its bias (replicated by the rule) on the row's first
    entry.  Each shard's convolution runs on its entry and the outputs are
    concatenated back onto the first entry; autograd carries the gradients
    the other way.  The forwards keep the plain layer's arithmetic per
    output channel: float32 adds each shard's bias slice in the convolution,
    as ``nn.Conv2d`` does, and ``forward_bias_after`` (bf16) adds the bias
    after the rounding (``layers.add_bias``)."""

    def __init__(self, layer: nn.Module, devices, dim: int):
        super().__init__()
        self.kind = type(layer)
        self.transpose = isinstance(layer, nn.ConvTranspose2d)
        self.stride = layer.stride[0]
        self.devices = list(devices)
        self.dim = dim
        with torch.no_grad():
            self.shards = nn.ParameterList(
                nn.Parameter(w.to(d, copy=True)) for w, d in zip(layer.weight.chunk(len(devices), dim), self.devices)
            )
            self.bias = nn.Parameter(layer.bias.to(self.devices[0], copy=True))

    def _conv(self, x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
        if self.transpose:  # layers.TFConvTranspose2d: the FULL transpose conv truncated to stride x input
            y = F.conv_transpose2d(x, w, b, self.stride)
            return y[..., : x.shape[-2] * self.stride, : x.shape[-1] * self.stride]
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def _gather(self, ys: List[torch.Tensor]) -> torch.Tensor:
        return torch.cat([y.to(self.devices[0]) for y in ys], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bs = self.bias.chunk(len(self.devices))
        return self._gather([self._conv(x.to(d), w, b.to(d)) for d, w, b in zip(self.devices, self.shards, bs)])

    def forward_bias_after(self, x: torch.Tensor) -> torch.Tensor:
        ys = [self._conv(x.to(d), w.to(x.dtype), None) for d, w in zip(self.devices, self.shards)]
        return add_bias(self._gather(ys), self.bias)

    @property
    def weight(self) -> torch.Tensor:
        """The whole kernel on the first entry (``MetasegUNet._dec_first``,
        bf16 under ``ECSEG_SPLIT_CONCAT``, reads its input-channel halves)."""
        return torch.cat([w.to(self.devices[0]) for w in self.shards], dim=self.dim)

    def gathered(self, device: torch.device) -> nn.Module:
        """The plain layer on ``device``."""
        w = self.weight.detach().to(device)
        cin, cout = (w.shape[0], w.shape[1]) if self.transpose else (w.shape[1], w.shape[0])
        layer = self.kind(cin, cout, w.shape[-1], self.stride) if self.transpose else self.kind(cin, cout, w.shape[-1])
        with torch.no_grad():
            layer.weight.copy_(w)
            layer.bias.copy_(self.bias.detach().to(device))
        return layer.to(device)


class MeshUNet:
    """A ``MetasegUNet`` laid out on a mesh: ``replicas[r]`` is data row
    ``r``'s copy, on the row's first entry, with every layer the rule
    selects replaced by a :class:`ShardedConv` over the row's entries."""

    def __init__(self, mesh: Mesh, replicas: List[MetasegUNet]):
        self.mesh = mesh
        self.replicas = replicas

    def slots(self, r: int) -> List[Tuple[str, int, nn.Parameter]]:
        """Row ``r``'s parameters in ``MetasegUNet.named_parameters()``
        order, each as (name, shard, parameter): shard ``k`` of a split
        kernel lives on the row's entry ``k``, everything else on entry 0."""
        out = []
        for name, layer in self.replicas[r].layers.items():
            key = f"layers.{name}"
            if isinstance(layer, ShardedConv):
                out += [(f"{key}.weight", k, w) for k, w in enumerate(layer.shards)]
            else:
                out.append((f"{key}.weight", 0, layer.weight))
            out.append((f"{key}.bias", 0, layer.bias))
        return out

    def shard_dims(self) -> Dict[str, int]:
        """Name -> split dim of each split kernel."""
        return {f"layers.{n}.weight": l.dim for n, l in self.replicas[0].layers.items() if isinstance(l, ShardedConv)}


def shard_params(model: MetasegUNet, mesh: Mesh) -> MeshUNet:
    """``model`` laid out on ``mesh`` (:class:`MeshUNet`); the inverse of
    :func:`gather_params`."""
    rule = leaf_sharding_rule(mesh)
    replicas = []
    for row in mesh.devices:
        replica = copy.deepcopy(model).to(row[0])
        for name, layer in list(replica.layers.items()):
            dim = rule(layer.weight, isinstance(layer, nn.ConvTranspose2d))
            if dim is not None:
                replica.layers[name] = ShardedConv(layer, row, dim)
        replicas.append(replica)
    return MeshUNet(mesh, replicas)


def gather_params(model_on_mesh: MeshUNet, device: DeviceLike = None) -> MetasegUNet:
    """The single-device ``MetasegUNet`` of data row 0's replica (every row
    holds the same values), on ``device`` (None: the mesh's first entry):
    the layout of checkpoints and of the exported ``.npz``."""
    device = model_on_mesh.mesh.devices[0][0] if device is None else torch.device(device)
    model = copy.deepcopy(model_on_mesh.replicas[0])
    for name, layer in list(model.layers.items()):
        if isinstance(layer, ShardedConv):
            model.layers[name] = layer.gathered(device)
    return model.to(device)


def _optimizer_like(src: torch.optim.Optimizer, params) -> torch.optim.Optimizer:
    """An optimizer of ``src``'s class and hyperparameters over ``params``."""
    opt = type(src)(params, lr=src.param_groups[0]["lr"])
    for key, value in src.param_groups[0].items():
        if key != "params":
            opt.param_groups[0][key] = value
    return opt


def _state_piece(value, ref: torch.Tensor, dim: Optional[int], n: int, k: int, device: torch.device):
    """Shard ``k`` of ``n`` of an optimizer state entry: a tensor shaped as
    its parameter ``ref`` is split as the parameter is; anything else (the
    step count) is copied."""
    if torch.is_tensor(value) and value.shape == ref.shape:
        piece = value.chunk(n, dim)[k] if dim is not None else value
        return piece.to(device, copy=True)
    return value.clone() if torch.is_tensor(value) else copy.deepcopy(value)


class MeshTrainStep:
    """The step callable of :func:`train_step_on_mesh`:
    ``step(x, y, valid=None) -> loss``."""

    def __init__(self, mesh: Mesh, model: MetasegUNet, optimizer: torch.optim.Optimizer, dtype: torch.dtype, remat: bool):
        self.mesh = mesh
        self.model = shard_params(model, mesh)
        self.dtype = dtype
        self.remat = remat
        self._template = optimizer
        dims = self.model.shard_dims()
        src_params = dict(model.named_parameters())
        n_model = mesh.shape["model"]
        self.optimizers = []  # one an entry that holds a parameter or a shard
        for r, row in enumerate(mesh.devices):
            slots = self.model.slots(r)
            for k in range(n_model):
                params = [p for _, s, p in slots if s == k]
                if not params:
                    continue
                opt = _optimizer_like(optimizer, params)
                for name, s, p in slots:
                    if s != k:
                        continue
                    state = optimizer.state.get(src_params[name])
                    if state:
                        dim = dims.get(name)
                        n = n_model if dim is not None else 1
                        opt.state[p] = {key: _state_piece(v, src_params[name], dim, n, s, p.device) for key, v in state.items()}
                self.optimizers.append(opt)

    def _row(self, r: int, x, y, valid, denom) -> torch.Tensor:
        """Forward and backward of data row ``r`` on its slice of the batch:
        its share of the loss, sum(valid per-sample means) / ``denom``."""
        dev = self.mesh.devices[r][0]
        pin_thread(dev)
        replica = self.model.replicas[r]
        for p in replica.parameters():
            p.grad = None
        x, y, valid = (t.to(dev) for t in (x, y, valid))
        with parity_flags() if self.dtype == torch.float32 else contextlib.nullcontext():
            xent = pixel_xent(replica, x, y, self.dtype, self.remat)
            per_sample = xent.mean(dim=(1, 2))
            loss = (per_sample * valid.to(per_sample.dtype)).sum() / denom.to(dev, per_sample.dtype)
            loss.backward()
        return loss.detach()

    def __call__(self, x, y, valid=None) -> torch.Tensor:
        """One optimizer step on uint8 NHWC crops ``x``, int32 labels ``y``
        and an optional (N,) bool ``valid`` (pad samples False), N a
        multiple of the data axis; returns the loss on the mesh's first
        entry.  The mean divides by the number of valid samples of the
        whole batch, so the rows' shares sum to ``softmax_xent_loss``."""
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        valid = torch.ones(x.shape[0], dtype=torch.bool) if valid is None else torch.as_tensor(valid)
        denom = torch.clamp(valid.sum().to(torch.float64), min=1.0)
        rows = split_batch(x.shape[0], self.mesh.shape["data"])
        jobs = [(r, x[s], y[s], valid[s], denom) for r, s in enumerate(rows)]
        if len(jobs) == 1:
            losses = [self._row(*jobs[0])]
        else:
            with cf.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
                losses = list(pool.map(lambda job: self._row(*job), jobs))
        # the gradients summed over the data axis, slot by slot in row order
        slots = [self.model.slots(r) for r in range(len(rows))]
        for i in range(len(slots[0])):
            total = slots[0][i][2].grad
            for r in range(1, len(rows)):
                total = total + slots[r][i][2].grad.to(total.device)
            for r in range(len(rows)):
                p = slots[r][i][2]
                p.grad = total if r == 0 else total.to(p.device, copy=True)
        for opt in self.optimizers:
            opt.step()
        loss = losses[0]
        for part in losses[1:]:
            loss = loss + part.to(loss.device)
        return loss

    def gather(self, device: DeviceLike = None) -> Tuple[MetasegUNet, torch.optim.Optimizer]:
        """The model and its optimizer in the single-device layout (row 0's
        values; split kernels and their moments concatenated), on
        ``device`` (None: the mesh's first entry): what
        ``runtime/checkpoint.save_checkpoint`` takes."""
        model = gather_params(self.model, device)
        opt = _optimizer_like(self._template, list(model.parameters()))
        dims = self.model.shard_dims()
        states = {}  # name -> [state of each shard, in shard order]
        for o in self.optimizers:
            for p in o.param_groups[0]["params"]:
                if p in o.state:
                    states.setdefault(p, o.state[p])
        by_name: Dict[str, List[dict]] = {}
        for name, _, p in self.model.slots(0):
            if p in states:
                by_name.setdefault(name, []).append(states[p])
        dev = next(model.parameters()).device
        for name, p in model.named_parameters():
            pieces = by_name.get(name)
            if not pieces:
                continue
            state = {}
            for key, v in pieces[0].items():
                if torch.is_tensor(v) and v.dim() == p.dim() and v.dim() > 0:
                    state[key] = torch.cat([s[key].to(dev) for s in pieces], dim=dims.get(name, 0)) if len(pieces) > 1 else v.to(dev, copy=True)
                else:
                    state[key] = v.clone() if torch.is_tensor(v) else copy.deepcopy(v)
            opt.state[p] = state
        return model, opt


def train_step_on_mesh(
    mesh: Mesh,
    model: MetasegUNet,
    lr: float,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> MeshTrainStep:
    """The counterpart of ``jit_train_step_on_mesh``: a step callable
    ``(x, y, valid) -> loss`` that trains a copy of ``model`` laid out on
    ``mesh`` (:func:`shard_params`; ``step.model``, ``step.gather()``).

    - The batch is split over the data axis; each data row runs its slice
      on its own thread (``device.pin_thread``), under ``parity_flags`` in
      float32, with ``remat`` and bf16 on float32 weights as in
      :func:`train_step`.
    - The gradients are summed over the data axis per parameter or shard in
      row order, so runs repeat, and every row steps on the same sum.
    - Each mesh entry has its own optimizer over the parameters and shards
      on it, so its moments live with them (the rule shards optax's state
      as it shards the parameters).  ``optimizer``: the single-device
      optimizer to continue from (its class, hyperparameters and state, as
      ``checkpoint.restore_checkpoint`` leaves it); None is
      :func:`make_optimizer` ``(model, lr)``."""
    if optimizer is None:
        optimizer = make_optimizer(model, lr)
    return MeshTrainStep(mesh, model, optimizer, dtype, remat)
