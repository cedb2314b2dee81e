"""The (data, model) device mesh and its sharding rule (the port's
counterpart of ``ecseg_tpu/parallel/mesh.py:29-88``).

One process drives every device, as ``jax.jit`` over a mesh does: a mesh is
a grid of ``torch.device`` entries, rows along the ``data`` axis and columns
along the ``model`` axis, and the multi-device paths run one thread per
entry (or per data row).  An entry may repeat: the same card listed more
than once is a logical mesh, which exercises the code paths, the launches
and the bytes of a mesh on one card, but no speed-up.

The rule: a 4-D convolution kernel whose out-channels are >= 256 and
divide by the model axis is split on them over the model axis; every other
parameter (and its optimizer state) is replicated.  In PyTorch's layouts
the out-channels are dim 0 of a conv's OIHW kernel and dim 1 of a transpose
conv's (in, out, kh, kw) kernel; the JAX package's HWIO kernels hold them
last.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..device import DevicesLike, resolve_devices

WIDE = 256  # out-channels from which a kernel is split over the model axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[r][k]``: data row ``r``, model entry ``k``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]


def make_mesh(devices: DevicesLike = None, n_devices: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (``device.resolve_devices``: ``None`` is every card)."""
    devs = resolve_devices(devices)
    if n_devices is None:
        n_devices = len(devs)
    if n_devices % model_axis != 0:
        raise ValueError(f"{n_devices} devices not divisible by model axis {model_axis}")
    if len(devs) < n_devices:
        raise ValueError(
            f"make_mesh needs {n_devices} devices but the device list has {len(devs)} on {devs[0].type!r}. "
            f"For a mesh on the CPU pass devices=['cpu'] * {n_devices}; for a logical mesh on one card, "
            f"devices=['cuda:0'] * {n_devices}."
        )
    grid = devs[:n_devices]
    rows = tuple(tuple(grid[r * model_axis : (r + 1) * model_axis]) for r in range(n_devices // model_axis))
    return Mesh(rows)


def leaf_sharding_rule(mesh: Mesh):
    """``rule(kernel, transpose=False)``: the dim of a parameter to split
    over the model axis, or None to replicate it."""
    model_size = mesh.shape["model"]

    def rule(param: torch.Tensor, transpose: bool = False) -> Optional[int]:
        if model_size > 1 and param.dim() == 4:
            dim = 1 if transpose else 0
            if param.shape[dim] >= WIDE and param.shape[dim] % model_size == 0:
                return dim
        return None

    return rule


def param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Parameter name -> the dim split over the model axis (None:
    replicated), by :func:`leaf_sharding_rule`."""
    rule = leaf_sharding_rule(mesh)
    out = {}
    for mod_name, module in model.named_modules():
        transpose = isinstance(module, nn.ConvTranspose2d)
        for name, p in module.named_parameters(recurse=False):
            out[f"{mod_name}.{name}" if mod_name else name] = rule(p, transpose)
    return out


def split_batch(n: int, parts: int) -> Sequence[slice]:
    """``parts`` equal slices of ``n`` samples along the data axis."""
    if n % parts:
        raise ValueError(f"a batch of {n} does not split over a data axis of {parts}; pad it (runtime/data.pad_to_multiple)")
    b = n // parts
    return [slice(r * b, (r + 1) * b) for r in range(parts)]


def shard_patch_batch(mesh: Mesh, batch: torch.Tensor) -> List[torch.Tensor]:
    """A (N, H, W, C) patch batch split along N over the data axis (the JAX
    package's ``NamedSharding(mesh, P("data", None, None, None))``): one
    shard per mesh entry, in :meth:`Mesh.flat` order, the row's shard on
    each entry of its row (replicated over the model axis)."""
    parts = split_batch(batch.shape[0], mesh.shape["data"])
    return [batch[sl].to(dev) for sl, row in zip(parts, mesh.devices) for dev in row]
