"""The weight bridge: the JAX parameter pytree (as numpy arrays) to and from
:class:`~ecseg_torch.models.metaseg_unet.MetasegUNet`.

The tree is what ``ecseg_tpu.models.metaseg_unet.init_params`` builds and
``keras_import.save_npz_pytree`` flattens to ``"enc1_1/kernel"`` keys
(``keras_import.py:47-69``): ``{"enc1_1": {"kernel": HWIO, "bias": (O,)},
...}``.  Conv kernels go HWIO -> OIHW; transpose-conv kernels go HWIO ->
(in, out, kh, kw) by ``permute(2, 3, 0, 1)`` with no flip, because JAX flips
inside its conv2d_transpose (tests/test_layers.py pins the equivalence).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from .metaseg_unet import MetasegUNet


def _as_f32(a) -> torch.Tensor:
    """float32 tensor of a numpy-like array; bf16 arrays (``ml_dtypes``, what
    ``np.asarray`` of a JAX bf16 array gives) upcast exactly."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer_from_kernel(layer: nn.Module, kernel: np.ndarray) -> torch.Tensor:
    k = _as_f32(kernel)
    if isinstance(layer, nn.ConvTranspose2d):
        return k.permute(2, 3, 0, 1)
    return k.permute(3, 2, 0, 1)


def params_from_numpy(tree: Dict) -> MetasegUNet:
    """A float32 MetasegUNet (on the CPU) holding the tree's weights; its
    widths are read off the kernels.  The tree may hold float32 or bf16
    arrays; ``.to(torch.bfloat16)`` on the result gives the bf16 forward."""
    levels = max(int(k[3]) for k in tree if k.startswith("enc"))
    widths = tuple(int(tree[f"enc{i}_1"]["kernel"].shape[3]) for i in range(1, levels + 1))
    model = MetasegUNet(
        widths=widths,
        bottleneck=int(tree["bott_1"]["kernel"].shape[3]),
        in_ch=int(tree["enc1_1"]["kernel"].shape[2]),
        num_classes=int(tree["head"]["kernel"].shape[3]),
    )
    if set(tree) != set(model.layers):
        raise ValueError(f"parameter tree layers {sorted(tree)} do not match the U-Net's")
    with torch.no_grad():
        for name, layer in model.layers.items():
            w = _layer_from_kernel(layer, tree[name]["kernel"])
            if w.shape != layer.weight.shape:
                raise ValueError(f"{name}: kernel {tuple(w.shape)} != {tuple(layer.weight.shape)}")
            layer.weight.copy_(w)
            layer.bias.copy_(_as_f32(tree[name]["bias"]))
    return model


def params_to_numpy(model: MetasegUNet) -> Dict:
    """Inverse of :func:`params_from_numpy`."""
    tree = {}
    for name, layer in model.layers.items():
        w = layer.weight.detach().cpu()
        k = w.permute(2, 3, 0, 1) if isinstance(layer, nn.ConvTranspose2d) else w.permute(2, 3, 1, 0)
        tree[name] = {"kernel": k.numpy().copy(), "bias": layer.bias.detach().cpu().numpy().copy()}
    return tree


def load_npz(path: str) -> Dict:
    """The nested numpy tree of a ``save_npz_pytree`` file."""
    out: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def save_npz(path: str, tree: Dict) -> None:
    """Flat ``"layer/kernel"`` keys, as ``save_npz_pytree`` writes them."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(path, **flat)
