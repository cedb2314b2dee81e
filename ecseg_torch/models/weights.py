"""The weight bridge: the JAX parameter pytrees (as numpy arrays) to and from
:class:`~ecseg_torch.models.metaseg_unet.MetasegUNet`, the NuSeT modules
(:mod:`~ecseg_torch.models.nuset`) and the interseg classifiers
(:mod:`~ecseg_torch.models.classifiers`), and optax's adam state to and
from ``torch.optim.Adam``'s.

The tree is what ``ecseg_tpu.models.metaseg_unet.init_params`` builds and
``keras_import.save_npz_pytree`` flattens to ``"enc1_1/kernel"`` keys
(``keras_import.py:47-69``): ``{"enc1_1": {"kernel": HWIO, "bias": (O,)},
...}``.  Conv kernels go HWIO -> OIHW; transpose-conv kernels go HWIO ->
(in, out, kh, kw) by ``permute(2, 3, 0, 1)`` with no flip, because JAX flips
inside its conv2d_transpose (tests/test_layers.py pins the equivalence);
dense kernels go (in, out) -> ``Linear``'s (out, in).
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
    if isinstance(layer, nn.Linear):
        return k.t()
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


def _kernel_from_layer(layer: nn.Module, w: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`_layer_from_kernel`: a tensor in ``layer``'s weight
    layout to the JAX kernel layout, as a numpy copy."""
    w = w.detach().cpu()
    if isinstance(layer, nn.Linear):
        k = w.t()
    elif isinstance(layer, nn.ConvTranspose2d):
        k = w.permute(2, 3, 0, 1)
    else:
        k = w.permute(2, 3, 1, 0)
    return k.numpy().copy()


def params_to_numpy(model: MetasegUNet) -> Dict:
    """Inverse of :func:`params_from_numpy`."""
    return {
        name: {"kernel": _kernel_from_layer(layer, layer.weight), "bias": layer.bias.detach().cpu().numpy().copy()}
        for name, layer in model.layers.items()
    }


def adam_state_from_numpy(model: MetasegUNet, optimizer: torch.optim.Adam, opt_state) -> None:
    """Set ``optimizer``'s state to optax's adam state: ``opt_state[0]`` is
    ``ScaleByAdamState(count, mu, nu)`` (any (count, mu, nu) sequence), its
    moments parameter trees in the JAX layout (numpy), as ``optax.adam``'s
    ``(ScaleByAdamState, EmptyState())`` gives them.  ``step`` becomes
    ``count``, ``exp_avg`` ``mu`` and ``exp_avg_sq`` ``nu``, each in its
    parameter's layout, dtype and device."""
    count, mu, nu = opt_state[0]
    for name, layer in model.layers.items():
        for attr, key in (("weight", "kernel"), ("bias", "bias")):
            p = getattr(layer, attr)
            layout = (lambda a: _layer_from_kernel(layer, a)) if key == "kernel" else _as_f32
            optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                "exp_avg": torch.empty_like(p).copy_(layout(mu[name][key])),
                "exp_avg_sq": torch.empty_like(p).copy_(layout(nu[name][key])),
            }


def adam_state_to_numpy(model: MetasegUNet, optimizer: torch.optim.Adam):
    """Inverse of :func:`adam_state_from_numpy`: ``(count, mu, nu)`` with
    ``mu`` and ``nu`` parameter trees in the JAX layout (numpy float32)."""
    mu, nu, counts = {}, {}, set()
    for name, layer in model.layers.items():
        mu[name], nu[name] = {}, {}
        for attr, key in (("weight", "kernel"), ("bias", "bias")):
            p = getattr(layer, attr)
            st = optimizer.state[p]
            counts.add(int(st["step"]))
            for tree, t in ((mu, st["exp_avg"]), (nu, st["exp_avg_sq"])):
                tree[name][key] = _kernel_from_layer(layer, t) if key == "kernel" else t.detach().cpu().numpy().copy()
    if len(counts) != 1:
        raise ValueError(f"the parameters' Adam steps differ: {sorted(counts)}")
    return counts.pop(), mu, nu


def modules_from_tree(module: nn.Module, tree: Dict, what: str) -> None:
    """Copy ``tree``'s kernels and biases into ``module.layers``."""
    if set(tree) != set(module.layers):
        raise ValueError(f"{what}: parameter tree layers {sorted(tree)} do not match {sorted(module.layers)}")
    with torch.no_grad():
        for name, layer in module.layers.items():
            w = _layer_from_kernel(layer, tree[name]["kernel"])
            if w.shape != layer.weight.shape:
                raise ValueError(f"{what} {name}: kernel {tuple(w.shape)} != {tuple(layer.weight.shape)}")
            layer.weight.copy_(w)
            if layer.bias is not None:
                layer.bias.copy_(_as_f32(tree[name]["bias"]))


def tree_from_modules(module: nn.Module) -> Dict:
    tree = {}
    for name, layer in module.layers.items():
        tree[name] = {"kernel": _kernel_from_layer(layer, layer.weight)}
        if layer.bias is not None:
            tree[name]["bias"] = layer.bias.detach().cpu().numpy().copy()
    return tree


def nuset_from_numpy(tree: Dict):
    """(whole-image U-Net, foreground U-Net, RPN) on the CPU, float32, from
    the ``{"whole": unet, "fg": {"unet": unet, "rpn": rpn}}`` tree that
    ``models/nuset.npz`` stores (``ecseg_tpu/pipelines/stat_fish.py:38-53``);
    the RPN's anchor count is read off its score head."""
    from .nuset import NuSeTRPN, NuSeTUNet

    whole, fg = NuSeTUNet(), NuSeTUNet()
    rpn = NuSeTRPN(int(tree["fg"]["rpn"]["rpn_cls_score"]["kernel"].shape[3]) // 2)
    modules_from_tree(whole, tree["whole"], "whole")
    modules_from_tree(fg, tree["fg"]["unet"], "fg unet")
    modules_from_tree(rpn, tree["fg"]["rpn"], "fg rpn")
    return whole, fg, rpn


def nuset_to_numpy(whole: nn.Module, fg: nn.Module, rpn: nn.Module) -> Dict:
    """Inverse of :func:`nuset_from_numpy`."""
    return {"whole": tree_from_modules(whole), "fg": {"unet": tree_from_modules(fg), "rpn": tree_from_modules(rpn)}}


def classifier_from_numpy(tree: Dict) -> nn.Module:
    """An :class:`~ecseg_torch.models.classifiers.EcsegI` (one input
    channel) or :class:`~ecseg_torch.models.classifiers.EcsegC` (three) on
    the CPU, float32, holding the ``init_ecseg_{i,c}_params`` tree's
    weights."""
    from .classifiers import EcsegC, EcsegI

    in_ch = int(tree["conv1"]["kernel"].shape[2])
    if in_ch not in (1, 3):
        raise ValueError(f"classifier tree with {in_ch} input channels: ecSeg-i takes 1, ecSeg-c 3")
    model = EcsegI() if in_ch == 1 else EcsegC()
    modules_from_tree(model, tree, "ecSeg-i" if in_ch == 1 else "ecSeg-c")
    return model


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


def load_nuset_model(model_dir: str = "models", device=None, **knobs):
    """The NuSeT model of ``<model_dir>/nuset.npz`` (the JAX package's
    tree, read through the bridge) or, with no such file, the crafted demo
    tree (``models/demo.py``) on seed 0, on ``device`` (None: the card).
    ``knobs``: ``nms_threshold``, ``bbox_min_score``, ``resize_scale``."""
    from ..device import resolve_device
    from .demo import demo_nuset_tree
    from .nuset_infer import NuSeTModel

    dev = resolve_device(device)
    path = os.path.join(model_dir, "nuset.npz")
    tree = load_npz(path) if os.path.exists(path) else demo_nuset_tree()
    whole, fg, rpn = (m.to(dev).eval() for m in nuset_from_numpy(tree))
    return NuSeTModel(unet_whole=whole, unet_fg=fg, rpn_fg=rpn, **knobs)
