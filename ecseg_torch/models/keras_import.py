"""The imported-Keras executor (twin of ``ecseg_tpu/models/keras_import.py``):
a Keras checkpoint's embedded config rebuilt as a layer graph and run with
torch ops, so the reference's ``metaseg.h5`` and interseg's ``.h5`` models
drop into the port without TensorFlow.

Containers: a legacy Keras HDF5 save (``model_config`` attr, per-layer
groups under ``model_weights``) through :func:`import_keras_h5`, and a
Keras 3 ``.keras`` zip (``config.json`` + ``model.weights.h5``) through
:func:`import_keras_file`.  Both read the file with the port's own HDF5
reader (``core/hdf5.py``: plain Python and numpy, the subset of HDF5 that
h5py writes under its default ``libver``), so no HDF5 package is needed
(the JAX package reads them with h5py).  :func:`import_from_config`, the
graph constructor below the readers, takes a parsed config and any fetcher with
the readers' ``fetch``/``child`` methods.

Layers: InputLayer, Conv2D, Conv2DTranspose, SeparableConv2D,
DepthwiseConv2D, MaxPooling2D, AveragePooling2D, UpSampling2D, Concatenate,
Add, Activation, ReLU, LeakyReLU, BatchNormalization (inference),
Dropout/SpatialDropout2D/GaussianNoise (identity), ZeroPadding2D,
Cropping2D, Rescaling, Dense, Flatten, Reshape, Permute,
GlobalAveragePooling2D, and nested Functional/Sequential sub-models
(multi-output ones consumed at any tensor index).  Each follows the JAX
executor's reading of its config, including what that executor ignores
(dilation; a conv's second stride; ``ReLU``'s max_value).

Layout: the graph's tensors are Keras's (NHWC), but a 4-D activation is held
NCHW between layers, so every conv and pool runs on cuDNN's native layout.
Every layer whose result depends on the layout maps its axes: Concatenate's
axis, softmax and BatchNormalization over the channel, Dense over the last
Keras axis (through NHWC), Flatten/Reshape/Permute through NHWC.  Inputs are
taken and outputs returned NHWC.  'SAME' padding is the JAX (and TF) split:
the odd pixel at the bottom and right.  float32 under
``layers.parity_flags``, inputs cast to float32 (the JAX package runs its
executor with x64 off); weights are buffers on the device given at import.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import hdf5
from ..device import DeviceLike, resolve_device
from .layers import parity_flags


def _decode(v):
    return v.decode() if isinstance(v, bytes) else v


# --------------------------------------------------------------------------
# weight fetchers (the JAX executor's, unchanged)
# --------------------------------------------------------------------------


class _LegacyH5Fetcher:
    """Weight lookup for legacy Keras H5 saves: per-layer groups under
    ``model_weights`` keyed by the user layer name, ordered by the group's
    ``weight_names`` attr.  A nested sub-model keeps one group whose
    weight_names are slash paths relative to it (``subconv/kernel:0``)."""

    def __init__(self, group, names: Optional[List[str]] = None):
        self.group = group
        self.names = names  # relative weight paths when nested

    def fetch(self, layer_name: str) -> List[np.ndarray]:
        if self.names is not None:
            sel = [n for n in self.names if n.split("/", 1)[0] == layer_name]
            return [np.array(self.group[n]) for n in sel]
        if layer_name not in self.group:
            return []
        grp = self.group[layer_name]
        names = [_decode(n) for n in grp.attrs.get("weight_names", [])]
        if names:
            return [np.array(grp[n]) for n in names]
        out = []

        def visit(_, obj):
            if isinstance(obj, hdf5.Dataset):
                out.append(np.array(obj))

        grp.visititems(visit)
        return out

    def child(self, layer_name: str, child_layers_cfg) -> "_LegacyH5Fetcher":
        if self.names is not None:
            sub = [n.split("/", 1)[1] for n in self.names if n.split("/", 1)[0] == layer_name and "/" in n]
            return _LegacyH5Fetcher(self.group[layer_name], sub)
        grp = self.group[layer_name]
        return _LegacyH5Fetcher(grp, [_decode(n) for n in grp.attrs.get("weight_names", [])])


def _to_snake_case(name: str) -> str:
    """keras.src.utils.naming.to_snake_case (Conv2D -> conv2d)."""
    name = re.sub(r"\W+", "", name)
    name = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", name).lower()


def _k3_group_names(layers_cfg) -> Dict[str, str]:
    """Config layer name -> weights-H5 group name for Keras 3 saves: the
    snake-cased class name, deduplicated per container in config order with
    _1, _2... suffixes."""
    counts: Dict[str, int] = {}
    out: Dict[str, str] = {}
    for lc in layers_cfg:
        base = _to_snake_case(lc["class_name"])
        k = counts.get(base, 0)
        counts[base] = k + 1
        out[lc["config"]["name"]] = base if k == 0 else f"{base}_{k}"
    return out


class _K3Fetcher:
    """Weight lookup for Keras 3 ``model.weights.h5``: groups
    ``layers/<snake_class[_N]>/vars/{0,1,...}``; nested models add another
    ``layers`` level."""

    def __init__(self, layers_group, layers_cfg):
        self.group = layers_group
        self.map = _k3_group_names(layers_cfg)

    def fetch(self, layer_name: str) -> List[np.ndarray]:
        key = self.map.get(layer_name)
        if key is None or self.group is None or key not in self.group:
            return []
        g = self.group[key]
        if "vars" not in g:
            return []
        vars_g = g["vars"]
        return [np.array(vars_g[i]) for i in sorted(vars_g.keys(), key=int)]

    def child(self, layer_name: str, child_layers_cfg) -> "_K3Fetcher":
        # a weightless nested wrapper may have no group at this level: an
        # empty fetcher still imports its weightless sublayers
        key = self.map.get(layer_name)
        sub = None
        if key is not None and self.group is not None and key in self.group:
            g = self.group[key]
            sub = g["layers"] if "layers" in g else None
        return _K3Fetcher(sub, child_layers_cfg)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


class KerasModel(nn.Module):
    """A Keras graph as an ``nn.Module``: ``forward(x)`` takes the NHWC
    input (or a list, for several inputs; a numpy array is moved to the
    model's device), cast to float32, and returns the NHWC output (or a
    list).  The weights are float32 buffers."""

    def __init__(self, config: Dict):
        super().__init__()
        self.config = config
        self._forward: Callable = None  # set by import_from_config
        # follows .to() like the weights, so a weightless graph knows its device too
        self.register_buffer("anchor", torch.zeros(0))

    def _register(self, value: np.ndarray) -> str:
        """Hold ``value`` as a float32 buffer; returns its name."""
        name = f"w{len(self._buffers) - 1}"
        self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32)))
        return name

    def _in(self, x) -> torch.Tensor:
        return _internal(torch.as_tensor(x, device=self.anchor.device).float())

    def forward(self, x):
        xs = [self._in(t) for t in x] if isinstance(x, (list, tuple)) else self._in(x)
        with parity_flags():
            y = self._forward(dict(self.named_buffers()), xs)
        return [_nhwc(t) for t in y] if isinstance(y, list) else _nhwc(y)


def model_device(model: nn.Module) -> torch.device:
    """The device of a module's parameters or, for a KerasModel (buffers
    only), of its buffers."""
    for t in model.parameters():
        return t.device
    for t in model.buffers():
        return t.device
    raise ValueError(f"{type(model).__name__} holds no tensor")


def _internal(t: torch.Tensor) -> torch.Tensor:
    """Keras order -> the executor's: a 4-D tensor goes NHWC -> NCHW."""
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """The executor's order -> Keras's."""
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def _channels(t: torch.Tensor, v) -> torch.Tensor:
    """A per-channel vector (or a scalar) shaped to broadcast over the last
    Keras axis of ``t``."""
    v = torch.as_tensor(v, dtype=torch.float32, device=t.device)
    return v.reshape(-1, 1, 1) if t.dim() == 4 and v.dim() == 1 else v


def _softmax(t: torch.Tensor) -> torch.Tensor:
    return torch.softmax(t, dim=1 if t.dim() == 4 else -1)


_ACTIVATIONS: Dict[str, Callable] = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softmax": _softmax,
    "tanh": torch.tanh,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "swish": F.silu,
}


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """'SAME' padding (lo, hi) of one axis: output ceil(size / s), the odd
    pixel at the end."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int, padding: str) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) of 'SAME' or 'VALID'."""
    if padding.upper() == "VALID":
        return 0, 0, 0, 0
    if padding.upper() != "SAME":
        raise ValueError(f"padding {padding!r}: 'same' or 'valid'")
    return _same_pads(x.shape[3], kw, sw) + _same_pads(x.shape[2], kh, sh)


def _pad_same(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int, padding: str, value: float = 0.0) -> torch.Tensor:
    pads = _pads(x, kh, kw, sh, sw, padding)
    return F.pad(x, pads, value=value) if any(pads) else x


def _conv(x: torch.Tensor, weight: torch.Tensor, stride: int, padding: str, groups: int = 1) -> torch.Tensor:
    """JAX ``conv2d`` / ``_depthwise_conv`` (a square stride) on an OIHW
    weight, bias left to the caller.  An even split goes to cuDNN as its
    padding (the call ``SameConv2d`` makes, so the same algorithm and bits
    on the card); an uneven one is padded first."""
    x = x.float()
    left, right, top, bottom = _pads(x, *weight.shape[2:], stride, stride, padding)
    if left == right and top == bottom:
        return F.conv2d(x, weight, None, stride, (top, left), groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), weight, None, stride, groups=groups)


def _add_bias(y: torch.Tensor, p: Dict, name: Optional[str]) -> torch.Tensor:
    return y if name is None else y + _channels(y, p[name])


def _pool2(x: torch.Tensor, size: Tuple[int, int], stride: Tuple[int, int], padding: str, op: str) -> torch.Tensor:
    """``_pool2`` of the JAX executor: max pads with -inf, average divides
    the window's sum by its count of in-bounds pixels."""
    x = x.float()
    if op == "max":
        return F.max_pool2d(_pad_same(x, *size, *stride, padding, value=-np.inf), size, stride)
    total = F.avg_pool2d(_pad_same(x, *size, *stride, padding), size, stride, divisor_override=1)
    ones = torch.ones_like(x[:1, :1])
    count = F.avg_pool2d(_pad_same(ones, *size, *stride, padding), size, stride, divisor_override=1)
    return total / count


def _upsample(x: torch.Tensor, size: Tuple[int, int], interpolation: str) -> torch.Tensor:
    if interpolation == "nearest":
        return x.repeat_interleave(size[0], dim=2).repeat_interleave(size[1], dim=3)
    # jax.image.resize "bilinear": half-pixel centres, weights renormalized
    # at the edges, which for an integer upscale is the clamped sample
    out = (x.shape[2] * size[0], x.shape[3] * size[1])
    return F.interpolate(x, size=out, mode="bilinear", align_corners=False)


# --------------------------------------------------------------------------
# the graph constructor
# --------------------------------------------------------------------------


def import_keras_h5(path: str, device: DeviceLike = None) -> KerasModel:
    """Legacy Keras H5 whole-model save -> KerasModel on ``device`` (None:
    the card)."""
    with hdf5.File(path) as h5:
        cfg_raw = h5.attrs.get("model_config")
        if cfg_raw is None:
            raise ValueError(f"{path} has no embedded model_config")
        cfg = json.loads(_decode(cfg_raw))
        mw = h5["model_weights"] if "model_weights" in h5 else h5
        return import_from_config(cfg, _LegacyH5Fetcher(mw), device)


def import_keras_file(path: str, device: DeviceLike = None) -> KerasModel:
    """Any supported Keras checkpoint: a Keras 3 ``.keras`` zip archive or a
    legacy ``.h5`` save."""
    import zipfile

    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            cfg = json.loads(z.read("config.json"))
            with hdf5.File(z.read("model.weights.h5")) as wh5:
                layers_group = wh5["layers"] if "layers" in wh5 else None
                fetcher = _K3Fetcher(layers_group, cfg["config"].get("layers", []))
                return import_from_config(cfg, fetcher, device)
    return import_keras_h5(path, device)


def import_from_config(cfg: Dict, fetcher, device: DeviceLike = None) -> KerasModel:
    """A parsed Keras model config (``{"class_name", "config"}``) and a
    fetcher (``fetch(layer_name) -> [arrays in Keras's weight order]``,
    ``child(layer_name, layers_cfg) -> fetcher`` of a nested model) ->
    KerasModel on ``device`` (None: the card)."""
    dev = resolve_device(device)
    model = KerasModel(cfg)
    model._forward = _build_model_fn(cfg["class_name"], cfg["config"], fetcher, model)
    return model.to(dev)


def _pick(value, tensor_idx: int):
    """One tensor of a producer's output (multi-output producers give
    lists)."""
    if isinstance(value, (list, tuple)):
        return value[tensor_idx]
    if tensor_idx not in (0, None):
        raise ValueError(f"tensor index {tensor_idx} requested from single-output producer")
    return value


def _build_model_fn(class_name: str, model_cfg: Dict, fetcher, model: KerasModel) -> Callable:
    """Compile a (possibly nested) Keras model config into
    ``forward(params, x_or_list) -> tensor_or_list`` over the executor's
    layout; ``params`` maps the model's buffer names to its tensors."""
    layers_cfg = model_cfg["layers"]
    # steps: (out key (name, node_idx), input refs [(name, node_idx,
    # tensor_idx)], fn)
    steps: List[Tuple[Tuple[str, int], List[Tuple[str, int, int]], Callable]] = []

    if class_name == "Sequential":
        prev = ("__input__", 0, 0)
        inputs = ["__input__"]
        for lc in layers_cfg:
            if lc["class_name"] == "InputLayer":
                continue
            name = lc["config"]["name"]
            fn = _make_layer_fn(lc, name, fetcher, model)
            if fn is None:
                continue
            steps.append(((name, 0), [prev], fn))
            prev = (name, 0, 0)
        outputs = [prev]
    else:  # Functional / Model
        inputs = []
        for lc in layers_cfg:
            name = lc["config"]["name"]
            if lc["class_name"] == "InputLayer":
                inputs.append(name)
                continue
            nodes = _inbound_refs(lc)
            fn = _make_layer_fn(lc, name, fetcher, model)
            if fn is None:  # identity layer (Dropout etc.)
                fn = lambda p, xs: xs[0]
            # a shared layer is called once per inbound node, each call with
            # the same weights and its own slot; in the legacy format a
            # nested model's node 0 is its construction, so its calls count
            # from 1, while Keras 3's dict-format refs count from 0
            raw_nodes = lc.get("inbound_nodes", [])
            legacy_fmt = bool(raw_nodes) and not isinstance(raw_nodes[0], dict)
            nested = lc["class_name"] in ("Functional", "Model", "Sequential")
            offset = 1 if (nested and legacy_fmt) else 0
            for node_idx, in_refs in enumerate(nodes):
                steps.append(((name, offset + node_idx), in_refs, fn))
        out_spec = model_cfg.get("output_layers", [])
        if out_spec and isinstance(out_spec[0], str):
            out_spec = [out_spec]  # Keras 3 single-output flat form
        if out_spec:
            outputs = [(o[0], o[1] if len(o) > 1 else 0, o[2] if len(o) > 2 else 0) for o in out_spec]
        else:
            n, i = steps[-1][0]
            outputs = [(n, i, 0)]

        # creation order is not call order when layers are shared: run in
        # dependency order (Kahn)
        available = {(name, 0) for name in inputs}
        ordered, remaining = [], steps
        while remaining:
            rest = []
            for s in remaining:
                if all(r[:2] in available for r in s[1]):
                    ordered.append(s)
                    available.add(s[0])
                else:
                    rest.append(s)
            if len(rest) == len(remaining):
                missing = {r[:2] for s in remaining for r in s[1]} - available
                raise ValueError(f"unresolvable layer graph; missing producers: {missing}")
            remaining = rest
        steps = ordered

    def forward(p, x):
        if len(inputs) == 1:
            env = {(inputs[0], 0): x}
        else:
            env = {(name, 0): xi for name, xi in zip(inputs, x)}
        for out, ins, fn in steps:
            env[out] = fn(p, [_pick(env[(n, i)], t) for (n, i, t) in ins])
        res = [_pick(env[(n, i)], t) for (n, i, t) in outputs]
        return res[0] if len(res) == 1 else res

    return forward


def _inbound_refs(layer_cfg) -> List[List[Tuple[str, int, int]]]:
    """All inbound nodes of a layer as [(producer_name, producer_node_idx,
    producer_tensor_idx)] lists, one per call of the layer, in the legacy
    nested-list format or the Keras 3 dict format."""
    out: List[List[Tuple[str, int, int]]] = []
    for node in layer_cfg.get("inbound_nodes", []):
        if isinstance(node, dict):  # Keras 3
            refs: List[Tuple[str, int, int]] = []

            def walk(a):
                if isinstance(a, dict):
                    hist = a.get("config", {}).get("keras_history")
                    if hist is not None:
                        refs.append((hist[0], hist[1] if len(hist) > 1 else 0, hist[2] if len(hist) > 2 else 0))
                        return
                    for v in a.values():
                        walk(v)
                elif isinstance(a, (list, tuple)):
                    for e in a:
                        walk(e)

            walk(node.get("args", []))
            out.append(refs)
        else:  # legacy: [[name, node_idx, tensor_idx, kwargs], ...]
            out.append([(e[0], e[1] if len(e) > 1 else 0, e[2] if len(e) > 2 else 0) for e in node])
    return out


def _keras_axis(t: torch.Tensor, axis: int) -> int:
    """A Keras (NHWC) axis of ``t`` as the executor's axis."""
    axis %= t.dim()
    return (0, 2, 3, 1)[axis] if t.dim() == 4 else axis


def _nchw(t: torch.Tensor) -> torch.Tensor:
    """A Keras-order result as the executor holds it, a 4-D one in
    standard NCHW strides.  The permuted view of a one-channel map also
    reads as channels-last, and every conv after it then runs as NHWC
    (ecSeg-i's forward took ten times as long so on an H100)."""
    return _internal(t).clone(memory_format=torch.contiguous_format) if t.dim() == 4 else t


def _through_nhwc(fn: Callable) -> Callable:
    """A layer that reads the Keras order: run ``fn`` on the NHWC view."""
    return lambda p, xs: _nchw(fn(_nhwc(xs[0])))


def _make_layer_fn(lc, name: str, fetcher, model: KerasModel):
    cls = lc["class_name"]
    c = lc["config"]
    act = _ACTIVATIONS.get(c.get("activation", "linear"), lambda x: x)

    def weights(keys: Sequence[str], values: Sequence[np.ndarray]) -> Dict[str, str]:
        return {k: model._register(v) for k, v in zip(keys, values)}

    if cls in ("Dropout", "SpatialDropout2D", "GaussianNoise"):
        return None
    if cls in ("Functional", "Model", "Sequential"):
        sub = _build_model_fn("Sequential" if cls == "Sequential" else "Functional", c, fetcher.child(name, c.get("layers", [])), model)
        return lambda p, xs: sub(p, xs if len(xs) > 1 else xs[0])
    if cls == "Activation":
        a = _ACTIVATIONS[c["activation"]]
        return lambda p, xs: a(xs[0])
    if cls == "ReLU":
        return lambda p, xs: torch.relu(xs[0])
    if cls == "LeakyReLU":
        alpha = c.get("alpha", c.get("negative_slope", 0.3))
        return lambda p, xs: F.leaky_relu(xs[0], alpha)
    if cls == "Rescaling":
        scale, offset = c["scale"], c.get("offset", 0.0)
        if isinstance(scale, (int, float)) and isinstance(offset, (int, float)):
            return lambda p, xs: xs[0] * scale + offset
        return lambda p, xs: xs[0] * _channels(xs[0], scale) + _channels(xs[0], offset)
    if cls == "Flatten":
        return lambda p, xs: _nhwc(xs[0]).reshape(xs[0].shape[0], -1)
    if cls == "Reshape":
        target = tuple(c["target_shape"])
        return _through_nhwc(lambda x: x.reshape((x.shape[0],) + target))
    if cls == "Permute":
        dims = (0,) + tuple(c["dims"])  # 1-indexed, excluding the batch
        return _through_nhwc(lambda x: x.permute(dims))
    if cls == "GlobalAveragePooling2D":
        return lambda p, xs: xs[0].mean(dim=(2, 3))
    if cls == "Concatenate":
        axis = c.get("axis", -1)
        return lambda p, xs: torch.cat(xs, dim=_keras_axis(xs[0], axis))
    if cls == "Add":
        return lambda p, xs: sum(xs)
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        size = tuple(c["pool_size"])
        stride = tuple(c["strides"] or size)
        op = "max" if cls == "MaxPooling2D" else "avg"
        return lambda p, xs: _pool2(xs[0], size, stride, c["padding"], op)
    if cls == "UpSampling2D":
        size = tuple(c["size"])
        interpolation = c.get("interpolation", "nearest")
        return lambda p, xs: _upsample(xs[0], size, interpolation)
    if cls == "ZeroPadding2D":
        padding = c["padding"]
        if isinstance(padding, int):
            padding = ((padding, padding), (padding, padding))
        (t, b), (l, r) = padding
        return lambda p, xs: F.pad(xs[0], (l, r, t, b))
    if cls == "Cropping2D":
        (t, b), (l, r) = c["cropping"]
        return lambda p, xs: xs[0][:, :, t : xs[0].shape[2] - b, l : xs[0].shape[3] - r]

    if cls in ("Conv2D", "DepthwiseConv2D", "SeparableConv2D", "Conv2DTranspose", "Dense"):
        w = fetcher.fetch(name)
        n_kernels = 2 if cls == "SeparableConv2D" else 1
        bias = None
        if c.get("use_bias", True) and len(w) > n_kernels:
            bias = weights(["bias"], [w[n_kernels]])["bias"]
        stride = tuple(c.get("strides", (1, 1)))[0]
        pad = c.get("padding", "valid")
    if cls == "Conv2D":
        k = weights(["kernel"], [np.transpose(w[0], (3, 2, 0, 1))])["kernel"]  # HWIO -> OIHW
        return lambda p, xs: act(_add_bias(_conv(xs[0], p[k], stride, pad), p, bias))
    if cls == "DepthwiseConv2D":
        # (h, w, in, mult) -> grouped conv, output channel g * mult + m
        h, wd, cin, mult = w[0].shape
        k = weights(["kernel"], [np.transpose(w[0].reshape(h, wd, 1, cin * mult), (3, 2, 0, 1))])["kernel"]
        return lambda p, xs: act(_add_bias(_conv(xs[0], p[k], stride, pad, groups=cin), p, bias))
    if cls == "SeparableConv2D":
        h, wd, cin, mult = w[0].shape
        ks = weights(
            ["depthwise", "pointwise"],
            [np.transpose(w[0].reshape(h, wd, 1, cin * mult), (3, 2, 0, 1)), np.transpose(w[1], (3, 2, 0, 1))],
        )

        def sepconv_fn(p, xs):
            y = _conv(xs[0], p[ks["depthwise"]], stride, pad, groups=cin)
            return act(_add_bias(_conv(y, p[ks["pointwise"]], 1, "SAME"), p, bias))

        return sepconv_fn
    if cls == "Conv2DTranspose":
        # Keras stores (H, W, out, in); conv_transpose2d's weight is (in,
        # out, H, W), unflipped.  The JAX executor ignores the config's
        # padding: 'SAME' of stride s, the full transpose conv with
        # max(kh - s, 0) rows and columns cut, the odd one at the end
        k = weights(["kernel"], [np.transpose(w[0], (3, 2, 0, 1))])["kernel"]
        total = max(w[0].shape[0] - stride, 0)
        lo, hi = total // 2, total - total // 2

        def deconv_fn(p, xs):
            y = F.conv_transpose2d(xs[0].float(), p[k], None, stride)
            y = y[:, :, lo : y.shape[2] - hi, lo : y.shape[3] - hi]
            return act(_add_bias(y, p, bias))

        return deconv_fn
    if cls == "Dense":
        k = weights(["kernel"], [w[0]])["kernel"]

        def dense_fn(p, xs):
            y = torch.matmul(_nhwc(xs[0]), p[k])
            if bias is not None:
                y = y + p[bias]
            return act(_nchw(y))

        return dense_fn
    if cls == "BatchNormalization":
        w = list(fetcher.fetch(name))
        # Keras's weight order: [gamma if scale] + [beta if center] +
        # [moving_mean, moving_variance]
        it = iter(w)
        gamma = next(it) if c.get("scale", True) else None
        beta = next(it) if c.get("center", True) else None
        mean, var = next(it), next(it)
        q = weights(
            ["gamma", "beta", "mean", "var"],
            [np.ones_like(mean) if gamma is None else gamma, np.zeros_like(mean) if beta is None else beta, mean, var],
        )
        eps = c.get("epsilon", 1e-3)

        def bn_fn(p, xs):
            x = xs[0]
            inv = torch.rsqrt(_channels(x, p[q["var"]]) + eps)
            return (x - _channels(x, p[q["mean"]])) * inv * _channels(x, p[q["gamma"]]) + _channels(x, p[q["beta"]])

        return bn_fn

    raise NotImplementedError(f"Keras layer type not supported: {cls} ({name})")
