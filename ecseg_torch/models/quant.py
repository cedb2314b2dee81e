"""Post-training int8 inference for the metaseg U-Net (twin of
``ecseg_tpu/models/quant.py``; the same names and scheme):

- weights: per-output-channel symmetric int8, ``scale = max|W| / 127`` per
  output channel (axis 3 of the JAX HWIO kernel, for a transpose conv the
  output channel of the op), quantized once (:func:`quantize_unet`, from
  the JAX parameter tree as numpy);
- activations: dynamic per-tensor symmetric int8, ``sx = max|x| / 127``
  per conv input;
- accumulation: int32, then ``y.bf16 * (sx * scale).bf16 + bias.bf16``
  rounded per op in bf16, then ReLU;
- ``enc1_1`` (one input channel) stays a bf16 float conv by default.

The JAX package leaves its int8 convs to XLA (``conv_general_dilated`` with
``preferred_element_type=int32``).  PyTorch has no int8 convolution on
CUDA, so each one is an im2col (the ``kh * kw`` shifted views of the padded
NHWC input, concatenated on the channel axis) and ``torch._int_mm``, the
int8 GEMM with int32 accumulation (cuBLASLt on the card).  The stride-2
transpose conv is the JAX zero-insertion form: the input dilated by 2,
padded by ``(k - 1 - pad_lo, k - 1 - pad_hi)``, the flipped kernel.  The
GEMM's k and n are padded with zeros to multiples of 8 and its m to at
least 17, as the card's ``_int_mm`` asks (exact), and the batch is chunked
so that one im2col slab holds at most ``SLAB_BYTES``.  The int32 sums are
exact, so they equal XLA's bit for bit; the bf16 rescale may differ from
XLA:CPU's, which can keep the product in float32 before the bias add
(ROADMAP deviation 10).

Not a parity path: no entry point runs it.  ``QuantMetasegUNet`` holds the
quantized tree in torch layouts (OIHW, transpose kernels (in, out, kh, kw))
and runs :func:`forward` on it.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import add_bias, conv_same, max_pool_same

DEFAULT_SKIP = ("enc1_1",)
SLAB_BYTES = 1 << 30  # the int8 im2col slab of one GEMM chunk


def _f32(a) -> torch.Tensor:
    """float32 tensor of a tensor (on its device) or of a numpy-like array
    (a copy: JAX's arrays are read-only)."""
    return a.float() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, dtype=np.float32))


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, on every device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which can differ from the
    quotient in the last bit."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_kernel(kernel) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an HWIO kernel (numpy or a
    tensor on any device): ``(kernel_q int8, scale float32[cout])`` with
    ``kernel ~= kernel_q * scale``."""
    k = _f32(kernel)
    scale = _div(k.abs().amax(dim=(0, 1, 2)), 127.0) + 1e-12
    return torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8), scale


def quantize_unet(params: Dict, skip: Sequence[str] = DEFAULT_SKIP) -> Dict:
    """Quantize a metaseg U-Net parameter tree (the JAX tree as numpy:
    ``{"enc1_1": {"kernel": HWIO, "bias": (O,)}, ...}``).  Layers named in
    ``skip`` keep their float kernels and run in bf16.  CPU tensors."""
    qp: Dict = {}
    for name, p in params.items():
        if name in skip:
            qp[name] = {k: _f32(v) for k, v in p.items()}
            continue
        kq, scale = quantize_kernel(p["kernel"])
        qp[name] = {"kernel_q": kq, "scale": scale}
        if "bias" in p:
            qp[name]["bias"] = _f32(p["bias"])
    return qp


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: ``(x_q int8, sx float32 scalar)``."""
    xf = x.float()
    sx = _div(xf.abs().amax(), 127.0) + 1e-12
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def _transpose_pads(k: int, stride: int) -> Tuple[int, int]:
    """The grad-of-conv padding of a TF 'SAME' transpose conv (the JAX
    package's ``_pad``, ``quant.py:96-101``)."""
    pad_total = max(k - stride, 0)
    pad_lo = pad_total // 2
    return k - 1 - pad_lo, k - 1 - (pad_total - pad_lo)


def _int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.t()`` for int8 ``a`` (m, k) and ``b_t`` (n, k), k and n
    multiples of 8: int32 (m, n).  ``b_t.t()`` is the column-major operand
    cuBLASLt's int8 GEMM takes."""
    if not hasattr(torch, "_int_mm"):
        raise RuntimeError(f"torch {torch.__version__} has no torch._int_mm: no int8 GEMM to run the int8 U-Net on")
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a, b_t.t())[:m]


def qconv_int32(xq: torch.Tensor, kq: torch.Tensor, transpose: bool = False, stride: int = 2) -> torch.Tensor:
    """The int32 accumulators of an int8 conv: ``xq`` (N, H, W, C) int8,
    ``kq`` HWIO int8 -> (N, H', W', O) int32; 'SAME' stride 1, or with
    ``transpose`` the TF 'SAME' stride-``stride`` transpose conv (output
    ``stride`` x the input)."""
    kh, kw, cin, cout = kq.shape
    n, h, w, _ = xq.shape
    if transpose:
        (ylo, yhi), (xlo, xhi) = _transpose_pads(kh, stride), _transpose_pads(kw, stride)
        xp = xq.new_zeros((n, (h - 1) * stride + 1 + ylo + yhi, (w - 1) * stride + 1 + xlo + xhi, cin))
        xp[:, ylo : ylo + (h - 1) * stride + 1 : stride, xlo : xlo + (w - 1) * stride + 1 : stride] = xq
        kq = kq.flip(0, 1)
        out_h, out_w = h * stride, w * stride
    else:
        xp = F.pad(xq, (0, 0, (kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
        out_h, out_w = h, w
    kdim = kh * kw * cin
    kpad, npad = -kdim % 8, -cout % 8
    b_t = F.pad(kq.reshape(kdim, cout).t(), (0, kpad, 0, npad)).contiguous()
    out = torch.empty((n, out_h, out_w, cout), dtype=torch.int32, device=xq.device)
    per = max(1, SLAB_BYTES // (out_h * out_w * (kdim + kpad)))
    for i in range(0, n, per):
        xs = xp[i : i + per]
        views = [xs[:, dy : dy + out_h, dx : dx + out_w] for dy in range(kh) for dx in range(kw)]
        if kpad:
            views.append(xs.new_zeros(xs.shape[:1] + (out_h, out_w, kpad)))
        cols = torch.cat(views, dim=-1).reshape(-1, kdim + kpad)
        out[i : i + per] = _int_mm(cols, b_t)[:, :cout].reshape(-1, out_h, out_w, cout)
    return out


def _float_conv(x: torch.Tensor, p: Dict, transpose: bool, stride: int) -> torch.Tensor:
    """A layer left in float (``skip``): the JAX package's bf16 conv, the
    kernel cast to ``x``'s dtype and the bias added after the rounding;
    NHWC in and out."""
    k = p["kernel"].to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    if transpose:
        y = F.conv_transpose2d(xc, k.permute(2, 3, 0, 1), None, stride)[..., : xc.shape[2] * stride, : xc.shape[3] * stride]
        y = add_bias(y, p.get("bias"))
    else:
        y = conv_same(xc, k.permute(3, 2, 0, 1), p.get("bias"))
    return y.permute(0, 2, 3, 1)


def qconv2d(x: torch.Tensor, p: Dict, *, transpose: bool = False, stride: int = 2) -> torch.Tensor:
    """int8 conv (or stride-2 transpose conv) of NHWC ``x`` with int32
    accumulation and the bf16 rescale; the float bf16 conv for a layer
    without ``kernel_q``."""
    if "kernel_q" not in p:
        return _float_conv(x, p, transpose, stride)
    xq, sx = quantize_activation(x)
    y = qconv_int32(xq, p["kernel_q"], transpose, stride)
    y = y.to(torch.bfloat16) * (sx * p["scale"]).to(torch.bfloat16)
    if p.get("bias") is not None:
        y = y + p["bias"].to(torch.bfloat16)
    return y


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return max_pool_same(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def forward(qparams: Dict, x: torch.Tensor) -> torch.Tensor:
    """int8 twin of the metaseg U-Net's forward: (N, H, W, C) uint8 patches
    -> (N, H, W, 4) float32 softmax probabilities (softmax in float32)."""
    levels = max(int(k[3]) for k in qparams if k.startswith("enc"))
    x = _div(x.to(torch.bfloat16), 255.0)
    skips = []
    for i in range(1, levels + 1):
        x = torch.relu(qconv2d(x, qparams[f"enc{i}_1"]))
        x = torch.relu(qconv2d(x, qparams[f"enc{i}_2"]))
        skips.append(x)
        x = _max_pool(x)
    x = torch.relu(qconv2d(x, qparams["bott_1"]))
    x = torch.relu(qconv2d(x, qparams["bott_2"]))
    for i in range(levels, 0, -1):
        x = torch.relu(qconv2d(x, qparams[f"up{i}"], transpose=True))
        x = torch.cat([skips[i - 1].to(x.dtype), x], dim=-1)
        x = torch.relu(qconv2d(x, qparams[f"dec{i}_1"]))
        x = torch.relu(qconv2d(x, qparams[f"dec{i}_2"]))
    return torch.softmax(qconv2d(x, qparams["head"]).float(), dim=-1)


def _torch_layout(kernel: torch.Tensor, transpose: bool) -> torch.Tensor:
    """HWIO -> OIHW, or (in, out, kh, kw) for a transpose conv."""
    return kernel.permute(2, 3, 0, 1) if transpose else kernel.permute(3, 2, 0, 1)


def _hwio(weight: torch.Tensor, transpose: bool) -> torch.Tensor:
    """Inverse of :func:`_torch_layout` (a view)."""
    return weight.permute(2, 3, 0, 1) if transpose else weight.permute(2, 3, 1, 0)


class QuantLayer(nn.Module):
    """One layer of :func:`quantize_unet`'s tree: ``weight`` (int8 with
    ``scale``, or float for a skipped layer) in the torch layout, ``bias``."""

    def __init__(self, p: Dict, transpose: bool):
        super().__init__()
        self.transpose = transpose
        self.quantized = "kernel_q" in p
        kernel = p["kernel_q"] if self.quantized else p["kernel"]
        self.register_buffer("weight", _torch_layout(kernel, transpose).contiguous())
        self.register_buffer("scale", p.get("scale"))
        self.register_buffer("bias", p.get("bias"))

    def tree(self) -> Dict:
        p = {"kernel_q" if self.quantized else "kernel": _hwio(self.weight, self.transpose), "bias": self.bias}
        if self.quantized:
            p["scale"] = self.scale
        return p


class QuantMetasegUNet(nn.Module):
    """The int8 metaseg U-Net (``quantize_unet``'s tree in torch layouts):
    (N, 256, 256, 1) uint8 patches -> (N, 256, 256, 4) float32
    probabilities, like ``MetasegUNet``."""

    def __init__(self, qparams: Dict):
        super().__init__()
        self.layers = nn.ModuleDict({name: QuantLayer(p, name.startswith("up")) for name, p in qparams.items()})

    def tree(self) -> Dict:
        """The quantized tree, HWIO views of the buffers."""
        return {name: layer.tree() for name, layer in self.layers.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.tree(), x)
