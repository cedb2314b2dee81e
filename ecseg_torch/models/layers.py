"""Conv-net layers with the TF semantics of ``ecseg_tpu/models/layers.py``,
in PyTorch's NCHW/OIHW layout.

- ``SameConv2d``: stride-1 'SAME' convolution with an odd kernel (symmetric
  padding k // 2).  ``forward_bias_after`` (both conv layers) is the bf16
  form: the kernel cast to the input's dtype, the conv without bias,
  rounded, then the bias added in the same dtype.
- ``TFConvTranspose2d``: tf conv2d_transpose(kernel 3, stride 2, 'SAME'),
  whose grad-of-conv padding is (0, 1); that equals the FULL torch
  ``conv_transpose2d`` (padding 0) truncated to stride x input, as pinned in
  tests/test_layers.py.  Its weight is (in, out, kh, kw), the JAX HWIO
  kernel permuted with no flip (JAX flips inside conv2d_transpose).
- ``max_pool_same``: 2x2/2 'SAME' max pool (``ceil_mode`` pads at the end,
  as TF does for odd sizes).
- ``glorot_uniform_``: TF's VarianceScaling(fan_avg, uniform) with HWIO fan
  counts, from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    """``y + bias`` in ``y``'s dtype, as the JAX package adds a conv's bias
    after the conv output is rounded to its dtype (``layers.py:47-48``);
    cuDNN's fused bias would add it before the rounding."""
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """Stride-1 'SAME' conv with an odd OIHW kernel, bias added after the
    rounding (``add_bias``)."""
    return add_bias(F.conv2d(x, weight, None, padding=weight.shape[-1] // 2), bias)


class SameConv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2)

    def forward_bias_after(self, x: torch.Tensor) -> torch.Tensor:
        return conv_same(x, self.weight.to(x.dtype), self.bias)


class TFConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 2):
        super().__init__(cin, cout, k, stride=stride)

    def _truncate(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        return y[..., : x.shape[-2] * s, : x.shape[-1] * s]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._truncate(x, super().forward(x))

    def forward_bias_after(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), None, self.stride)
        return add_bias(self._truncate(x, y), self.bias)


def parity_flags():
    """cuDNN settings under which the float32 convs keep their parity with
    the JAX package's ``Precision.HIGHEST``: no TF32, deterministic
    algorithms, no autotuning."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def glorot_uniform_(layer: nn.Module, generator: torch.Generator) -> None:
    """Glorot-uniform weight (fan_in = kh*kw*in, fan_out = kh*kw*out, as the
    JAX initializer counts them on HWIO) and zero bias."""
    wt = layer.weight
    if isinstance(layer, nn.ConvTranspose2d):
        cin, cout, kh, kw = wt.shape
    else:
        cout, cin, kh, kw = wt.shape
    limit = math.sqrt(6.0 / (kh * kw * cin + kh * kw * cout))
    with torch.no_grad():
        u = torch.rand(wt.shape, generator=generator, dtype=torch.float32)
        wt.copy_(u * (2 * limit) - limit)
        layer.bias.zero_()
