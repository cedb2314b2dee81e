"""Conv-net layers with the TF semantics of ``ecseg_tpu/models/layers.py``,
in PyTorch's NCHW/OIHW layout.

- ``SameConv2d``: stride-1 'SAME' convolution with an odd kernel (symmetric
  padding k // 2).
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


class SameConv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2)


class TFConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 2):
        super().__init__(cin, cout, k, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        y = super().forward(x)
        return y[..., : x.shape[-2] * s, : x.shape[-1] * s]


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
