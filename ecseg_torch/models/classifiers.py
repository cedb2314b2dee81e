"""The ecSeg-i and ecSeg-c per-nucleus classifiers (twin of
``ecseg_tpu/models/classifiers.py``), the default architectures that
interseg runs when no ``.h5`` model is supplied:

- ecSeg-i: (N, 256, 256) uint8 target-FISH channel -> (N, 3) softmax over
  {No-amp, EC-amp, HSR-amp};
- ecSeg-c: (N, 256, 256, 3) preprocessed floats in [0, 1] -> (N, 1) sigmoid
  P(Focal-amp).

Both: four blocks of 3x3 'SAME' conv (32, 64, 128, 256 channels), ReLU and
a 2x2 max pool, then the global mean and a dense head.  Layers are named as
the JAX parameter tree's keys (``conv1`` .. ``conv4``, ``head``), so the
weight bridge (``models/weights.py``) maps them one to one.  Each conv adds
its bias after the conv (``layers.conv_same``) and the head is
``feat @ kernel + bias``, as the JAX forwards compute them.  float32 only,
under ``layers.parity_flags`` (no TF32 in cuDNN; cuBLAS's float32 matmul
keeps PyTorch's default, no TF32): the JAX head is a ``Precision.HIGHEST``
dot.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .layers import SameConv2d, conv_same, glorot_uniform_, max_pool_same, parity_flags

WIDTHS = (32, 64, 128, 256)


class _Classifier(nn.Module):
    def __init__(self, in_ch: int, classes: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = {}
        c = in_ch
        for i, w in enumerate(WIDTHS, start=1):
            layers[f"conv{i}"] = SameConv2d(c, w, 3)
            c = w
        layers["head"] = nn.Linear(c, classes)
        self.layers = nn.ModuleDict(layers)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        # the JAX init's distributions: glorot-uniform convs, a normal(0.01)
        # head, zero biases (classifiers.py:30-76)
        with torch.no_grad():
            for i in range(1, len(WIDTHS) + 1):
                glorot_uniform_(self.layers[f"conv{i}"], generator)
            head = self.layers["head"]
            head.weight.copy_(torch.randn(head.weight.shape, generator=generator) * 0.01)
            head.bias.zero_()

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW float32 -> (N, classes) logits."""
        for i in range(1, len(WIDTHS) + 1):
            conv = self.layers[f"conv{i}"]
            x = max_pool_same(torch.relu(conv_same(x, conv.weight, conv.bias)))
        feat = x.mean(dim=(2, 3))
        head = self.layers["head"]
        return torch.matmul(feat, head.weight.t()) + head.bias


class EcsegI(_Classifier):
    """(N, 256, 256) uint8 -> (N, 3) float32 softmax."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__(1, 3, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with parity_flags():
            # a division, as the JAX forward divides (not a reciprocal product)
            return torch.softmax(self._logits(x.to(torch.float32)[:, None] / 255.0), dim=-1)


class EcsegC(_Classifier):
    """(N, 256, 256, 3) float -> (N, 1) float32 sigmoid."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__(3, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with parity_flags():
            return torch.sigmoid(self._logits(x.to(torch.float32).permute(0, 3, 1, 2)))


def flops_per_patch(in_ch: int, patch: int = 256) -> int:
    """Multiply-add FLOPs of one patch's convs (the pools, mean and head are
    below 0.1 %)."""
    f, c, s = 0, in_ch, patch * patch
    for w in WIDTHS:
        f += 2 * 9 * s * c * w
        c, s = w, math.ceil(math.sqrt(s) / 2) ** 2
    return f
