"""NuSeT: the foreground U-Net and the region-proposal network (twin of
``ecseg_tpu/models/nuset.py:48-168``, reference
src/model_layers/models.py:5-136 and model_RPN.py:5-46), NCHW float32.

- encoder: two 3x3 'SAME' conv + ReLU per level at 64, 128, 256, 512, a 2x2
  max pool after each; the last pooled map is the RPN's feature;
- bottleneck 1024, 1024;
- decoder: 3x3 stride-2 transpose convs 512 -> 256 -> 128 -> 64.
  ``deconv4`` is followed by ReLU and no skip; the others by a skip concat
  (skip first) and no ReLU;
- ``final``: a 3x3 conv to 2 classes with no bias;
- RPN: a 3x3x512 conv with no activation, then 1x1 heads whose outputs are
  read in NHWC order as (H*W*A, 2) scores (softmax) and (H*W*A, 4) deltas.

Layer names are the JAX package's parameter-tree keys, so the weight bridge
(``models/weights.py``) maps them one to one.  Every conv adds its bias after
the conv output is rounded (``layers.conv_same``), as the JAX layers do.  The
forward runs under ``layers.parity_flags``: deterministic, no autotuning,
no TF32.  Input sides must be multiples of 16.

On the card, a float32 forward of float32 weights that builds no autograd
graph (``layers.KernelRouted``, as metaseg's) sends the U-Net's 18 ReLU'd
3x3 convs to the hand-written kernel ``ops/conv3x3.conv3x3_relu`` (float32
FMAs in a fixed order, then the bias, then the ReLU; ``conv{3,2,1}-3`` read
the skip and the transpose conv's output in place, with no concat), and
its four transpose convs too, as 3x3 convs of the zero-spread input
(``layers.transpose_on_kernel`` picks that for a pass's one image: there
cuDNN's deterministic float32 transpose convs take FFT tiling with batched
GEMVs, which took most of a pass).  Its activations are then
channels-last; the pools, ``final`` and the RPN stay on cuDNN in that
layout.  A shape the kernel
refuses goes to cuDNN and is counted in ``runtime/fallbacks``
(``conv3x3_cudnn``).  Every other forward keeps ``conv_same`` and the
transpose convs' ``forward_bias_after`` throughout.  Under a profiler the U-Net
opens the ranges ``nuset.forward.encoder`` (levels 1-4 and their pools),
``.decoder`` (the bottleneck, the transpose convs, levels 4-1) and
``.head`` (``final``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..runtime.trace import region
from .layers import KernelRouted, SameConv2d, TFConvTranspose2d, conv_same, max_pool_same, parity_flags

ENC_WIDTHS = (64, 128, 256, 512)
BOTTLENECK = 1024
NB_CLASSES = 2
RPN_WIDTH = 512
NUM_REF_ANCHORS = 21  # 3 scales x 7 aspect ratios (models/nuset_infer.py)


def _glorot_(weight: torch.Tensor, fan_in: int, fan_out: int, generator: Optional[torch.Generator]) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(weight.shape, generator=generator, dtype=torch.float32)
    weight.copy_(u * (2 * limit) - limit)


class NuSeTUNet(KernelRouted):
    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        L: Dict[str, nn.Module] = {}
        c = 1
        for i, w in enumerate(ENC_WIDTHS, start=1):
            L[f"conv{i}-1"] = SameConv2d(c, w, 3)
            L[f"conv{i}-2"] = SameConv2d(w, w, 3)
            c = w
        L["conv5-1"] = SameConv2d(c, BOTTLENECK, 3)
        L["conv5-2"] = SameConv2d(BOTTLENECK, BOTTLENECK, 3)
        up_in = BOTTLENECK
        for i, w in zip((4, 3, 2, 1), ENC_WIDTHS[::-1]):
            L[f"deconv{i}"] = TFConvTranspose2d(up_in, w)
            # level 4 has no skip: its first conv takes the transpose conv's
            # width; the others take skip + upsampled
            L[f"conv{i}-3"] = SameConv2d(w if i == 4 else 2 * w, w, 3)
            L[f"conv{i}-4"] = SameConv2d(w, w, 3)
            up_in = w
        L["final"] = nn.Conv2d(ENC_WIDTHS[0], NB_CLASSES, 3, padding=1, bias=False)
        self.layers = nn.ModuleDict(L)
        with torch.no_grad():
            for layer in self.layers.values():
                o, i, kh, kw = layer.weight.shape
                if isinstance(layer, nn.ConvTranspose2d):
                    o, i = i, o  # (in, out, kh, kw)
                _glorot_(layer.weight, kh * kw * i, kh * kw * o, generator)
                if layer.bias is not None:
                    layer.bias.zero_()

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = self.layers[name]
        if isinstance(layer, TFConvTranspose2d):
            return layer.forward_bias_after(x)
        return conv_same(x, layer.weight, layer.bias)

    def _block(self, a: str, b: str, x: torch.Tensor, x2: Optional[torch.Tensor] = None, route: bool = False) -> torch.Tensor:
        return self._conv_relu(b, self._conv_relu(a, x, x2, route), route=route)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(1, 1, H, W) normalized image -> (logits (1, 2, H, W), RPN feature
        (1, 512, H/16, W/16)); both channels-last when the 3x3 convs ran on
        the kernel."""
        route = self._kernel_route(x, x.dtype)
        with parity_flags():
            skips = []
            with region("nuset.forward.encoder"):
                for i in range(1, 5):
                    x = self._block(f"conv{i}-1", f"conv{i}-2", x, route=route)
                    skips.append(x)
                    x = max_pool_same(x)
            feat = x
            with region("nuset.forward.decoder"):
                x = self._block("conv5-1", "conv5-2", x, route=route)
                x = self._conv_transpose("deconv4", x, relu=True, route=route)
                x = self._block("conv4-3", "conv4-4", x, route=route)
                for i in (3, 2, 1):
                    up = self._conv_transpose(f"deconv{i}", x, relu=False, route=route)
                    x = self._block(f"conv{i}-3", f"conv{i}-4", skips[i - 1], up, route=route)
            with region("nuset.forward.head"):
                return conv_same(x, self.layers["final"].weight), feat


class NuSeTRPN(nn.Module):
    def __init__(self, num_anchors: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleDict({
            "rpn_conv": SameConv2d(RPN_WIDTH, RPN_WIDTH, 3),
            "rpn_cls_score": SameConv2d(RPN_WIDTH, 2 * num_anchors, 1),
            "rpn_bbox_pred": SameConv2d(RPN_WIDTH, 4 * num_anchors, 1),
        })
        with torch.no_grad():
            for name, std in (("rpn_conv", 0.01), ("rpn_cls_score", 0.01), ("rpn_bbox_pred", 0.001)):
                layer = self.layers[name]
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator) * std)
                layer.bias.zero_()

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        layer = self.layers[name]
        return conv_same(x, layer.weight, layer.bias)

    def forward(self, feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(1, 512, h, w) feature -> scores (h*w*A, 2), their softmax and
        deltas (h*w*A, 4), anchor-major within a cell, cells row-major."""
        with parity_flags():
            rpn = self._conv("rpn_conv", feat)
            score = self._conv("rpn_cls_score", rpn).permute(0, 2, 3, 1).reshape(-1, 2)
            bbox = self._conv("rpn_bbox_pred", rpn).permute(0, 2, 3, 1).reshape(-1, 4)
        return {"rpn_cls_prob": torch.softmax(score, dim=-1), "rpn_cls_score": score, "rpn_bbox_pred": bbox}


def pred_mask(logits: torch.Tensor) -> torch.Tensor:
    """Per-pixel argmax of (1, 2, H, W) logits: (H, W) bool foreground.
    ``torch.argmax`` and ``jnp.argmax`` both take the first of equal
    maxima, so a tie is background on both sides."""
    return logits[0].argmax(dim=0) == 1
