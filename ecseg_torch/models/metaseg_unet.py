"""The metaseg 4-class segmentation U-Net (twin of
``ecseg_tpu/models/metaseg_unet.py``): input (N, 256, 256, 1) uint8 patches
(NHWC, the JAX layout), encoder widths ``ENC_WIDTHS`` with bottleneck
``BOTTLENECK`` by default or the XL widths, decoder with skip concats, 1x1
head, softmax in float32.

The forward computes in ``forward(x, dtype)``'s dtype, by default the
dtype of the model's weights.

- float32 is the parity path and mirrors the JAX package's
  ``Precision.HIGHEST``: on the card it runs under ``layers.parity_flags``
  (TF32 off, cuDNN deterministic, benchmark autotuning off; set around the
  forward, so the label bytes are stable from run to run).  The U-Net has
  no matmul; ``torch.backends.cuda.matmul.allow_tf32`` is left at
  PyTorch's default, False.  Autograd runs the backward after the forward
  has returned, outside these flags: a trainer enters them around the
  backward itself (``runtime/train.py``).
- bf16 (``model.to(torch.bfloat16)``, or ``dtype=torch.bfloat16`` on float32
  weights, as the JAX package trains with float32 parameters) is the
  throughput path and rounds where the JAX package's ``forward(...,
  dtype=jnp.bfloat16)`` rounds (``metaseg_unet.py:130-189``): the input
  divided by 255 in bf16; each kernel cast to bf16 inside its conv (so
  autograd returns float32 gradients to float32 weights), the conv's output
  rounded before the bias is added in bf16 (``layers.add_bias``); level 1
  always through ``_dec_first`` (two convs over the skip and the upsampled
  halves, no concat), levels >= 2 through the concat unless
  ``ECSEG_SPLIT_CONCAT`` is on; the head's logits to float32 before the
  softmax.

On the card, a float32 forward that builds no autograd graph sends its
3x3 convs to the hand-written kernel ``ops/conv3x3.conv3x3_relu`` (float32
FMAs in a fixed order, bias and ReLU fused, ``dec*_1``'s two halves read
in place): ``_kernel_route`` decides per forward, from the input's device
and dtype and whether autograd records (``layers.KernelRouted``, which the
NuSeT U-Net shares), and its transpose convs too where
``layers.transpose_on_kernel`` picks the kernel for the batch (a few
patches; 100 stay on cuDNN's dgrad).  Its activations are then
channels-last (NHWC in memory) through the trunk; the pools, the other
transpose convs and the head stay on cuDNN in that layout.  A shape the kernel
refuses goes to cuDNN and is counted in ``runtime/fallbacks``
(``conv3x3_cudnn``).  Every other forward (the CPU, autograd's, bf16,
``forward_cat1``) is the cuDNN path as described above.

The forward names its parts for a device trace: the profiler ranges
``metaseg.forward.encoder`` (the input's permute and scale, ``enc*`` and
the pools), ``metaseg.forward.decoder`` (``bott_*``, ``up*`` and
``dec4``-``dec2``) and ``metaseg.forward.head`` (``dec1_*``, ``head``, the
softmax); ``runtime/trace.region``, nothing when no profiler records.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
from torch import nn

from ..runtime.trace import region
from .layers import KernelRouted, SameConv2d, TFConvTranspose2d, conv_same, glorot_uniform_, max_pool_same, parity_flags

ENC_WIDTHS = (32, 64, 128, 256)
BOTTLENECK = 512
ENC_WIDTHS_XL = (64, 128, 256, 512)
BOTTLENECK_XL = 1024
NUM_CLASSES = 4
PATCH = 256


def split_concat() -> bool:
    """``ECSEG_SPLIT_CONCAT``, parsed as the JAX package parses it."""
    return os.environ.get("ECSEG_SPLIT_CONCAT", "0").strip().lower() in ("1", "true", "yes", "on")


def flops_per_patch(
    widths: Sequence[int] = ENC_WIDTHS,
    bottleneck: int = BOTTLENECK,
    in_ch: int = 1,
    num_classes: int = NUM_CLASSES,
    patch: int = PATCH,
) -> int:
    """Analytic forward FLOPs for one (patch, patch, in_ch) tile, transpose
    convs counted at their output resolution (``metaseg_unet.py:81-110``)."""
    f = 0
    s = patch * patch
    c = in_ch
    for w in widths:
        f += 2 * 9 * s * c * w + 2 * 9 * s * w * w
        c = w
        s //= 4
    f += 2 * 9 * s * c * bottleneck + 2 * 9 * s * bottleneck * bottleneck
    c = bottleneck
    for w in reversed(widths):
        s *= 4
        f += 2 * 9 * s * c * w
        f += 2 * 9 * s * (2 * w) * w
        f += 2 * 9 * s * w * w
        c = w
    f += 2 * s * c * num_classes
    return f


class MetasegUNet(KernelRouted):
    """Layers are named as the JAX parameter tree's keys (``enc1_1``,
    ``bott_2``, ``up3``, ``dec1_2``, ``head``, ...)."""

    def __init__(
        self,
        widths: Sequence[int] = ENC_WIDTHS,
        bottleneck: int = BOTTLENECK,
        in_ch: int = 1,
        num_classes: int = NUM_CLASSES,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.widths = tuple(widths)
        layers = {}
        c = in_ch
        for i, w in enumerate(self.widths, start=1):
            layers[f"enc{i}_1"] = SameConv2d(c, w, 3)
            layers[f"enc{i}_2"] = SameConv2d(w, w, 3)
            c = w
        layers["bott_1"] = SameConv2d(c, bottleneck, 3)
        layers["bott_2"] = SameConv2d(bottleneck, bottleneck, 3)
        c = bottleneck
        for i, w in zip(range(len(self.widths), 0, -1), reversed(self.widths)):
            layers[f"up{i}"] = TFConvTranspose2d(c, w)
            layers[f"dec{i}_1"] = SameConv2d(2 * w, w, 3)
            layers[f"dec{i}_2"] = SameConv2d(w, w, 3)
            c = w
        layers["head"] = SameConv2d(c, num_classes, 1)
        self.layers = nn.ModuleDict(layers)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in self.layers.values():
            glorot_uniform_(layer, generator)

    @property
    def dtype(self) -> torch.dtype:
        return self.layers["head"].weight.dtype

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A layer without its ReLU, in ``x``'s dtype: cuDNN's fused bias in
        float32, the kernel cast to ``x``'s dtype and the bias after the
        rounding otherwise."""
        layer = self.layers[name]
        return layer(x) if x.dtype == torch.float32 else layer.forward_bias_after(x)

    def _dec_first(self, skip: torch.Tensor, x: torch.Tensor, name: str) -> torch.Tensor:
        """``relu(conv(concat([skip, x]), K))`` as two convs over the halves
        of K's input channels, each rounded (``metaseg_unet.py:113-127``)."""
        layer = self.layers[name]
        cs = skip.shape[1]
        w = layer.weight.to(x.dtype)
        ya = conv_same(skip, w[:, :cs])
        yb = conv_same(x, w[:, cs:], layer.bias)
        return torch.relu(ya + yb)

    def _trunk_to_level1(self, x: torch.Tensor, dtype: torch.dtype, route: bool = False):
        """Encoder, bottleneck and decoder through ``up1``: (level-1 skip,
        upsampled level-1 feature), NCHW-shaped in ``dtype`` (channels-last
        on ``route``)."""
        split = dtype != torch.float32 and split_concat()
        with region("metaseg.forward.encoder"):
            x = x.permute(0, 3, 1, 2).to(dtype) / 255.0
            skips = []
            for i in range(1, len(self.widths) + 1):
                x = self._conv_relu(f"enc{i}_1", x, route=route)
                x = self._conv_relu(f"enc{i}_2", x, route=route)
                skips.append(x)
                x = max_pool_same(x)
        with region("metaseg.forward.decoder"):
            x = self._conv_relu("bott_1", x, route=route)
            x = self._conv_relu("bott_2", x, route=route)
            for i in range(len(self.widths), 1, -1):
                x = self._conv_transpose(f"up{i}", x, relu=True, route=route)
                if split:
                    x = self._dec_first(skips[i - 1], x, f"dec{i}_1")
                else:
                    x = self._conv_relu(f"dec{i}_1", skips[i - 1], x, route=route)
                x = self._conv_relu(f"dec{i}_2", x, route=route)
            return skips[0], self._conv_transpose("up1", x, relu=True, route=route)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(N, H, W, C) patches -> (N, H, W, num_classes) float32
        probabilities, computed in ``dtype`` (None: the weights' dtype)."""
        dtype = self.dtype if dtype is None else dtype
        route = self._kernel_route(x, dtype)
        with parity_flags():
            s1, xu = self._trunk_to_level1(x, dtype, route)
            with region("metaseg.forward.head"):
                if dtype == torch.float32:
                    x = self._conv_relu("dec1_1", s1, xu, route=route)
                else:
                    x = self._dec_first(s1, xu, "dec1_1")
                x = self._conv_relu("dec1_2", x, route=route)
                logits = self._conv("head", x)
                return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)

    def forward_cat1(self, x: torch.Tensor) -> torch.Tensor:
        """Everything up to the level-1 skip concat: the (N, H, W, 2 * width1)
        input of ``dec1_1``, NHWC and contiguous, in the model's dtype
        (``metaseg_unet.py:169-175``); the fused tail (kernel B10) takes over
        from there."""
        with parity_flags():
            s1, xu = self._trunk_to_level1(x, self.dtype)
            return torch.cat([s1, xu], dim=1).permute(0, 2, 3, 1).contiguous()
