"""The metaseg 4-class segmentation U-Net (twin of
``ecseg_tpu/models/metaseg_unet.py``): input (N, 256, 256, 1) uint8 patches
(NHWC, the JAX layout), encoder widths ``ENC_WIDTHS`` with bottleneck
``BOTTLENECK`` by default or the XL widths, decoder with skip concats, 1x1
head, softmax in float32.

The float32 forward is the parity path and mirrors the JAX package's
``Precision.HIGHEST``: on the card it runs with TF32 off and cuDNN in
deterministic mode, benchmark autotuning off (set around the forward, so the
label bytes are stable from run to run).  The U-Net has no matmul;
``torch.backends.cuda.matmul.allow_tf32`` is left at PyTorch's default,
False.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import SameConv2d, TFConvTranspose2d, glorot_uniform_, max_pool_same

ENC_WIDTHS = (32, 64, 128, 256)
BOTTLENECK = 512
ENC_WIDTHS_XL = (64, 128, 256, 512)
BOTTLENECK_XL = 1024
NUM_CLASSES = 4
PATCH = 256


class MetasegUNet(nn.Module):
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

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        L = self.layers
        x = x.permute(0, 3, 1, 2).float() / 255.0
        skips = []
        for i in range(1, len(self.widths) + 1):
            x = torch.relu(L[f"enc{i}_1"](x))
            x = torch.relu(L[f"enc{i}_2"](x))
            skips.append(x)
            x = max_pool_same(x)
        x = torch.relu(L["bott_1"](x))
        x = torch.relu(L["bott_2"](x))
        for i in range(len(self.widths), 0, -1):
            x = torch.relu(L[f"up{i}"](x))
            x = torch.cat([skips[i - 1], x], dim=1)
            x = torch.relu(L[f"dec{i}_1"](x))
            x = torch.relu(L[f"dec{i}_2"](x))
        logits = L["head"](x)
        return torch.softmax(logits.float(), dim=1).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) patches -> (N, H, W, num_classes) probabilities."""
        with torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False
        ):
            return self._forward(x)
