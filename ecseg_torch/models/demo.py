"""Deterministic demo weights for the metaseg U-Net (twin of
``ecseg_tpu/models/demo.py:35-51``): the level-1 encoder/decoder convs pass
input brightness ``b`` to the head, whose argmax maps brightness bands to
classes -- background < ~0.3 < nuclei < ~0.7 < ecDNA (chromosomes unused).
All other layers keep their seeded random init and run at full cost.  Not a
trained model."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .metaseg_unet import BOTTLENECK, ENC_WIDTHS, MetasegUNet


def demo_metaseg_params(
    generator: Optional[torch.Generator] = None,
    widths: Sequence[int] = ENC_WIDTHS,
    bottleneck: int = BOTTLENECK,
) -> MetasegUNet:
    """A crafted U-Net on ``generator``-seeded deep layers."""
    model = MetasegUNet(widths, bottleneck, generator=generator)
    with torch.no_grad():
        for name in ("enc1_1", "enc1_2", "dec1_1", "dec1_2"):
            conv = model.layers[name]
            k = torch.zeros_like(conv.weight)
            k[0, 0, k.shape[2] // 2, k.shape[3] // 2] = 1.0
            conv.weight.copy_(k)
            conv.bias.zero_()
        head = model.layers["head"]
        k = torch.zeros_like(head.weight)
        k[1, 0, 0, 0] = 20.0  # nuclei logit = 20 b
        k[3, 0, 0, 0] = 40.0  # ecDNA  logit = 40 b - 14 (wins for b > 0.7)
        head.weight.copy_(k)
        head.bias.copy_(torch.tensor([6.0, 0.0, -1e3, -14.0]))
    return model
