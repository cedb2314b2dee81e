"""Deterministic demo weights (twin of ``ecseg_tpu/models/demo.py``).  The
metaseg U-Net's level-1 encoder/decoder convs pass input brightness ``b`` to
the head, whose argmax maps brightness bands to classes -- background < ~0.3
< nuclei < ~0.7 < ecDNA (chromosomes unused); the NuSeT U-Nets pass it to
their class-1 logit.  All other layers keep their seeded random init and run
at full cost.  The interseg classifiers carry brightness through every conv
block to a hand-set head, so no random draw survives in them.  Not trained
models."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .classifiers import WIDTHS as CLASSIFIER_WIDTHS
from .metaseg_unet import BOTTLENECK, ENC_WIDTHS, MetasegUNet
from .nuset import NUM_REF_ANCHORS, NuSeTRPN, NuSeTUNet
from .weights import tree_from_modules


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


def _pass_k(shape, src: int, dst: int, gain: float = 1.0) -> np.ndarray:
    """An HWIO kernel whose centre tap copies channel ``src`` to ``dst``."""
    k = np.zeros(shape, np.float32)
    k[shape[0] // 2, shape[1] // 2, src, dst] = gain
    return k


def demo_nuset_unet_tree(generator: Optional[torch.Generator], thresh: float) -> Dict:
    """A NuSeT U-Net tree whose class-1 logit is 5 * relu(brightness -
    thresh) through the level-1 skip (twin of
    ``ecseg_tpu/models/demo.py:54-75``); the deep layers keep their
    ``generator``-seeded init and run at full cost."""
    tree = tree_from_modules(NuSeTUNet(generator))
    bias1 = np.zeros(64, np.float32)
    bias1[0] = -thresh
    tree["conv1-1"] = {"kernel": _pass_k((3, 3, 1, 64), 0, 0), "bias": bias1}
    for name, cin in (("conv1-2", 64), ("conv1-3", 128), ("conv1-4", 64)):
        tree[name] = {"kernel": _pass_k((3, 3, cin, 64), 0, 0), "bias": np.zeros(64, np.float32)}
    fk = np.zeros((3, 3, 64, 2), np.float32)
    fk[1, 1, 0, 1] = 5.0
    tree["final"] = {"kernel": fk}
    return tree


def demo_nuset_tree(generator: Optional[torch.Generator] = None) -> Dict:
    """The ``{"whole", "fg": {"unet", "rpn"}}`` tree that ``models/nuset.npz``
    stores (twin of ``ecseg_tpu/models/demo.py:78-94``): the whole-image
    pass thresholds the normalized brightness at 0.5, the foreground pass at
    -5; the RPN keeps its seeded init.  Not a trained model."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return {
        "whole": demo_nuset_unet_tree(generator, thresh=0.5),
        "fg": {
            "unet": demo_nuset_unet_tree(generator, thresh=-5.0),
            "rpn": tree_from_modules(NuSeTRPN(NUM_REF_ANCHORS, generator)),
        },
    }


def _demo_classifier_tree(in_ch: int, head: np.ndarray, bias) -> Dict:
    """Channel 0 of every conv block passes the input's channel 0 through
    (ReLU and max pool keep it), so the global mean's feature 0 is the
    patch's pooled brightness; every other feature is 0."""
    tree, c = {}, in_ch
    for i, w in enumerate(CLASSIFIER_WIDTHS, start=1):
        tree[f"conv{i}"] = {"kernel": _pass_k((3, 3, c, w), 0, 0), "bias": np.zeros(w, np.float32)}
        c = w
    tree["head"] = {"kernel": head, "bias": np.array(bias, np.float32)}
    return tree


def demo_ecseg_i_tree() -> Dict:
    """ecSeg-i whose prediction is brightness-banded (twin of
    ``ecseg_tpu/models/demo.py:106-120``): dim -> No-amp, medium -> EC-amp,
    bright -> HSR-amp."""
    head = np.zeros((CLASSIFIER_WIDTHS[-1], 3), np.float32)
    head[0, 1] = 30.0  # EC-amp logit = 30 b (beats No-amp's 3 for b > 0.1)
    head[0, 2] = 60.0  # HSR-amp logit = 60 b - 21 (beats EC-amp for b > 0.7)
    return _demo_classifier_tree(1, head, [3.0, 0.0, -21.0])


def demo_ecseg_c_tree() -> Dict:
    """ecSeg-c whose P(Focal-amp) is sigmoid(20 b - 5) of the pooled
    brightness b (twin of ``ecseg_tpu/models/demo.py:123-135``)."""
    head = np.zeros((CLASSIFIER_WIDTHS[-1], 1), np.float32)
    head[0, 0] = 20.0
    return _demo_classifier_tree(3, head, [-5.0])
