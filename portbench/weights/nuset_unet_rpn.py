"""Weights of NuSeT (both U-Nets and the RPN) from the seed, made on the
device in one draw, as three state dicts named as ``NuSeTUNet``'s and
``NuSeTRPN``'s (OIHW convs, (in, out, kh, kw) transpose convs):
``{"whole": ..., "fg": ..., "rpn": ...}``.

Every U-Net layer starts Glorot-uniform (TF's fan_avg over HWIO fans,
biases zero), so the deep layers run at full cost on seeded values; the
RPN starts from NuSeT's own normal initializers (``RPN_STD``, as the
port's ``NuSeTRPN`` draws them), so its boxes stay near their anchors and
every seed keeps about as many of them through the NMS.  Then the
benchmark's own copy of the confident demo pattern, so the masks follow
the image and the watershed runs with markers:

- in each U-Net the level-1 convs pass the normalized brightness ``b`` to
  ``final``, whose class-1 logit is ``5 * relu(b - thresh + gain * mix)``
  against a class-0 logit of 0 (thresh 0.5 for the whole-image pass, -3
  for the foreground pass).  ``mix`` is a seeded +-1 mix of the upsampled
  deep features that ``conv1-3`` adds (``TRUNK_GAIN`` a channel): the deep
  trunk moves mask pixels whose brightness lies near the threshold, at
  nucleus edges.  The head's path carries ``b`` on channel 0 with an
  offset, ``SHIFT``, that ``conv1-1`` adds and ``conv1-3`` takes away: the
  ReLUs between them keep ``b`` whole, and a forward in a lower precision
  rounds the offset coarsely (TF32: 64 * 2^-11), which moves edge pixels.
  The trunk reads channel 1, ``relu(b - thresh)``: the brightness above
  the threshold, so the mix is 0 far from the nuclei and the background
  stays background on every seed;
- the RPN's class-1 score bias is 6 on every anchor, so its proposals
  score above ``min_score`` 0.95 and place markers, less a fixed ramp over
  the 21 anchor shapes (:func:`score_ramp`): the seeded scores then order
  boxes within a shape and not the shapes, and the NMS keeps about as many
  boxes on every seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

TRUNK_GAIN = 2.0  # per upsampled level-1 channel, into the brightness channel of conv1-3
SHIFT = 64.0  # keeps relu(b - thresh + SHIFT) linear near the threshold; its TF32 rounding moves edge pixels
THRESH = {"whole": 0.5, "fg": -3.0}
FINAL_GAIN = 5.0
SCORE_BIAS = 6.0  # class-1 logit bias of every anchor
RAMP_STEP = 0.05  # class-1 logit offset between anchor shapes in rank order
RPN_STD = (0.01, 0.01, 0.001)  # NuSeT's normal initializers of rpn_conv, rpn_cls_score, rpn_bbox_pred


def unet_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """(layer, weight shape, fan_in, fan_out) of one U-Net, in ``NuSeTUNet``'s order."""
    out, c = [], cfg["in_channels"]
    widths, bott = cfg["widths"], cfg["bottleneck"]
    for i, w in enumerate(widths, 1):
        out += [(f"conv{i}-1", (w, c, 3, 3), 9 * c, 9 * w), (f"conv{i}-2", (w, w, 3, 3), 9 * w, 9 * w)]
        c = w
    out += [("conv5-1", (bott, c, 3, 3), 9 * c, 9 * bott), ("conv5-2", (bott, bott, 3, 3), 9 * bott, 9 * bott)]
    c = bott
    n = len(widths)
    for i, w in zip(range(n, 0, -1), reversed(widths)):
        cin = w if (i == n and not cfg["level4_skip"]) else 2 * w
        out += [(f"deconv{i}", (c, w, 3, 3), 9 * c, 9 * w), (f"conv{i}-3", (w, cin, 3, 3), 9 * cin, 9 * w),
                (f"conv{i}-4", (w, w, 3, 3), 9 * w, 9 * w)]
        c = w
    out.append(("final", (cfg["num_classes"], c, 3, 3), 9 * c, 9 * cfg["num_classes"]))
    return out


def rpn_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    r, a = cfg["rpn_width"], len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    return [("rpn_conv", (r, cfg["widths"][-1], 3, 3), 9 * cfg["widths"][-1], 9 * r),
            ("rpn_cls_score", (2 * a, r, 1, 1), r, 2 * a), ("rpn_bbox_pred", (4 * a, r, 1, 1), r, 4 * a)]


def _glorot(layers, draw, offset, device, bias_of=lambda name, shape: shape[0]) -> Tuple[Dict, int]:
    params = {}
    for name, shape, fan_in, fan_out in layers:
        n = math.prod(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        params[f"layers.{name}.weight"] = (draw[offset : offset + n] * (2 * limit) - limit).view(shape)
        if name != "final":
            params[f"layers.{name}.bias"] = torch.zeros(bias_of(name, shape), device=device)
        offset += n
    return params, offset


def _pass(params: Dict, name: str, bias: float = 0.0) -> None:
    """``name``'s centre tap copies channel 0 to channel 0; nothing else."""
    k = torch.zeros_like(params[f"layers.{name}.weight"])
    k[0, 0, 1, 1] = 1.0
    params[f"layers.{name}.weight"] = k
    b = torch.zeros_like(params[f"layers.{name}.bias"])
    b[0] = bias
    params[f"layers.{name}.bias"] = b


def make(cfg: Dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    unet, rpn = unet_shapes(cfg), rpn_shapes(cfg)
    w1 = cfg["widths"][0]
    total = 2 * sum(math.prod(s) for _, s, _, _ in unet) + 2 * w1
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for tag in ("whole", "fg"):
        params, offset = _glorot(unet, draw, offset, device, lambda name, shape: shape[1] if name.startswith("deconv") else shape[0])
        _pass(params, "conv1-1", SHIFT - THRESH[tag])
        _pass(params, "conv1-2")
        _pass(params, "conv1-3", -SHIFT)
        _pass(params, "conv1-4")
        # the trunk reads channel 1, relu(b - thresh), not the head's channel 0
        params["layers.conv1-1.weight"][1, 0, 1, 1] = 1.0
        params["layers.conv1-1.bias"][1] = -THRESH[tag]
        params["layers.conv1-2.weight"][1, 1, 1, 1] = 1.0
        params["layers.conv2-1.weight"][:, 0] = 0.0
        signs = torch.where(draw[offset : offset + w1] < 0.5, -1.0, 1.0)
        offset += w1
        params["layers.conv1-3.weight"][0, w1:, 1, 1] = TRUNK_GAIN * signs
        final = torch.zeros_like(params["layers.final.weight"])
        final[1, 0, 1, 1] = FINAL_GAIN
        params["layers.final.weight"] = final
        out[tag] = params
    normal = torch.randn(sum(math.prod(shape) for _, shape, _, _ in rpn), generator=gen, device=device)
    params, offset = {}, 0
    for (name, shape, _, _), std in zip(rpn, RPN_STD):
        n = math.prod(shape)
        params[f"layers.{name}.weight"] = (normal[offset : offset + n] * std).view(shape)
        params[f"layers.{name}.bias"] = torch.zeros(shape[0], device=device)
        offset += n
    params["layers.rpn_cls_score.bias"][1::2] = SCORE_BIAS + torch.tensor(score_ramp(cfg), device=device)
    out["rpn"] = params
    return out


def score_ramp(cfg: Dict) -> List[float]:
    """The class-1 logit offset of each of the 21 anchors (ratio-major,
    scale-minor, as the anchors are generated): ``-RAMP_STEP`` times the
    anchor's rank by its distance from the square anchor of scale 1
    (|log2 ratio| + |log2 scale|, then ratio and scale), the same for every
    seed.  It outweighs the seeded scores' spread, so every seed sends the
    same anchor shapes into the NMS and keeps about as many boxes."""
    kinds = [(r, s) for r in cfg["anchor_ratios"] for s in cfg["anchor_scales"]]
    order = sorted(range(len(kinds)), key=lambda a: (abs(math.log2(kinds[a][0])) + abs(math.log2(kinds[a][1])),) + kinds[a])
    ramp = [0.0] * len(kinds)
    for rank, a in enumerate(order):
        ramp[a] = -RAMP_STEP * rank
    return ramp
