"""Weights of the metaseg U-Net from the seed, made on the device in one
draw, named as ``MetasegUNet``'s state dict (OIHW convs, (in, out, kh,
kw) transpose convs).

Every layer starts Glorot-uniform (TF's fan_avg over HWIO fans, biases
zero), so the deep layers run at full cost on seeded values.  Then the
benchmark's own copy of the demo's surgery, so the classes follow the
image: the level-1 convs pass the brightness ``b`` on channel 0, and the
head maps bands of ``b`` to the four classes (background < 0.3 < nuclei
< 0.5 < chromosome < 0.7 < ecDNA).  Unlike the demo, ``dec1_1`` also
adds a seeded mix of the upsampled deep features (``TRUNK_GAIN`` times
a vector of +-1 draws): the deep trunk then moves pixels near the band
edges, so a forward computed in a lower precision changes labels.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

TRUNK_GAIN = 0.5  # per upsampled level-1 channel, into the brightness channel of dec1_1
HEAD_SLOPES = (0.0, 20.0, 40.0, 60.0)  # class logit = slope * b + bias
HEAD_BIASES = (6.0, 0.0, -10.0, -24.0)


def shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], int, int]]:
    """(layer, weight shape, fan_in, fan_out) in ``MetasegUNet``'s order."""
    out, c = [], cfg["in_channels"]
    widths, bott = cfg["widths"], cfg["bottleneck"]
    for i, w in enumerate(widths, 1):
        out += [(f"enc{i}_1", (w, c, 3, 3), 9 * c, 9 * w), (f"enc{i}_2", (w, w, 3, 3), 9 * w, 9 * w)]
        c = w
    out += [("bott_1", (bott, c, 3, 3), 9 * c, 9 * bott), ("bott_2", (bott, bott, 3, 3), 9 * bott, 9 * bott)]
    c = bott
    for i, w in zip(range(len(widths), 0, -1), reversed(widths)):
        out += [(f"up{i}", (c, w, 3, 3), 9 * c, 9 * w), (f"dec{i}_1", (w, 2 * w, 3, 3), 18 * w, 9 * w),
                (f"dec{i}_2", (w, w, 3, 3), 9 * w, 9 * w)]
        c = w
    out.append(("head", (cfg["num_classes"], c, 1, 1), c, cfg["num_classes"]))
    return out


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    layers = shapes(cfg)
    w1 = cfg["widths"][0]
    sizes = [math.prod(s) for _, s, _, _ in layers]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(sizes) + w1, generator=gen, device=device, dtype=torch.float32)
    params, offset = {}, 0
    for (name, shape, fan_in, fan_out), n in zip(layers, sizes):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        params[f"layers.{name}.weight"] = (draw[offset : offset + n] * (2 * limit) - limit).view(shape)
        params[f"layers.{name}.bias"] = torch.zeros(shape[1] if name.startswith("up") else shape[0], device=device)
        offset += n
    signs = torch.where(draw[offset:] < 0.5, -1.0, 1.0)
    for name in ("enc1_1", "enc1_2", "dec1_1", "dec1_2"):
        k = torch.zeros_like(params[f"layers.{name}.weight"])
        k[0, 0, 1, 1] = 1.0
        params[f"layers.{name}.weight"] = k
    params["layers.dec1_1.weight"][0, w1:, 1, 1] = TRUNK_GAIN * signs
    head = torch.zeros_like(params["layers.head.weight"])
    head[:, 0, 0, 0] = torch.tensor(HEAD_SLOPES, device=device)
    params["layers.head.weight"] = head
    params["layers.head.bias"] = torch.tensor(HEAD_BIASES, device=device)
    return params
