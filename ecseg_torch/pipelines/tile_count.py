"""The per-tile ecDNA-count program (twin of ``bench.py``'s ``tile_fn``,
``bench.py:49-142``, without its timing harness): per 1024^2 tile, 25
overlapping 256^2 patches -> the U-Net forward in bf16 -> exact uint8
quantize -> argmax -> the overlap stitch + ``== 3`` + component count in one
kernel (B8b).  The fused-tail variant runs the trunk through
``forward_cat1``, then kernel B10 (dec1_1, dec1_2, head, softmax, quantize,
argmax), then B8b.  The forward runs over all T * 25 patches of a batch of T
tiles at once, and B8b counts the T tiles in one launch.

The weights are ``bench._realistic_params``'s: the port's own seeded init,
with the level-1 convs set to pass brightness through and the head to call
class 3 (ecDNA) where brightness exceeds ~0.7, so the counted masks look like
a trained model's.  The tiles are bench's recipe, byte for byte for the same
``n`` and seed.

    from ecseg_torch.pipelines import tile_count
    counts, px = tile_count.run("default", n_tiles=32)            # the card
    counts, px = tile_count.run("xl", n_tiles=2, device="cpu")    # CPU twins
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.metaseg_unet import BOTTLENECK, BOTTLENECK_XL, ENC_WIDTHS, ENC_WIDTHS_XL, MetasegUNet
from ..ops import cc_kernels as K
from ..ops import tiling
from ..ops.fused_tail import fused_dec1_head

TILE = 1024
EC_CLASS = 3
# arch -> (encoder widths, bottleneck, tiles per batch), bench.py:78-83
ARCHS = {
    "default": (ENC_WIDTHS, BOTTLENECK, 32),
    "xl": (ENC_WIDTHS_XL, BOTTLENECK_XL, 8),
}


def realistic_model(
    arch: str = "default", generator: Optional[torch.Generator] = None, dtype: torch.dtype = torch.bfloat16
) -> MetasegUNet:
    """A U-Net of ``arch``'s widths on ``generator``'s init, with ``bench._realistic_params``'s surgery: ``enc1_1``,
    ``enc1_2``, ``dec1_1`` and ``dec1_2`` pass input channel 0 through their
    centre tap with zero bias; the head maps channel 0 to class 3 with gain
    20 and the bias is (14, 0, 0, 0); then cast to ``dtype``."""
    widths, bottleneck, _ = ARCHS[arch]
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
        k[EC_CLASS, 0, 0, 0] = 20.0  # class 3 wins where brightness > ~0.7
        head.weight.copy_(k)
        head.bias.copy_(torch.tensor([14.0, 0.0, 0.0, 0.0]))
    return model.to(dtype).eval()


def synthetic_tiles(n: int, seed: int = 0) -> np.ndarray:
    """(n, 1024, 1024) uint8 tiles, bench's recipe (``bench.py:207-215``) in
    its draw order: dark noise below 80, then per tile 120 bright (230)
    squares of side 2..6, the ecDNA-like blobs the program counts."""
    rng = np.random.default_rng(seed)
    tiles = (rng.random((n, TILE, TILE)) * 80).astype(np.uint8)
    for b in range(n):
        for _ in range(120):
            y, x = rng.integers(0, TILE - 12), rng.integers(0, TILE - 12)
            r = rng.integers(2, 7)
            tiles[b, y : y + r, x : x + r] = 230
    return tiles


def tile_patches(tiles: np.ndarray):
    """(T, 1024, 1024) uint8 -> ((T, 25, 256, 256, 1) uint8 patches, the
    patch positions)."""
    positions = tuple(map(tuple, tiling.patch_positions(TILE, TILE)))
    patches = np.stack([tiling.im2patches_overlap(t[..., None])[1] for t in tiles])
    return patches, positions


def dec1_head_weights(model: MetasegUNet):
    """(w1, b1, w2, b2, wh, bh) of the fused tail in the JAX layout (HWIO
    kernels) from the model's ``dec1_1``, ``dec1_2`` and ``head``."""
    out = []
    for name in ("dec1_1", "dec1_2", "head"):
        layer = model.layers[name]
        out += [layer.weight.permute(2, 3, 1, 0), layer.bias]
    return tuple(out)


def patch_labels(model: MetasegUNet, patches: torch.Tensor, fused_tail: bool = False) -> torch.Tensor:
    """(T, 25, 256, 256, 1) uint8 patches -> (T, 25, 256, 256) class labels
    (uint8, or B10's int32): the forward over all T * 25 patches in one
    batch, then the quantize and argmax (or ``forward_cat1`` and B10)."""
    flat = patches.reshape((-1,) + tuple(patches.shape[2:]))
    with torch.no_grad():
        if fused_tail:
            labels = fused_dec1_head(model.forward_cat1(flat), *dec1_head_weights(model))
        else:
            labels = tiling.patch_labels(model(flat))
    return labels.reshape(tuple(patches.shape[:2]) + tuple(labels.shape[1:]))


def count_tiles(
    model: MetasegUNet, patches: torch.Tensor, positions, fused_tail: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per tile (ecDNA components, ecDNA pixels), int32 (T,) each: the patch
    labels, then B8b over the T tiles in one launch."""
    labels = patch_labels(model, patches, fused_tail)
    return K.count_from_patches(labels, positions, class_id=EC_CLASS, connectivity=2)


def run(
    arch: str = "default",
    n_tiles: Optional[int] = None,
    fused_tail: bool = False,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The tile-count program on ``n_tiles`` synthetic tiles (bench's count
    for ``arch`` by default) with the realistic weights, both from seed 0;
    returns (counts, px) per tile.  ``device=None`` is the card and raises
    without one."""
    dev = resolve_device(device)
    model = realistic_model(arch, torch.Generator().manual_seed(0)).to(dev)
    patches, positions = tile_patches(synthetic_tiles(n_tiles or ARCHS[arch][2], 0))
    counts, px = count_tiles(model, torch.from_numpy(patches).to(dev), positions, fused_tail)
    return counts.cpu().numpy(), px.cpu().numpy()
