"""meta_overlay's colocalization statistics on the card (twin of
``ecseg_tpu/ops/overlay_tpu.py``).

The reference computes its ten statistics with repeated skimage labelings
and a Python loop per component that rescans the whole image (reference
src/image_tools.py:103-134, meta_overlay.py:70-83).  Here every statistic
is a component labeling (kernel B2) or count (kernel B8a) plus at most one
scatter:

  count_colocalization(a, b) = the components of ``a`` that hold a pixel of
  ``b``: mark the label (the component's root index) of each of b's pixels,
  then count the marks.

:func:`overlay_stats` labels each mask that several statistics read once
(``ec``, ``fish_nc``, ``chrom``) and brings all ten statistics to the host
in one copy.  Counts are exact; the host oracles are ``ops/cc.count_cc``
and ``ops/meta_post.count_colocalization`` / ``count_HSR``.  On CPU tensors
the kernels' wrappers run their plain twins, so the same code is the CPU
path.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .cc_kernels import count_components, label
from .morphology_gpu import remove_small_objects

HSR_SIZE_THRESHOLD = 20  # reference src/meta_overlay.py:12


def _labels(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each pixel's 8-connected component root as a flat index, h*w on
    background; whether ``mask`` is all foreground)."""
    hw = mask.numel()
    lab = label(mask, 2).reshape(-1)
    return torch.where(lab < 0, hw, lab).long(), mask.all()


def _coloc(labels: Tuple[torch.Tensor, torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """The components of a labelled mask that hold a pixel of ``b``; 0 when
    the mask is all foreground (the reference's ``unique(labels)[1:]``
    drops its one component)."""
    flat, all_fg = labels
    hw = flat.numel()
    marks = torch.zeros(hw + 1, dtype=torch.bool, device=flat.device)
    marks[torch.where(b.reshape(-1), flat, hw)] = True
    return torch.where(all_fg, 0, marks[:hw].sum())


def count_cc_pair(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(components, foreground pixels) of a bool mask, 8-connected, as 0-d
    tensors (kernel B8a; the device twin of ``ops/cc.count_cc`` before
    :func:`cc_pair_host_quirk`)."""
    return count_components(mask.bool().contiguous(), 2)


def cc_pair_host_quirk(pair, hw: int):
    """``count_cc``'s ``unique(labels)[1:]`` quirk on a (num, fg) pair: an
    empty or all-foreground mask sums sizes over an empty list, so the
    second element is the float ``0.0`` (``np.sum([])``), which shows in
    fish_quantification.csv's tuple cells."""
    num, fg = pair
    if fg == 0 or fg == hw:
        return num, 0.0
    return num, fg


def count_colocalization(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The components of ``a`` that hold a pixel of ``b`` (0 when ``a`` is
    all foreground, as the host's ``unique(labels)[1:]`` gives)."""
    return _coloc(_labels(a.bool().contiguous()), b.bool())


def count_HSR(chrom: torch.Tensor, fish: torch.Tensor, hsr_size_threshold: int) -> torch.Tensor:
    """The chromosome components that hold a pixel of ``fish`` after its
    components under ``hsr_size_threshold`` pixels (4-connected, skimage's
    default) are removed."""
    big = remove_small_objects(fish.bool().contiguous(), hsr_size_threshold, connectivity=1)
    return _coloc(_labels(chrom.bool().contiguous()), big)


def overlay_stats(red, green, nuclei, chrom, ec, hsr_size_threshold: int = HSR_SIZE_THRESHOLD,
                  device: DeviceLike = None) -> Dict[str, object]:
    """All ten meta_overlay statistics of one image (reference
    meta_overlay.py:68-83, identical values) from its five (H, W) bool
    masks (numpy arrays, moved to ``device`` in one copy): a dict of ints
    and, for the three component counts, (components, foreground pixels)
    pairs of ints, before :func:`cc_pair_host_quirk`.  Five B2 labelings
    (``ec``, ``fish_nc``, ``chrom``, and the two size filters) and three
    B8a counts; the ten numbers come back in one device-to-host copy."""
    dev = resolve_device(device)
    planes = torch.from_numpy(np.stack([np.asarray(m, bool) for m in (red, green, nuclei, chrom, ec)])).to(dev)
    red, green, nuclei, chrom, ec = planes.unbind(0)
    fish = green & ~nuclei
    fish2 = red & ~nuclei
    nc = ~chrom
    fish_nc = fish & nc
    fish2_nc = fish2 & nc

    # one labeling per mask that several statistics read (ec serves 3,
    # chrom and fish_nc 2 each)
    ec_l, fish_nc_l, chrom_l = _labels(ec), _labels(fish_nc), _labels(chrom)

    def hsr(fish_ch):
        return _coloc(chrom_l, remove_small_objects(fish_ch, hsr_size_threshold, connectivity=1))

    # the pairs on B8a even where a labeling is at hand: on an H100 at 2048^2
    # it took 26-38 us, the labeling's root sums (compare, sum, pixel sum)
    # 102-103 us (scripts/cc_host_overhead.py pair_b8a, pair_roots)
    pairs = [count_cc_pair(m) for m in (ec, fish_nc, fish2_nc)]
    singles = [
        _coloc(ec_l, fish),
        hsr(fish),
        _coloc(fish_nc_l, fish2_nc),
        _coloc(ec_l, fish2),
        _coloc(ec_l, fish2 & fish),
        hsr(fish2),
    ]
    values = torch.stack([v.long() for pair in pairs for v in pair] + [v.long() for v in singles]).tolist()
    (n_ec, px_ec, n_fish, px_fish, n_fish2, px_fish2,
     ec_fish, hsr1, fish_fish2, ec_fish2, ec_fish_fish2, hsr2) = values
    return {
        "num_ecDNA": (n_ec, px_ec),
        "num_FISH": (n_fish, px_fish),
        "num_ecDNA_FISH": ec_fish,
        "num_HSR": hsr1,
        "num_FISH2": (n_fish2, px_fish2),
        "num_FISH_FISH2": fish_fish2,
        "num_ecDNA_FISH2": ec_fish2,
        "num_ecDNA_FISH_FISH2": ec_fish_fish2,
        "num_HSR2": hsr2,
    }
