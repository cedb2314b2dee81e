"""fish_distance_calculation: normalized FISH-to-centromere distances (twin
of ``ecseg_tpu/pipelines/fish_distance.py``).  Host only: it launches no
kernel and needs no card.

Contract (reference src/fish_distance_calculation.py:15-83): for every
nucleus in ``__segmentation_min_cut.npy``, if both of the first two LSQ
channels have signal inside the nucleus, report

    min over (fish px f, centromere px c) of ||f - c||  /  sqrt(cell area)

skipping nuclei whose FISH channel splits into more than
``max_centromeric_spots`` 8-connected blobs; emit every value (one per kept
nucleus, images flattened in glob order) as the single
``normalized_distance`` column of ``centromere_distances.csv``.

The minimum over fish pixels of the distance to the nearest centromere
pixel is the minimum pairwise set distance, so each cell is one KD-tree
nearest-neighbour query (scipy ``cKDTree``) instead of the reference's
per-fish-pixel Python loop, with identical results.

Quirks preserved from the reference:
  * the presence gate tests channels 0 and 1 specifically, NOT the
    configured probe indices (fish_distance_calculation.py:20);
  * a gated-in cell whose configured FISH channel is empty contributes
    ``inf`` (the reference appends inf and finds no blobs to relax it);
  * a gated-in cell with FISH signal but an empty configured centromere
    channel is an error (the reference crashes on an empty-array min).
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np
from scipy import ndimage as ndi
from scipy.spatial import cKDTree

from ..core import imgio
from ..core.config import Config, load_config
from ..core.csvio import write_csv
from ..ops.cc import count_cc
from ..runtime.hostmem import tune_host_allocator


def min_set_distance(fish_yx: np.ndarray, cent_yx: np.ndarray) -> float:
    """Minimum Euclidean distance between two pixel-coordinate sets."""
    if len(fish_yx) == 0:
        return float("inf")
    if len(cent_yx) == 0:
        raise ValueError("centromere channel empty inside a gated-in cell (the reference errors on this input too)")
    dists, _ = cKDTree(cent_yx).query(fish_yx, k=1)
    return float(np.min(dists))


def iter_cell_masks(segmentation: np.ndarray) -> Iterator[Tuple[int, Tuple[slice, slice]]]:
    """(label, bounding slice) of every nonzero label, ascending (skimage
    regionprops' order), from one ``find_objects`` pass."""
    if not np.issubdtype(segmentation.dtype, np.integer):
        segmentation = segmentation.astype(np.int64)
    for lab, sl in enumerate(ndi.find_objects(segmentation), start=1):
        if sl is not None:
            yield lab, sl


def image_distances(
    lsq: np.ndarray, segmentation: np.ndarray, centromere_idx: int, fish_idx: int, max_spots: int
) -> List[float]:
    """All normalized distances of one image (one entry per kept cell)."""
    out: List[float] = []
    for lab, sl in iter_cell_masks(segmentation):
        inside = segmentation[sl] == lab
        crop = lsq[sl]
        # presence gate on channels 0 and 1: a reference quirk (module doc)
        if not ((crop[..., 0] != 0) & inside).any():
            continue
        if not ((crop[..., 1] != 0) & inside).any():
            continue
        fish = (crop[..., fish_idx] != 0) & inside
        n_blobs, _ = count_cc(fish)  # 8-connected, as skimage's label by default
        if n_blobs > max_spots:
            continue
        cent = (crop[..., centromere_idx] != 0) & inside
        d = min_set_distance(np.argwhere(fish), np.argwhere(cent))
        out.append(d / np.sqrt(inside.sum()))
    return out


def folder_distances(root: str, centromere_idx: int, fish_idx: int, max_spots: int) -> List[float]:
    """Walk ``<root>/*.tif``, pair each with its stat_fish outputs under
    ``<root>/annotated/<name>/`` and flatten all per-cell distances."""
    out: List[float] = []
    for img_path in glob.glob(f"{root}/*.tif"):
        name = os.path.basename(img_path)[:-4]
        ann_dir = f"{root}/annotated/{name}"
        if not os.path.isdir(ann_dir):
            raise FileNotFoundError(f"{ann_dir}: no stat_fish outputs for {img_path}")
        segmentation = np.load(f"{ann_dir}/{name}__segmentation_min_cut.npy")
        lsq = imgio.imread_rgb(glob.glob(f"{ann_dir}/{name}_lsq*.tif")[0])
        out.extend(image_distances(lsq, segmentation, centromere_idx, fish_idx, max_spots))
    return out


def get_distances_img(lsq, segmentation, presets) -> List[float]:
    """:func:`image_distances` with ``presets`` = (centromere index, FISH
    index, max spots), the JAX module's signature."""
    centromere_idx, fish_idx, max_spots = presets
    return image_distances(lsq, segmentation, centromere_idx, fish_idx, max_spots)


def get_distances_path(root_directory: str, *presets) -> List[float]:
    """:func:`folder_distances` of ``root_directory``."""
    return folder_distances(root_directory, *presets)


def main(argv=None, config: Optional[Config] = None) -> int:
    tune_host_allocator()
    if config is None:
        config = load_config()
    var = config.fish_distance_calculation
    directory = var.inpath
    if not os.path.exists(f"{directory}/annotated"):
        raise FileNotFoundError(f"{directory}/annotated does not exist: run stat_fish on {directory} first")
    distances = folder_distances(
        directory, var.centromere_probe_index, var.fish_probe_index, var.max_centromeric_spots
    )
    write_csv(f"{directory}/centromere_distances.csv", ["normalized_distance"], [(d,) for d in distances])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
