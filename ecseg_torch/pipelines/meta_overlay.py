"""meta_overlay: FISH colocalization statistics on metaseg's outputs, on the
card (twin of ``ecseg_tpu/pipelines/meta_overlay.py``, its single-device
path).

Parity target: reference src/meta_overlay.py:14-102 and the FISH split at
src/image_tools.py:136-146.  Per RGB image: threshold red and green at
``color_sensitivity``, write the inverted channels to ``red/<name>.png``
and ``green/<name>.png``, read metaseg's ``labels/<name>.npy``, compute the
ten statistics (``ops/overlay_gpu.overlay_stats``: kernels B2 and B8a) and
emit ``fish_quantification.csv`` in the reference's column order, with the
three component counts stored as ``(count, total_px)`` tuples (reference
meta_overlay.py:70-71,79 stores image_tools.py:114-119's raw tuple).  The
decode, the split and its PNG writes run on reader threads
(``runtime/batching.prefetch_map``) while the main thread drives the card.
Non-RGB inputs are skipped; a folder with no RGB image gets no CSV (the
reference crashes there; README "Deliberate deviations").
``ECSEG_DEVICE_PIPELINE=0`` computes the statistics by the host oracles
instead (:func:`host_stats`, the JAX package's host branch).

On more than one device (``main(devices=...)``; by default every card) the
images fan out as in ``meta_overlay.py:182-202``: one worker thread per
entry, image k on entry k % n (its read, split and statistics), rows in
input order, so the CSV and PNG bytes are the sequential run's.
``ECSEG_OVERLAY_SHARD=0`` forces the sequential path.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple, Union

import numpy as np

from ..core import imgio
from ..core.config import Config, ConfigError, load_config
from ..core.csvio import write_csv
from ..device import DeviceLike, DevicesLike, entry_devices
from ..ops.cc import count_cc
from ..ops.meta_post import count_colocalization, count_HSR
from ..ops.overlay_gpu import HSR_SIZE_THRESHOLD, cc_pair_host_quirk, overlay_stats
from ..runtime.batching import fan_out, prefetch_map
from ..runtime.devicepath import shard_enabled, use_device_path
from ..runtime.hostmem import tune_host_allocator
from ..runtime.trace import stage

FIRST_FISH, SECOND_FISH = "green", "red"
# the CSV's columns (reference meta_overlay.py:97-99) and the statistic each holds
COLUMNS = (
    ("image_name", None),
    ("# of ecDNA (DAPI)", "num_ecDNA"),
    (f"# of ecDNA ({FIRST_FISH})", "num_FISH"),
    (f"# of ecDNA ({SECOND_FISH})", "num_FISH2"),
    (f"# of ecDNA (DAPI and {FIRST_FISH})", "num_ecDNA_FISH"),
    (f"# of ecDNA (DAPI and {SECOND_FISH})", "num_ecDNA_FISH2"),
    (f"# of ecDNA ({SECOND_FISH} and {FIRST_FISH})", "num_FISH_FISH2"),
    (f"# of ecDNA (DAPI and {SECOND_FISH} and {FIRST_FISH})", "num_ecDNA_FISH_FISH2"),
    (f"# of HSR ({SECOND_FISH})", "num_HSR2"),
    (f"# of HSR ({FIRST_FISH})", "num_HSR"),
)
PAIRS = ("num_ecDNA", "num_FISH", "num_FISH2")  # stored as (count, px) tuples


def split_FISH_channels(
    I: np.ndarray, image_path: str, sensitivity: int
) -> Union[int, Tuple[np.ndarray, np.ndarray]]:
    """Threshold the red and green channels, writing their inverted 8-bit
    images to red/ and green/ (reference src/image_tools.py:136-146).
    Returns 0 for a non-RGB input (the caller's skip signal)."""
    head, tail = os.path.split(image_path)
    if len(I.shape) < 3:
        print(image_path, " isn't an RGB image. Therefore, no FISH signals could be identified. Skipping...")
        return 0
    I = imgio.u16_to_u8(I)
    imgio.save_gray_inverted(os.path.join(head, "red", tail + ".png"), I[..., 0])
    imgio.save_gray_inverted(os.path.join(head, "green", tail + ".png"), I[..., 1])
    return I[..., 0] > sensitivity, I[..., 1] > sensitivity


def read_seg(image_path: str):
    """labels/<name>.npy -> its four class masks (reference src/utils.py:125-132)."""
    head, tail = os.path.split(image_path)
    seg = np.load(os.path.join(head, "labels", tail[:-4] + ".npy"))
    return seg == 0, seg == 1, seg == 2, seg == 3


def _read_split(image_path: str, sensitivity: int):
    """Host stage of one image: decode, split (two PNG writes) and its label
    masks; None for a non-RGB image."""
    print("Processing image: ", image_path)
    with stage("meta_overlay.read+split"):
        res = split_FISH_channels(imgio.imread_rgb(image_path), image_path, sensitivity)
        if not isinstance(res, tuple):
            return None
        _, nuclei, chrom, ec = read_seg(image_path)
        return res + (nuclei, chrom, ec)


def host_stats(red, green, nuclei, chrom, ec, hsr_size_threshold: int = HSR_SIZE_THRESHOLD) -> dict:
    """The nine statistics by the host oracles on numpy masks, the JAX
    package's host branch (``meta_overlay.py:155-167``, the reference's
    dataflow, meta_overlay.py:68-83), keyed as ``overlay_stats``'s.  The
    pairs are ``count_cc``'s tuples, which ``cc_pair_host_quirk`` leaves as
    they are."""
    fish, fish2 = green & ~nuclei, red & ~nuclei
    return {
        "num_ecDNA": count_cc(ec),
        "num_FISH": count_cc(fish & ~chrom),
        "num_ecDNA_FISH": count_colocalization(ec, fish),
        "num_HSR": count_HSR(chrom, fish, hsr_size_threshold),
        "num_FISH2": count_cc(fish2 & ~chrom),
        "num_FISH_FISH2": count_colocalization(fish & ~chrom, fish2 & ~chrom),
        "num_ecDNA_FISH2": count_colocalization(ec, fish2),
        "num_ecDNA_FISH_FISH2": count_colocalization(ec, fish2 & fish),
        "num_HSR2": count_HSR(chrom, fish2, hsr_size_threshold),
    }


def image_row(name: str, stats: dict, hw: int) -> list:
    """One CSV row, in ``COLUMNS`` order, from ``overlay_stats``'s or
    :func:`host_stats`'s output."""
    cells = {k: cc_pair_host_quirk(v, hw) if k in PAIRS else v for k, v in stats.items()}
    return [name] + [cells[key] for _, key in COLUMNS[1:]]


def main(argv=None, config: Optional[Config] = None, device: DeviceLike = None, devices: DevicesLike = None) -> int:
    """``device``: one device; ``devices``: a device list to fan the images
    out over; neither: every card."""
    tune_host_allocator()
    mesh = entry_devices(device, devices)
    if config is None:
        config = load_config()
    try:
        var = config.meta_overlay
    except ConfigError as e:
        print(str(e))
        return 2
    inpath = var.inpath
    sensitivity = var.color_sensitivity

    if not os.path.isdir(inpath):
        print("Input folder does not exist. Exiting...")
        return 2
    for sub in ("labels", "dapi"):
        if not os.path.isdir(os.path.join(inpath, sub)):
            print(f"`{sub}` folder is missing in the input folder.")
            print(
                "Please make sure metaseg was run on the input folder first. This will generate the labels folder."
            )
            return 2

    os.makedirs(os.path.join(inpath, "red"), exist_ok=True)
    os.makedirs(os.path.join(inpath, "green"), exist_ok=True)

    image_paths = imgio.get_imgs(inpath)
    device_path = use_device_path()

    def row(path, masks, dev):
        if masks is None:
            return None
        with stage("meta_overlay.stats"):
            stats = overlay_stats(*masks, HSR_SIZE_THRESHOLD, device=dev) if device_path else host_stats(*masks)
        return image_row(os.path.basename(path), stats, masks[2].size)

    if len(mesh) > 1 and shard_enabled("ECSEG_OVERLAY_SHARD"):
        results = fan_out(lambda p, k: row(p, _read_split(p, sensitivity), mesh[k]), image_paths, mesh)
    else:
        results = (row(p, masks, mesh[0]) for p, masks in prefetch_map(lambda p: _read_split(p, sensitivity), image_paths))
    rows = [r for r in results if r is not None]

    if not rows:
        # (the reference crashes reordering an empty frame; this exits)
        return 0
    write_csv(
        os.path.join(os.path.dirname(image_paths[-1]), "fish_quantification.csv"),
        [name for name, _ in COLUMNS],
        rows,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
