"""stat_fish: per-nucleus FISH quantification in interphase images on the
card (twin of ``ecseg_tpu/pipelines/stat_fish.py:57-496``, its single-device
path; reference src/stat_fish.py:144-317).

Per image: decode (``cv2.imread`` semantics, 8-bit BGR) and the NuSeT host
prep on two reader threads -> NuSeT nuclei segmentation on the card
(``models/nuset_infer``: both U-Net passes, proposals, the certified
watershed on kernel B3, the cleanup on kernel B2) -> on a pool of tail
workers (two; ``ECSEG_STAT_FISH_TAIL_WORKERS``): min-cut splitting of touching nuclei (host C++), the matched-filter
FISH detection (device conv), per-nucleus statistics, and the writes --
``<name>__segmentation_min_cut.npy`` and five TIFFs per image in
``annotated/<name>/`` and one ``stat_fish_lsq.csv``.  Outputs go to a
``tmp_<MM-DD_HH:MM:SS>`` folder renamed to ``annotated/`` at the end (an
earlier ``annotated/`` is archived with a time stamp), with copies of the
config (named by the git commit) and of the params file.

``scale: auto`` resolves on the first image and the number serves the rest
(reference stat_fish.py:228): the other tails wait for it.  Results are
gathered in submission order, so the CSV's rows keep the input order.
``device_path`` (default: ``runtime/devicepath.use_device_path()``, so
``ECSEG_DEVICE_PIPELINE=0`` sets it False) False runs the host cleanup
chain and the host matched filter instead (the JAX package's CPU default;
the tests' oracle).  ``ECSEG_FAST_WATERSHED`` picks the watershed's mode
(``models/nuset_infer.watershed_pass``).

On more than one device (``main(devices=...)``; by default every card) the
images fan out as in ``stat_fish.py:366-474``: the NuSeT model replicated
per entry, one worker thread per entry running the whole image there, tail
included, image k on entry k % n, at most two images in flight an entry,
the CSV in input order; with ``scale: auto`` image 0 runs alone on entry 0
before the fan-out starts.  ``ECSEG_STAT_FISH_SHARD=0`` keeps the
single-card path (the main thread and ``tail_workers()`` tails).

Not ported (ROADMAP): geometry bucketing and the 1-bit transfers (they
serve XLA's compile cache and the TPU host link).
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import dataclasses
import datetime
import os
import shutil
import subprocess as sp
import sys
import threading
from collections import deque
from typing import Optional

import numpy as np

from ..core import imgio
from ..core.config import Config, default_params_path, load_config, load_stat_fish_params
from ..core.csvio import write_csv
from ..device import DeviceLike, DevicesLike, entry_devices
from ..models import nuset_infer
from ..models.weights import load_nuset_model
from ..ops import matched_filter as mf
from ..ops import maxflow, region_stats
from ..ops.cc import label as cc_label
from ..runtime import fallbacks
from ..runtime.batching import fan_out, prefetch_map
from ..runtime.devicepath import shard_enabled, use_device_path
from ..runtime.trace import stage

AQUA_RGB = [233, 137, 54]  # reference stat_fish.py:163
FISH_NAMES = ("green", "red", "aqua")


def tail_workers() -> int:
    """The single-card path's tail pool size: ``ECSEG_STAT_FISH_TAIL_WORKERS``
    (default 2, at least 1), parsed as the JAX package parses it
    (``ecseg_tpu/pipelines/stat_fish.py:381-383``); a value that is not an
    integer raises."""
    return max(1, int(os.environ.get("ECSEG_STAT_FISH_TAIL_WORKERS", "2") or 2))


def csv_header(n_fish: int):
    cols = ["image_name", "nucleus_center"]
    for name in FISH_NAMES[:n_fish]:
        cols += [f"#_FISH_pixels ({name})", f"#_FISH_foci ({name})", f"Avg fish intensity ({name})", f"Max fish intensity ({name})"]
    return cols + ["#_DAPI_pixels", "#_FISH_pixels (green and red)", "#_FISH_foci (green and red)"]


def csv_rows(per_image):
    """The CSV rows of every image's rows, as ``pd.concat`` of the JAX
    package's per-image frames writes them: an image with no nucleus gives
    a frame of empty float64 columns, and concatenating it makes every
    integer column float64, so the integers are then written as floats
    (``27.0``)."""
    rows = [row for image_rows in per_image for row in image_rows]
    if all(per_image):
        return rows
    return [tuple(float(c) if isinstance(c, int) else c for c in row) for row in rows]


def _git_commit() -> str:
    """The last commit's hash as ``git log -1 | head -1`` names it (empty
    outside a repository), as the JAX package names the config copy."""
    out = sp.run("git log -1 | head -1", shell=True, capture_output=True)
    return out.stdout.decode().strip().split(" ")[-1]


def main(
    argv=None,
    config: Optional[Config] = None,
    params=None,
    device: DeviceLike = None,
    device_path: Optional[bool] = None,
    devices: DevicesLike = None,
) -> int:
    """``device``: one device; ``devices``: a device list to fan the images
    out over; neither: every card."""
    mesh = entry_devices(device, devices)
    dev = mesh[0]
    if device_path is None:
        device_path = use_device_path()
    if config is None:
        config = load_config()
    if params is None:
        params = load_stat_fish_params()
    var = config.stat_fish
    inpath = var.inpath
    color_sensitivity = list(params.color_sensitivity)
    scaling_factor = var.scale

    if not os.path.isdir(inpath):
        print("Input folder does not exist. Exiting...")
        return 2

    output_folder = f"tmp_{datetime.datetime.now().strftime('%m-%d_%H:%M:%S')}"
    os.makedirs(os.path.join(inpath, output_folder), exist_ok=True)
    if config.path and os.path.exists(config.path):
        shutil.copyfile(config.path, os.path.join(inpath, output_folder, f"config_{_git_commit()}.yaml"))
    params_src = params.path or default_params_path()
    if os.path.exists(params_src):
        shutil.copyfile(params_src, os.path.join(inpath, output_folder, "stat_fish_params.yaml"))

    model = load_nuset_model(
        device=dev, bbox_min_score=params.min_score, nms_threshold=params.nms_threshold, resize_scale=params.scale_ratio
    )

    def decode(path):
        """Reader thread: BGR decode, u16 -> u8, NuSeT's host prep."""
        I = imgio.u16_to_u8(imgio.imread_bgr8(path))
        return I, nuset_infer.nuclei_segment_prepare(I[:, :, 0], params.scale_ratio)

    # the first image's tail resolves 'auto'; the others wait here for it
    scale_ready = threading.Event()
    if scaling_factor != "auto":
        scale_ready.set()

    def tail(path, I, segmented_cells, first, tail_dev=dev):
        try:
            return tail_impl(path, I, segmented_cells, first, tail_dev)
        except BaseException:
            scale_ready.set()  # release the tails parked on the gate; the error surfaces in order
            raise

    def tail_impl(path, I, segmented_cells, first, tail_dev):
        """Everything after the segmentation, on a worker thread; the
        matched filter on ``tail_dev``."""
        nonlocal scaling_factor
        img_name = os.path.basename(path)[:-4]
        annotated_path = os.path.join(inpath, output_folder, img_name)
        os.makedirs(annotated_path, exist_ok=True)

        if var.use_min_cut:
            with stage("stat_fish.min_cut"):
                labeled, min_cut_vis = maxflow.binary_seg_to_instance_min_cut(
                    segmented_cells, params.flow_limit, params.cell_size_threshold_coeff
                )
        else:
            labeled, min_cut_vis = cc_label(segmented_cells != 0), None

        if first:
            try:
                if scaling_factor == "auto":
                    scaling_factor = mf.get_scale(labeled, params.target_median_nuclei_size)
            finally:
                scale_ready.set()
        else:
            scale_ready.wait()
        sf = scaling_factor

        segmented_copy = segmented_cells.copy()
        num_channels = I.shape[-1]
        if not np.isnan(sf):
            gaussian_stdev = params.gaussian_sigma / sf
            min_cc_size = int(params.min_cc_size // (sf * sf))
            kernel_shape = [int(d // sf) if (d // sf % 2) else int(d // sf) + 1 for d in params.kernel_size]
            args = (I, segmented_cells, gaussian_stdev, params.normal_threshold, color_sensitivity, kernel_shape)
            with stage("stat_fish.matched_filter"):
                thresholded = mf.get_thresholded_device(*args, tail_dev) if device_path else mf.get_thresholded(*args)
        else:
            thresholded = np.zeros_like(I)[..., 1:]
            gaussian_stdev = min_cc_size = np.nan

        with stage("stat_fish.region_stats"):
            cell_labels, areas, centroids = region_stats.cell_geometry(labeled)
            min_size = min_cc_size if not np.isnan(min_cc_size) else 0
            columns = [[img_name] * len(cell_labels), centroids]
            for c in range(num_channels - 1):
                counts, px, removed = region_stats.per_cell_blob_stats(thresholded[..., c] != 0, labeled, min_size)
                # the reference deletes the sub-threshold blobs from the
                # thresholded map, which is saved as the lsq TIFF
                thresholded[..., c][removed] = 0
                avg, mx = region_stats.per_cell_intensity(I[..., c + 1], labeled)
                columns += [px[cell_labels].tolist(), counts[cell_labels].tolist(), avg[cell_labels].tolist(),
                            mx[cell_labels].astype(np.int64).tolist()]
            gr_counts, gr_px, _ = region_stats.per_cell_blob_stats(
                (thresholded[..., 0] != 0) & (thresholded[..., 1] != 0), labeled, min_size
            )
            columns += [areas.tolist(), gr_px[cell_labels].tolist(), gr_counts[cell_labels].tolist()]

        abbr = "_".join(f"{letter}{format(x, '.1f')}" for letter, x in zip(["g", "r", "aq"], color_sensitivity))
        lsq_path = (
            f"{annotated_path}/{img_name}_lsq_n{params.normal_threshold}"
            f"_std{format(gaussian_stdev, '.2f')}_s{min_cc_size}_{abbr}.tif"
        )
        with stage("stat_fish.tail_visuals"):
            boundaries = mf.get_boundaries(labeled, line_thickness=params.line_thickness)
            I = mf.merge_channels(I, AQUA_RGB).astype(np.uint8)
            img_with_seg = np.minimum(I + boundaries, 255).astype(np.uint8)
            blob_labeled = np.dstack([boundaries[:, :, 0], thresholded.astype(np.uint8)])
            if blob_labeled.shape[-1] > 3:
                blob_labeled = mf.merge_channels(blob_labeled, AQUA_RGB)
            blob_labeled = blob_labeled.astype(np.uint8)

        with stage("stat_fish.tail_writes"):
            np.save(f"{annotated_path}/{img_name}__segmentation_min_cut.npy", np.ascontiguousarray(labeled))
            imgio.imwrite(f"{annotated_path}/{img_name}_segmentation.tif", segmented_copy)
            if var.use_min_cut:
                imgio.imwrite(f"{annotated_path}/{img_name}_segmentation_corrected_min_cut.tif", min_cut_vis)
            imgio.imwrite(f"{annotated_path}/{img_name}_original_with_segmentation.tif", img_with_seg)
            imgio.imwrite(f"{annotated_path}/{img_name}_original.tif", I)
            imgio.imwrite(lsq_path, blob_labeled)
        return num_channels - 1, list(zip(*columns))

    def segment(path, I, pre, seg_model):
        """NuSeT's segmentation of one image: (I, the nuclei mask), cut to
        the mask's shape."""
        print("Processing image: ", path)
        with stage("stat_fish.nuclei_segment"):
            segmented = nuset_infer.nuclei_segment(I[:, :, 0], seg_model, var.nuclei_size_T, device_cleanup=device_path, pre=pre)
        h, w = segmented.shape
        I = I[:h, :w, :]
        return I, segmented[: I.shape[0], : I.shape[1]]

    results = []
    image_paths = imgio.get_imgs(inpath)
    if len(mesh) > 1 and shard_enabled("ECSEG_STAT_FISH_SHARD"):
        models = [dataclasses.replace(model, **{k: copy.deepcopy(getattr(model, k)).to(d) for k in ("unet_whole", "unet_fg", "rpn_fg")})
                  for d in mesh]

        def whole(job, k, first=False):
            path, (I, pre) = job
            return tail(path, *segment(path, I, pre, models[k]), first, mesh[k])

        jobs = iter(prefetch_map(decode, image_paths))
        start = 0
        if scaling_factor == "auto" and image_paths:
            # image 0 resolves 'auto' alone on entry 0 before the fan-out
            results += fan_out(lambda job, k: whole(job, k, first=True), [next(jobs)], mesh)
            start = 1
        results += fan_out(whole, jobs, mesh, start=start)
    else:
        workers = tail_workers()
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            inflight = deque()
            it = iter(prefetch_map(decode, image_paths))
            first = True
            while True:
                with stage("stat_fish.decode_wait"):
                    nxt = next(it, None)
                if nxt is None:
                    break
                path, (I, pre) = nxt
                I, segmented = segment(path, I, pre, model)
                # at most workers + 1 tails in flight bounds host memory
                while len(inflight) > workers:
                    with stage("stat_fish.tail_wait"):
                        results.append(inflight.popleft().result())
                inflight.append(pool.submit(tail, path, I, segmented, first))
                first = False
            while inflight:
                with stage("stat_fish.tail_wait"):
                    results.append(inflight.popleft().result())

    if results:
        write_csv(
            os.path.join(inpath, output_folder, "stat_fish_lsq.csv"),
            csv_header(results[0][0]),
            csv_rows([rows for _, rows in results]),
        )
    if os.path.isdir(f"{inpath}/annotated"):
        os.rename(f"{inpath}/annotated", f"{inpath}/annotated_{str(datetime.datetime.now())[5:-10].replace(' ', '-')}")
    os.rename(f"{inpath}/{output_folder}", f"{inpath}/annotated")
    fallbacks.report()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
