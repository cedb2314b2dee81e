"""interseg: per-nucleus ecDNA/HSR amplification classification on the card
(twin of ``ecseg_tpu/pipelines/interseg.py``, its single-device path;
reference src/interseg.py:49-258).

Reads stat_fish's outputs (``annotated/stat_fish_lsq.csv`` through the
pandas-free ``core/csvio.read_csv``, and ``annotated/<name>/<name>_segmentation.tif``)
on two reader threads, relabels the nuclei (host scipy), and per region:
skips it when its mean target-FISH brightness is below 12.75; crops its
bbox (<= 256^2) and resizes it to 256x256 for the ecSeg-i 3-class softmax on
the target-FISH channel; with a centromeric probe, runs ecSeg-c (sigmoid
P(Focal-amp)) when the crop's centromere is brighter than 10 and the image's
kurtosis quality score is at most 3.  An oversized region is cut into
non-overlapping 256^2 grid patches (each resized, an empty one skipped).
Every crop of an image goes to the card in ONE batch per classifier, with no
padding: a row's label does not depend on the batch's other rows.  Rows are
written in collection order to ``interphase_prediction_<color>.csv``.

The classifiers: ``interseg_models/<name>.h5`` through the imported-Keras
executor (``models/keras_import``), else ``interseg_models/<name>.npz``
through the weight bridge, else the default architectures on torch-seeded
weights, which differ from the JAX package's seeded ones (ROADMAP §C).

On more than one device (``main(devices=...)``; by default every card) the
images fan out as in ``interseg.py:332-389``: ecSeg-i and ecSeg-c (an
imported-Keras graph too) replicated per entry, one worker thread per entry,
image k on entry k % n, at most two images in flight an entry, one CSV in
input order.  ``ECSEG_INTERSEG_SHARD=0`` forces the sequential path.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.stats import kurtosis

from ..core import imgio
from ..core.config import Config, load_config
from ..core.csvio import Column, read_csv, write_csv
from ..device import DeviceLike, DevicesLike, entry_devices, resolve_device
from ..models.keras_import import model_device
from ..ops.cc import label as cc_label, regionprops
from ..ops.resize import resize
from ..runtime import fallbacks
from ..runtime.batching import fan_out, prefetch_map
from ..runtime.devicepath import shard_enabled
from ..runtime.hostmem import tune_host_allocator
from ..runtime.trace import stage

ECSEG_I_MODEL = "interseg"
ECSEG_C_MODEL = "ecseg_c"

ECSEG_I_LABEL_MAP = {0: "No-amp", 1: "EC-amp", 2: "HSR-amp"}
ECSEG_C_LABEL_MAP = {0: "No-amp", 1: "Focal-amp"}
INTERSEG_LABEL_MAP = {
    ("No-amp", "No-amp"): "No-amp",
    ("No-amp", "EC-amp"): "No-amp",
    ("No-amp", "HSR-amp"): "No-amp",
    ("Focal-amp", "No-amp"): "No-amp",
    ("Focal-amp", "EC-amp"): "EC-amp",
    ("Focal-amp", "HSR-amp"): "HSR-amp",
}
LOW_TARGET = "No_Prediction (Low_TRGT_brightness)"
EMPTY_PATCH = "No_Prediction (Segmentation_Empty)"
FAILED_QUALITY = "No_Prediction (Failed Centromeric Quality Score)"
LOW_CENT = "No_Prediction (Low_CENT_Brightness)"


def preprocess_ecseg_c(x: np.ndarray) -> np.ndarray:
    """Per-image channel normalization, round to 1/255 steps
    (reference src/utils.py:166-173)."""
    x = np.asarray(x, np.float32)
    dapi_norm = x[..., 2].max()
    fish_norm = x[..., :2].max(axis=(0, 1))
    norm = np.concatenate([fish_norm, [dapi_norm]]).reshape(1, 1, 3)
    return np.rint((x / norm) * 255) / 255


def im2patches_grid(img: np.ndarray, overlap: int = 75, scw: int = 256):
    """interseg's local tiling (reference src/interseg.py:27-47): a plain
    non-overlapping grid of 256^2 crops, each resized to 256x256; an image
    smaller than 256 on an axis uses its full extent there."""
    h, w = img.shape[:2]
    patches = []
    for i in range(0, math.ceil(h / scw)):
        min_row = i * scw
        if h < 256:
            max_row = h
        else:
            max_row = min_row + scw
            if max_row > h:
                continue
        for j in range(0, math.ceil(w / scw)):
            min_col = j * scw
            if w < 256:
                max_col = w
            else:
                max_col = min_col + scw
                if max_col > w:
                    continue
            patches.append(resize(img[min_row:max_row, min_col:max_col], (256, 256), preserve_range=True).astype("uint8"))
    return patches


def load_classifier_models(has_centromeric_probe: bool, model_dir: str = "interseg_models", device: DeviceLike = None):
    """(ecSeg-i, ecSeg-c or None) on ``device`` (None: the card), each
    resolved in the JAX package's order: ``<model_dir>/<name>.h5`` (read by
    the port's own HDF5 reader, run by the imported-Keras executor),
    ``<model_dir>/<name>.npz`` (the JAX parameter tree, through the weight
    bridge), else the default architecture on seeds 1 and 2.  Names each
    ``.h5`` it loads on stderr (stdout stays the JAX package's)."""
    from ..models.classifiers import EcsegC, EcsegI
    from ..models.keras_import import import_keras_h5
    from ..models.weights import classifier_from_numpy, load_npz

    dev = resolve_device(device)

    def resolve(name, cls, seed):
        h5 = os.path.join(model_dir, f"{name}.h5")
        if os.path.exists(h5):
            print(f"[ecseg] loading model {h5}", file=sys.stderr)
            return import_keras_h5(h5, device=dev)
        npz = os.path.join(model_dir, f"{name}.npz")
        if os.path.exists(npz):
            model = classifier_from_numpy(load_npz(npz))
            if not isinstance(model, cls):
                raise ValueError(f"{npz} holds a {type(model).__name__} tree, not a {cls.__name__}")
        else:
            model = cls(generator=torch.Generator().manual_seed(seed))
        return model.to(dev).eval()

    i_model = resolve(ECSEG_I_MODEL, EcsegI, 1)
    c_model = resolve(ECSEG_C_MODEL, EcsegC, 2) if has_centromeric_probe else None
    return i_model, c_model


def predict(model: torch.nn.Module, batch: np.ndarray) -> np.ndarray:
    """One forward of a whole batch on the model's device, to numpy."""
    with torch.no_grad():
        return model(torch.from_numpy(np.ascontiguousarray(batch)).to(model_device(model))).cpu().numpy()


def quality_passes(stat: Dict[str, Column], name: str, cent_channel: str) -> bool:
    """The ecSeg-c gate ``kurtosis <= 3`` over the image's rows of
    ``Avg fish intensity (<centromere colour>)`` (reference interseg.py:119-122):
    ``inf`` when the whole CSV has no row; no row of the image is selected
    when the ``image_name`` column is not a str column (all-digit names read
    as integers, as pandas reads them), so the kurtosis is NaN."""
    n_rows = len(next(iter(stat.values()))) if stat else 0
    if not n_rows:
        return False  # inf <= 3
    names = stat["image_name"]
    rows = [k for k, v in enumerate(names.values) if v == name] if names.dtype == "str" else []
    values = stat[f"Avg fish intensity ({cent_channel})"].values
    return bool(kurtosis(np.array([values[k] for k in rows], np.float64)) <= 3)


@dataclasses.dataclass
class Crops:
    """One image's rows in collection order: ``entries[k]`` is
    ``("skip", reason)`` or ``("patch", index into patches)``."""

    names: List[str]
    centroids: List[str]
    entries: List[Tuple[str, object]]
    patches: List[np.ndarray]  # (256, 256, 3) uint8: target FISH, centromere, DAPI


def collect_crops(name: str, I: np.ndarray, segmented_cells: np.ndarray, fish_index: int) -> Crops:
    """Phase 1 (host): relabel the nuclei and gather every crop."""
    if segmented_cells.ndim == 3:
        segmented_cells = segmented_cells[..., 0]
    imheight, imwidth = segmented_cells.shape
    I = I[:imheight, :imwidth, :]
    I = np.dstack([I[..., fish_index], I[..., 1 - fish_index], I[..., 2]])
    regions = regionprops(cc_label(segmented_cells != 0))

    out = Crops([], [], [], [])
    for region in regions:
        center = region.centroid

        def add_row(entry):
            out.names.append(name)
            out.centroids.append(f"{int(center[0])}_{int(center[1])}")
            out.entries.append(entry)

        # everything read below lies in the region's bbox, where the mask
        # is; cropping first gives the reference's full-image `I * mask`
        # values (interseg.py:131-132)
        inside = region._mask
        temp = I[region.slice] * np.expand_dims(inside, -1)
        if np.sum(temp[..., 0]) / np.sum(inside) < 12.75:
            add_row(("skip", LOW_TARGET))
            continue
        bb = region.bbox
        h, w = bb[2] - bb[0], bb[3] - bb[1]
        if h <= 256 and w <= 256:
            out.patches.append(resize(temp[: min(256, h), : min(256, w)], (256, 256), preserve_range=True).astype("uint8"))
            add_row(("patch", len(out.patches) - 1))
        else:
            for p in im2patches_grid(temp):
                if not p.any():
                    add_row(("skip", EMPTY_PATCH))
                    continue
                out.patches.append(p)
                add_row(("patch", len(out.patches) - 1))
    return out


def classify(crops: Crops, i_model, c_model, quality_pass: bool):
    """Phases 2 and 3: one batch per classifier, then the labels in
    collection order.  Returns (interSeg, ecSeg-c or None, ecSeg-i) label
    lists; ``c_model`` None means no centromeric probe."""
    has_cent = c_model is not None
    c_prob: Dict[int, float] = {}
    if crops.patches:
        batch = np.stack(crops.patches)
        with stage("interseg.predict_i"):
            probs_i = predict(i_model, batch[..., 0])
        if has_cent:
            cent_ok = batch[..., 1].max(axis=(1, 2)) > 10
            c_rows = np.nonzero(cent_ok & quality_pass)[0]
            if len(c_rows):
                pre = np.stack([preprocess_ecseg_c(batch[k]) for k in c_rows])
                with stage("interseg.predict_c"):
                    probs_c = predict(c_model, pre)
                c_prob = dict(zip(c_rows.tolist(), probs_c[:, 0].tolist()))

    interseg_label, ecseg_c_label, ecseg_i_label = [], [], []
    for kind, value in crops.entries:
        if kind == "skip":
            interseg_label.append(value)
            ecseg_i_label.append(value)
            ecseg_c_label.append(value)
            continue
        label_i = ECSEG_I_LABEL_MAP[int(np.argmax(probs_i[value]))]
        ecseg_i_label.append(label_i)
        if value in c_prob:
            label_c = ECSEG_C_LABEL_MAP[int(c_prob[value] > 0.5)]
            ecseg_c_label.append(label_c)
            interseg_label.append(INTERSEG_LABEL_MAP[(label_c, label_i)])
        else:
            ecseg_c_label.append(FAILED_QUALITY if not quality_pass else LOW_CENT)
            interseg_label.append(label_i)
    return interseg_label, (ecseg_c_label if has_cent else None), ecseg_i_label


def main(argv=None, config: Optional[Config] = None, device: DeviceLike = None, devices: DevicesLike = None) -> int:
    """``device``: one device; ``devices``: a device list to fan the images
    out over; neither: every card."""
    tune_host_allocator()
    mesh = entry_devices(device, devices)
    dev = mesh[0]
    if config is None:
        config = load_config()
    try:
        var = config.interseg
    except Exception as e:
        print(str(e))
        return 2
    inpath = var.inpath
    fish_color = var.FISH_color.lower()
    has_centromeric_probe = var.has_centromeric_probe

    if not os.path.isdir(inpath):
        print("Input folder does not exist. Exiting...")
        return 2
    fish_index = var.fish_index
    cent_channel = ["red", "green"][1 - fish_index]

    os.makedirs(os.path.join(inpath, "annotated"), exist_ok=True)
    image_paths = imgio.get_imgs(inpath)
    i_model, c_model = load_classifier_models(has_centromeric_probe, device=dev)
    stat_fish_results = read_csv(os.path.join(inpath, "annotated/stat_fish_lsq.csv"))

    def decode(path):
        """Reader thread: the raw image and stat_fish's segmentation."""
        head, tail = os.path.split(path)
        img = imgio.u16_to_u8(imgio.imread_rgb(path))
        seg = imgio.imread_rgb(os.path.join(head, "annotated", tail[:-4], f"{tail[:-4]}_segmentation.tif"))
        return img, seg

    def image_rows(path, I, segmented_cells, models):
        print("Processing image: ", path)
        name = os.path.split(path)[1][:-4]
        quality_pass = quality_passes(stat_fish_results, name, cent_channel)
        with stage("interseg.crops"):
            crops = collect_crops(name, I, segmented_cells, fish_index)
        labels_s, labels_c, labels_i = classify(crops, *models, quality_pass)
        cols = [crops.names, crops.centroids, labels_s] + ([labels_c] if has_centromeric_probe else []) + [labels_i]
        return list(zip(*cols))

    rows = []
    if len(mesh) > 1 and shard_enabled("ECSEG_INTERSEG_SHARD"):
        models = [tuple(None if m is None else copy.deepcopy(m).to(d) for m in (i_model, c_model)) for d in mesh]
        for part in fan_out(lambda job, k: image_rows(job[0], *job[1], models[k]), prefetch_map(decode, image_paths), mesh):
            rows.extend(part)
    else:
        it = iter(prefetch_map(decode, image_paths))
        while True:
            with stage("interseg.decode_wait"):
                nxt = next(it, None)
            if nxt is None:
                break
            path, (I, segmented_cells) = nxt
            rows.extend(image_rows(path, I, segmented_cells, (i_model, c_model)))

    if image_paths:
        header = ["image_name", "nucleus_center", "interSeg_label"]
        header += ["ecSeg-c_label"] if has_centromeric_probe else []
        with stage("interseg.write"):
            write_csv(os.path.join(os.path.split(image_paths[-1])[0], f"interphase_prediction_{fish_color}.csv"), header + ["ecSeg-i_label"], rows)
    fallbacks.report()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
