"""metaseg: folder-batch 4-class DAPI segmentation on the card (twin of
``ecseg_tpu/pipelines/metaseg.py``, its per-image device path).

Pipeline parity target: reference src/metaseg.py:12-57 + src/utils.py:109-120.
Per image: read -> meta_preprocess -> save inverted DAPI -> overlap-patchify
(host, on reader threads) -> U-Net forward over the whole patch stack ->
exact uint8 quantize + argmax -> stitch (kernel B1) -> meta_inference
(``ops/meta_post_gpu``, kernels B2-B4) -> ecDNA count (B2) -> write
``labels/<name>.png``, ``labels/<name>.npy`` and one row of
``ec_quantification.csv``.  When the device meta_inference reports ``ok``
False (a component budget overflowed) the image is redone on the host
oracle and counted in ``runtime/fallbacks``.

Not ported yet (ROADMAP): the grouped multi-image dispatch, fast start and
the program cache, the 2-bit result packing, the sharded multi-chip paths
and the Keras-H5 executor.
"""

from __future__ import annotations

import csv
import os
import sys
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import imgio
from ..core.config import Config, load_config
from ..device import DeviceLike, resolve_device
from ..models.metaseg_unet import MetasegUNet
from ..models.weights import load_npz, params_from_numpy
from ..ops import tiling
from ..ops.cc import count_cc
from ..ops.cc_kernels import stitch_labels
from ..ops.meta_post import meta_inference, meta_preprocess
from ..ops.meta_post_gpu import count_roots_gpu, meta_inference_gpu
from ..runtime import fallbacks
from ..runtime.batching import prefetch_map
from ..runtime.trace import stage


def load_model(model_dir: str = "models", device: DeviceLike = None) -> MetasegUNet:
    """``<model_dir>/metaseg.npz`` (the JAX parameter tree, through the
    weight bridge) or, with no model file at all, the default architecture
    on seeded random weights (development; these differ from the JAX
    package's seeded weights).  A Keras ``metaseg.h5`` alone raises: the port
    cannot execute it yet and never substitutes random weights for it."""
    npz_path = os.path.join(model_dir, "metaseg.npz")
    h5_path = os.path.join(model_dir, "metaseg.h5")
    if os.path.exists(npz_path):
        model = params_from_numpy(load_npz(npz_path))
    elif os.path.exists(h5_path):
        raise RuntimeError(
            f"{h5_path} is a Keras model, which the PyTorch port cannot run yet "
            "(ROADMAP A7, the imported-Keras executor); convert it to "
            f"{npz_path} or run the JAX package"
        )
    else:
        model = MetasegUNet(generator=torch.Generator().manual_seed(0))
    return model.to(resolve_device(device)).eval()


def _prepare_image(image_path: str, save_dapi: bool = True):
    """Host stage: decode -> meta_preprocess -> save inverted DAPI ->
    patchify."""
    I = meta_preprocess(imgio.imread_rgb(image_path))
    if save_dapi:
        head, tail = os.path.split(image_path)
        imgio.save_gray_inverted(os.path.join(head, "dapi", tail), I)
    _, patches, pos = tiling.im2patches_overlap(I[..., None])
    return patches, tuple(map(tuple, pos))


def segment_raw(
    model: MetasegUNet, patches: np.ndarray, positions: Sequence[Tuple[int, int]]
) -> torch.Tensor:
    """(N, 256, 256, 1) uint8 patches -> the stitched (H, W) int32 label map
    (forward, exact uint8 quantize + argmax per patch, B1 stitch), on the
    model's device."""
    device = next(model.parameters()).device
    with stage("metaseg.forward"), torch.no_grad():
        probs = model(torch.from_numpy(patches).to(device))
        label_patches = tiling.patch_labels(probs)
        del probs
    with stage("metaseg.stitch"):
        return stitch_labels(label_patches, positions)


def post_process(raw: torch.Tensor) -> Tuple[np.ndarray, int, bool]:
    """Device meta_inference + ecDNA count; the host oracle redoes the image
    when the device reports ``ok`` False.  Returns (int64 labels, #ecDNA,
    ok)."""
    with stage("metaseg.post"):
        out, ok = meta_inference_gpu(raw)
        num = count_roots_gpu(out == 3)
        ok = bool(ok)
        if ok:
            return out.cpu().numpy(), int(num), ok
    fallbacks.record(fallbacks.META_POST_OK)
    with stage("metaseg.host_redo"):
        I = meta_inference(raw.cpu().numpy().astype(np.int64))
        return I, count_cc(I == 3)[0], ok


def write_csv(path: str, header: Sequence[str], rows) -> None:
    """Byte-equal to pandas' ``DataFrame(rows, columns=header).to_csv(path,
    index=False)`` for str/int cells: comma-separated, minimal quoting,
    ``\\n`` line ends."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def main(argv=None, config: Optional[Config] = None, device: DeviceLike = None) -> int:
    dev = resolve_device(device)
    if config is None:
        config = load_config()
    inpath = config.metaseg.inpath

    if not os.path.isdir(inpath):
        print("Input folder does not exist. Exiting...")
        return 2

    os.makedirs(os.path.join(inpath, "dapi"), exist_ok=True)
    os.makedirs(os.path.join(inpath, "labels"), exist_ok=True)

    model = load_model(device=dev)
    image_paths = imgio.get_imgs(inpath)

    rows = []
    print("Reading from: ", inpath)
    for path, (patches, pos) in prefetch_map(_prepare_image, image_paths):
        I, num_ecDNA, _ = post_process(segment_raw(model, patches, pos))
        print("Processing image: ", path)
        head, tail = os.path.split(path)
        outpath = os.path.join(head, "labels", tail[:-4])
        print("Saving labels: ", path, " to ", outpath)
        with stage("metaseg.write"):
            imgio.save_label_png(outpath + ".png", I.astype("uint8"))
            np.save(outpath, np.ascontiguousarray(I))
        rows.append((tail, num_ecDNA))

    # always written, to inpath, as the reference does (metaseg.py:57): an
    # empty folder gives a header-only file
    out_csv = os.path.join(inpath, "ec_quantification.csv")
    print("Saving ec quantification to", out_csv)
    write_csv(out_csv, ["image name", "# of ec"], rows)
    fallbacks.report()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
