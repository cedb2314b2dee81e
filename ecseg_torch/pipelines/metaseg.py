"""metaseg: folder-batch 4-class DAPI segmentation on the card (twin of
``ecseg_tpu/pipelines/metaseg.py``, its single-device paths).

Pipeline parity target: reference src/metaseg.py:12-57 + src/utils.py:109-120.
Per image: read -> meta_preprocess -> save inverted DAPI -> overlap-patchify
(host, on reader threads) -> U-Net forward -> exact uint8 quantize + argmax
-> stitch (kernel B1) -> meta_inference (``ops/meta_post_gpu``: by default
on kernels B2-B6; ``ECSEG_MC_LABEL=0`` selects the per-class form on B2-B4
and ``ECSEG_MC_MERGE=1`` the fused merge on B9, as in the JAX package) ->
ecDNA count (B2) -> the labels packed 2 bits a pixel under a header of
``ok`` and the count, one uint8 blob a canvas (:func:`post_blob`, the JAX
package's layout) -> write ``labels/<name>.png``, ``labels/<name>.npy`` and
one row of ``ec_quantification.csv``.  When the device meta_inference
reports ``ok`` False (a component budget overflowed) the image is redone on
the host oracle and counted in ``runtime/fallbacks``.

Images of one geometry are grouped (``ECSEG_METASEG_GROUP``, default 8,
capped by ``ECSEG_METASEG_PATCH_BUDGET`` patches): the group's forwards
enqueued back to back, one an image, then B1 and the post per canvas, the
group's blobs in one copy (:func:`segment_folder`).  ``ECSEG_DEVICE_PIPELINE=0``
runs the host oracle after the forward and B1.

On more than one device (``main(devices=...)``; by default every card) the
JAX package's multi-device paths run (``metaseg.py:267-475,555-579``):
:func:`segment_folder_sharded_device`, each image's whole chain on one mesh
entry, and under ``ECSEG_DEVICE_PIPELINE=0`` :func:`segment_folder_sharded`,
cross-image patch batches split over the entries with the stitch and the
oracle on the host.  The outputs are the single-device run's bytes.

Not ported (ROADMAP): fast start and the program cache, the padding of
partial groups and ``ECSEG_GROUP_POST=vmap`` (they serve XLA's compile
cache).
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import imgio
from ..core.config import Config, load_config
from ..core.csvio import write_csv
from ..device import DeviceLike, DevicesLike, entry_devices, pin_thread, resolve_device
from ..models.keras_import import model_device
from ..models.metaseg_unet import MetasegUNet
from ..models.weights import load_npz, params_from_numpy
from ..ops import tiling
from ..ops.cc import count_cc
from ..ops.cc_kernels import stitch_labels
from ..ops.meta_post import meta_inference, meta_preprocess
from ..ops.meta_post_gpu import count_roots_gpu, meta_inference_gpu
from ..ops.packing import fetch, pack_labels_2bit, unpack_labels_2bit
from ..runtime import fallbacks
from ..runtime.batching import prefetch_map
from ..runtime.devicepath import use_device_path
from ..runtime.hostmem import tune_host_allocator
from ..runtime.trace import region, stage


def load_model(model_dir: str = "models", device: DeviceLike = None) -> torch.nn.Module:
    """The metaseg model, in the JAX package's order
    (``ecseg_tpu/pipelines/metaseg.py:478-513``): ``<model_dir>/metaseg.h5``
    (the reference's Keras model, read by the port's own HDF5 reader and run
    by the imported-Keras executor, fed the patches as float32), else
    ``<model_dir>/metaseg.npz`` (the JAX parameter tree, through the weight
    bridge), else the default architecture on seeded random weights
    (development; these differ from the JAX package's seeded weights).
    Either module takes (N, 256, 256, 1) uint8 patches and returns
    (N, 256, 256, C) float32 probabilities.  Names a ``.h5`` it loads on stderr
    (stdout stays the JAX package's)."""
    dev = resolve_device(device)
    h5_path = os.path.join(model_dir, "metaseg.h5")
    if os.path.exists(h5_path):
        from ..models.keras_import import import_keras_h5

        print(f"[ecseg] loading model {h5_path}", file=sys.stderr)
        return import_keras_h5(h5_path, device=dev).eval()
    npz_path = os.path.join(model_dir, "metaseg.npz")
    if os.path.exists(npz_path):
        model = params_from_numpy(load_npz(npz_path))
    else:
        model = MetasegUNet(generator=torch.Generator().manual_seed(0))
    return model.to(dev).eval()


def _prepare_image(image_path: str, save_dapi: bool = True):
    """Host stage: decode -> meta_preprocess -> save inverted DAPI ->
    patchify."""
    I = meta_preprocess(imgio.imread_rgb(image_path))
    if save_dapi:
        head, tail = os.path.split(image_path)
        imgio.save_gray_inverted(os.path.join(head, "dapi", tail), I)
    _, patches, pos = tiling.im2patches_overlap(I[..., None])
    return patches, tuple(map(tuple, pos))


def _prepared(image_paths: Sequence[str]):
    """(path, (patches, positions)) of each image, in order, from the
    reader threads (:func:`_prepare_image`); the caller's wait on them is
    the stage ``metaseg.decode_wait``."""
    it = iter(prefetch_map(_prepare_image, image_paths))
    while True:
        with stage("metaseg.decode_wait"):
            nxt = next(it, None)
        if nxt is None:
            return
        yield nxt


def segment_group(
    model: torch.nn.Module, stacks: Sequence[np.ndarray], positions: Sequence[Tuple[int, int]]
) -> List[torch.Tensor]:
    """(N, 256, 256, 1) uint8 patch stacks of images of one geometry -> their
    stitched (H, W) int32 label maps: one forward an image, exact uint8
    quantize + argmax per patch, then B1 per canvas, on the model's device.
    The forwards are not concatenated: on the card a patch's float32
    probabilities move in the last bits with the batch it runs in (cuDNN
    picks its algorithm by shape), which can flip a knife-edge argmax, so
    an image runs at its own batch whatever its group and keeps the
    per-image run's bytes (ROADMAP C8)."""
    device = model_device(model)
    with stage("metaseg.forward"), torch.no_grad():
        label_patches = [tiling.patch_labels(model(torch.from_numpy(s).to(device))) for s in stacks]
    with stage("metaseg.stitch"):
        return [stitch_labels(lp, positions) for lp in label_patches]


def segment_raw(
    model: torch.nn.Module, patches: np.ndarray, positions: Sequence[Tuple[int, int]]
) -> torch.Tensor:
    """One image's stitched (H, W) int32 label map (:func:`segment_group` of
    one stack)."""
    return segment_group(model, [patches], positions)[0]


def load_params(model_dir: str = "models", device: DeviceLike = None) -> torch.nn.Module:
    """:func:`load_model` (the JAX module's other name for it)."""
    return load_model(model_dir, device)


def meta_segment(model: torch.nn.Module, image_path: str, save_dapi: bool = True) -> np.ndarray:
    """One image's int64 labels by the model's forward and B1 on its
    device, then the host oracle (reference src/utils.py:109-120): the
    reference's ``meta_segment``, which no pipeline calls."""
    patches, pos = _prepare_image(image_path, save_dapi)
    raw = segment_raw(model, patches, pos)
    return meta_inference(fetch(raw).astype(np.int64))


def host_post(raw: np.ndarray) -> Tuple[np.ndarray, int]:
    """The host oracle: (int64 labels, #ecDNA) of a raw label map."""
    I = meta_inference(raw.astype(np.int64))
    return I, count_cc(I == 3)[0]


def _host_post_traced(raw: np.ndarray) -> Tuple[np.ndarray, int]:
    """:func:`host_post` as the ``ECSEG_DEVICE_PIPELINE=0`` branches run it."""
    with stage("metaseg.meta_inference"):
        return host_post(raw)


HEADER_SHIFTS = (0, 8, 16, 24)  # the count's little-endian bytes in the blob's header row


def post_blob(labels: torch.Tensor) -> torch.Tensor:
    """The device post of one stitched canvas as ONE uint8 blob, in the JAX
    package's layout (``_post_blob``, ``ecseg_tpu/pipelines/metaseg.py:94-111``):
    ``meta_inference_gpu`` and the ecDNA count, then a header row (the ``ok``
    flag, the count as little-endian uint32, zeros) above the final labels
    packed 2 bits a pixel: (H + 1, ceil(W/4)).  Needs W >= 17 (a header of
    5 bytes)."""
    out, ok = meta_inference_gpu(labels)
    num_ec = count_roots_gpu(out == 3).to(torch.int64)
    packed = pack_labels_2bit(out)
    if packed.shape[1] < 1 + len(HEADER_SHIFTS):
        raise ValueError(f"a {tuple(labels.shape)} canvas is too narrow for the blob's header")
    shifts = torch.tensor(HEADER_SHIFTS, device=packed.device)
    header = torch.zeros((1, packed.shape[1]), dtype=torch.uint8, device=packed.device)
    header[0, 0] = ok.to(torch.uint8)
    header[0, 1 : 1 + len(shifts)] = ((num_ec >> shifts) & 0xFF).to(torch.uint8)
    return torch.cat([header, packed])


def decode_post_blob(blob: np.ndarray, w: int) -> Tuple[bool, np.ndarray, int]:
    """Host side of :func:`post_blob` (``_decode_post_blob``): (ok, final
    int64 labels, #ecDNA).  A blob whose ``ok`` is False is counted in
    ``runtime/fallbacks`` (its labels are not the answer: the caller redoes
    the canvas on the host)."""
    ok = bool(blob[0, 0])
    if not ok:
        fallbacks.record(fallbacks.META_POST_OK)
    num_ec = sum(int(blob[0, 1 + k]) << s for k, s in enumerate(HEADER_SHIFTS))
    return ok, unpack_labels_2bit(blob[1:], w).astype(np.int64), num_ec


def post_group(raws: Sequence[torch.Tensor]) -> List[Tuple[np.ndarray, int, bool]]:
    """:func:`post_blob` of each canvas of a group (one geometry); the
    group's blobs come back in ONE device-to-host copy and are decoded on
    the host.  A canvas whose ``ok`` is False (counted in
    ``runtime/fallbacks``) has its raw map fetched and is redone on the host
    oracle.  Returns (int64 labels, #ecDNA, ok) per canvas."""
    with stage("metaseg.post"):
        with region("metaseg.post.device"):
            stacked = torch.stack([post_blob(raw) for raw in raws])
        blobs = fetch(stacked)
        with region("metaseg.post.decode"):
            decoded = [decode_post_blob(blob, raw.shape[1]) for blob, raw in zip(blobs, raws)]
    results = []
    for raw, (ok, labels, num_ec) in zip(raws, decoded):
        if ok:
            results.append((labels, num_ec, True))
            continue
        with stage("metaseg.host_redo"):
            results.append(host_post(fetch(raw)) + (False,))
    return results


def post_process(raw: torch.Tensor) -> Tuple[np.ndarray, int, bool]:
    """:func:`post_group` of one canvas."""
    return post_group([raw])[0]


def _group_size() -> int:
    """Images per grouped dispatch, from ``ECSEG_METASEG_GROUP`` (default 8,
    8 when not an integer); <= 1 runs each image alone (the JAX package's
    per-image program)."""
    try:
        return int(os.environ.get("ECSEG_METASEG_GROUP", "8"))
    except ValueError:
        return 8


def geo_group(positions: Sequence[Tuple[int, int]], group: int) -> int:
    """The group size of one geometry: at most ``ECSEG_METASEG_PATCH_BUDGET``
    (default 256) patches in a group, at least one image
    (``metaseg.py:587-598``, where the group is one forward)."""
    budget = int(os.environ.get("ECSEG_METASEG_PATCH_BUDGET", "256"))
    return max(1, min(group, budget // max(1, len(positions))))


def segment_folder(model: torch.nn.Module, image_paths: Sequence[str], device_post: bool = True):
    """Yields (path, int64 labels, #ecDNA) of each image, in input order.
    Images are bucketed by geometry; a bucket is flushed when it holds
    ``geo_group`` images, the rest at the end of the folder.  A flush runs
    :func:`segment_group` and :func:`post_group` (the JAX package's grouped
    single-chip dispatch, ``metaseg.py:580-715``; its padding of partial
    groups serves XLA's compile cache and is not ported).  ``device_post``
    False (``ECSEG_DEVICE_PIPELINE=0``) runs each image alone through the
    forward, B1 and the host oracle, as the JAX package's per-image host
    branch does."""
    group = _group_size() if device_post else 1
    buckets, results, cursor = {}, {}, 0

    def flush(pos, items):
        raws = segment_group(model, [patches for _, _, patches in items], pos)
        if device_post:
            outs = post_group(raws)
        else:
            outs = [_host_post_traced(raw.cpu().numpy()) for raw in raws]
        for (idx, path, _), (I, num, *_) in zip(items, outs):
            results[idx] = (path, I, num)

    def emit():
        nonlocal cursor
        while cursor in results:
            yield results.pop(cursor)
            cursor += 1

    for idx, (path, (patches, pos)) in enumerate(_prepared(image_paths)):
        items = buckets.setdefault(pos, [])
        items.append((idx, path, patches))
        if len(items) == geo_group(pos, group):
            flush(pos, items)
            buckets[pos] = []
            yield from emit()
    for pos, items in buckets.items():
        if items:
            flush(pos, items)
    yield from emit()


def replicate(model: torch.nn.Module, devices: Sequence[torch.device]) -> List[torch.nn.Module]:
    """One copy of ``model`` per mesh entry, on the entry's device (a
    ``.h5`` model's graph too): the counterpart of the JAX package's
    replicated parameters."""
    return [copy.deepcopy(model).to(dev) for dev in devices]


def _segment_on(replica: torch.nn.Module, dev: torch.device, patches: np.ndarray, pos) -> Tuple[np.ndarray, int, bool]:
    """One image's whole chain on one mesh entry, in that entry's worker:
    forward, quantize + argmax, B1, the device post and the count (host
    redo when ``ok`` is False)."""
    pin_thread(dev)
    return post_group(segment_group(replica, [patches], pos))[0]


def segment_folder_sharded_device(model: torch.nn.Module, image_paths: Sequence[str], devices: Sequence[torch.device]):
    """Yields (path, int64 labels, #ecDNA) of each image, in input order,
    as ``segment_folder_sharded_device`` (``metaseg.py:348-475``) does:
    images are grouped by geometry into groups of ``len(devices)``, and the
    k-th image of a group runs its whole chain (:func:`_segment_on`) on
    entry k, one worker thread per entry, on its own replica of the model.
    An image whose ``ok`` is False is redone on the host oracle and counted
    in ``runtime/fallbacks``.  Partial groups run as they are (the JAX
    package's zero padding serves XLA's compile cache: deviation 9)."""
    devices = list(devices)
    replicas = replicate(model, devices)
    buckets, results, cursor = {}, {}, 0

    def flush(pos, items, pool):
        futures = [pool.submit(_segment_on, replicas[k], devices[k], patches, pos) for k, (_, _, patches) in enumerate(items)]
        for (idx, path, _), fut in zip(items, futures):
            I, num, _ = fut.result()
            results[idx] = (path, I, num)

    def emit():
        nonlocal cursor
        while cursor in results:
            yield results.pop(cursor)
            cursor += 1

    with cf.ThreadPoolExecutor(max_workers=len(devices)) as pool:
        for idx, (path, (patches, pos)) in enumerate(_prepared(image_paths)):
            items = buckets.setdefault(pos, [])
            items.append((idx, path, patches))
            if len(items) == len(devices):
                flush(pos, items, pool)
                buckets[pos] = []
                yield from emit()
        for pos, items in buckets.items():
            if items:
                flush(pos, items, pool)
    yield from emit()


def _patch_labels_on(replica: torch.nn.Module, dev: torch.device, chunk: np.ndarray) -> np.ndarray:
    """A chunk of patches through one entry's replica: (n, 256, 256) uint8
    labels on the host."""
    pin_thread(dev)
    with torch.no_grad():
        return tiling.patch_labels(replica(torch.from_numpy(chunk).to(dev))).cpu().numpy()


def segment_folder_sharded(model: torch.nn.Module, image_paths: Sequence[str], devices: Sequence[torch.device], batch_patches: int = 256):
    """Yields (path, stitched int64 raw label map) of each image, in input
    order, as ``segment_folder_sharded`` (``metaseg.py:267-345``) does: the
    patches of all images are packed into batches of ``batch_patches``
    (rounded up to a multiple of the data axis), each batch is split over
    the entries (one thread each, a replica each), uint8 patch labels come
    back, and the stitch runs on the host (``cc_kernels.stitch_plain``; the
    caller runs the oracle).  Every batch has the one shape: the last is
    padded with zero patches, whose labels are dropped, as the JAX package
    pads to one static shape (``metaseg.py:303-305``).  On the card a
    patch's float32 probabilities move in the last bits with the shape of
    the batch it runs in (cuDNN picks its algorithm by shape), so an
    unpadded remainder made an image's labels depend on the rest of the
    folder (ROADMAP C8)."""
    devices = list(devices)
    n = len(devices)
    replicas = replicate(model, devices)
    batch_patches = -(-max(batch_patches, n) // n) * n
    pending = []  # (path, positions, patch count) awaiting labels
    buf = np.zeros((0, tiling.SCW, tiling.SCW, 1), np.uint8)
    out = []  # label patch arrays in pending order

    def dispatch(stack, pool):
        valid = len(stack)
        if valid < batch_patches:
            stack = np.concatenate([stack, np.zeros((batch_patches - valid,) + stack.shape[1:], stack.dtype)])
        with stage("metaseg.sharded_forward"):
            futures = [pool.submit(_patch_labels_on, replicas[k], devices[k], c) for k, c in enumerate(np.split(stack, n))]
            out.append(np.concatenate([f.result() for f in futures])[:valid])

    def drain(pool):
        nonlocal buf
        if len(buf):
            dispatch(buf, pool)
            buf = buf[:0]
        flat = np.concatenate(out) if out else np.zeros((0, tiling.SCW, tiling.SCW), np.uint8)
        offset = 0
        for path, pos, count in pending:
            with stage("metaseg.stitch"):
                canvas = stitch_labels(torch.from_numpy(flat[offset : offset + count]), pos)
            offset += count
            yield path, canvas.numpy().astype(np.int64)
        pending.clear()
        out.clear()

    with cf.ThreadPoolExecutor(max_workers=n) as pool:
        for path, (patches, pos) in _prepared(image_paths):
            pending.append((path, pos, len(patches)))
            buf = np.concatenate([buf, patches])
            while len(buf) >= batch_patches:
                dispatch(buf[:batch_patches], pool)
                buf = buf[batch_patches:]
            # bound host memory: emit the finished images now and then
            if sum(c for _, _, c in pending) >= 8 * batch_patches:
                yield from drain(pool)
        yield from drain(pool)


def main(argv=None, config: Optional[Config] = None, device: DeviceLike = None, devices: DevicesLike = None) -> int:
    """``device``: one device (the single-card path); ``devices``: that
    mesh; neither: every card (``device.resolve_devices``).  More than one
    entry takes the sharded paths."""
    tune_host_allocator()
    mesh = entry_devices(device, devices)
    dev = mesh[0]
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

    device_post = use_device_path()
    if len(mesh) == 1:
        results = segment_folder(model, image_paths, device_post)
    elif device_post:
        results = segment_folder_sharded_device(model, image_paths, mesh)
    else:
        results = ((path, *_host_post_traced(raw)) for path, raw in segment_folder_sharded(model, image_paths, mesh))

    rows = []
    print("Reading from: ", inpath)
    for path, I, num_ecDNA in results:
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
