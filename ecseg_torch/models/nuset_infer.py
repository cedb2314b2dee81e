"""NuSeT inference: the two passes of the reference's ``load_nuset`` graph and
``nuclei_segment`` (twin of ``ecseg_tpu/models/nuset_infer.py:49-432``;
reference src/utils.py:35-163).

Per image (:func:`nuclei_segment`): rescale by ``resize_scale``, crop to
multiples of 16 and normalize the whole image (the prep, stage
``nuset.prep``): on the card in float64 (:func:`prepare_device`; the
U-Net's input never comes back), else on the host
(:func:`nuclei_segment_prepare`, which the pipeline's reader threads run);
:func:`prep_on_device` decides.  Then

1. the mask pass: the whole-image U-Net, per-pixel argmax (stage
   ``nuset.forward``, with the mask's fetch);
2. foreground normalization by pass 1's mask (stage ``nuset.fg_norm``; on
   the card when the prep ran there);
3. the mask+feature pass: the foreground U-Net, its argmax mask and the RPN
   feature (``nuset.forward`` again); then (stage ``nuset.proposals``) the
   anchor base size from the mask (host), the RPN head, decode, the
   zero-area filter, the top 6000 by a stable descending sort, NMS to 800
   and the clip (:func:`proposal_pass`);
4. the marker watershed (:func:`watershed_pass`, stage
   ``stat_fish.watershed``) in the mode that ``ECSEG_FAST_WATERSHED``
   selects: by default the certified device watershed
   (``ops/watershed_gpu``; kernel B3), recomputed on the host when its
   certificate is not clean, as the JAX package does (the host flood
   starts from the device pass's inputs), and counted in
   ``runtime/fallbacks``;
5. the cleanup pass (:func:`cleanup_pass`, stage ``stat_fish.cleanup``):
   ``clean_image`` on kernel B2, the resize back as a float32 matmul, the
   min-max binarize and ``remove_small_objects`` (B2), or the host chain
   when ``device_cleanup`` is False (by default under
   ``ECSEG_DEVICE_PIPELINE=0``) or ``resize_scale > 1``.

Returns uint8 {0, 255}.  Both passes' masks and the cleanup's come back to
the host packed 1 bit a pixel (``ops/packing``), as in the JAX package; the
NMS's suppression matrix and the proposals with their scores cross through
``packing.fetch`` too.  :data:`COUNTS` counts the NMS's candidates, the
boxes it kept and the proposals over ``bbox_min_score`` (the watershed's
markers); the tracer's exit report prints them.  Its geometry bucketing
serves XLA's compile cache and is not ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops import boxes as box_ops
from ..ops.morphology import remove_small_objects
from ..ops.morphology_gpu import clean_image as clean_image_gpu
from ..ops.morphology_gpu import remove_small_objects as remove_small_objects_gpu
from ..ops.normalization import (
    clean_image,
    foreground_norm,
    foreground_norm_device,
    whole_image_norm,
    whole_image_norm_device,
)
from ..ops.packing import fetch, pack_mask_1bit, unpack_mask_1bit
from ..ops.resize import rescale, rescale_device, resize_linear_matmul
from ..ops.watershed import anchor_size_from_mask, nuset_marker_watershed
from ..ops.watershed_gpu import card_alone, nuset_marker_watershed_certified, nuset_marker_watershed_fast
from ..runtime import fallbacks, trace
from ..runtime.devicepath import fast_watershed_mode, use_device_path
from ..runtime.trace import region, stage
from .nuset import NuSeTRPN, NuSeTUNet, pred_mask

SCALES = np.array([0.5, 1, 2])
RATIOS = np.array([0.125, 0.25, 0.5, 1, 2, 4, 8])
STRIDE = 16  # anchor stride (reference src/utils.py:64)

COUNTS = trace.counters("nuset")  # summed over the process's images
COUNTS.update(nms_candidates=0, nms_kept=0, markers=0)
_counts_lock = threading.Lock()


def _count(**add: int) -> None:
    with _counts_lock:
        for key, n in add.items():
            COUNTS[key] += n


def reset_counts() -> None:
    with _counts_lock:
        for key in COUNTS:
            COUNTS[key] = 0


@dataclasses.dataclass
class NuSeTModel:
    """The weights of both passes (on one device) and the proposal knobs."""

    unet_whole: NuSeTUNet
    unet_fg: NuSeTUNet
    rpn_fg: NuSeTRPN
    nms_threshold: float = 0.01
    bbox_min_score: float = 0.95
    resize_scale: float = 0.3

    @property
    def device(self) -> torch.device:
        return next(self.unet_whole.parameters()).device


def proposal_pass(
    model: NuSeTModel, feat: torch.Tensor, base_size: float, im_shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """RPN head + proposal filtering (reference rpn_proposal.py:4-187, the
    JAX package's ``_proposal_pass``): (proposals (P, 4) x1 y1 x2 y2,
    scores (P,)), float32, P <= 800, in NMS order.  Two copies reach the
    host: the packed suppression matrix with the candidates' flags, and
    the kept boxes with their scores."""
    device = feat.device
    gh, gw = feat.shape[2], feat.shape[3]
    ref = box_ops.generate_anchors_reference(base_size, RATIOS, SCALES)
    anchors = torch.from_numpy(box_ops.generate_anchors(ref, STRIDE, (gh, gw))).to(device)
    with region("nuset.proposals.rpn"):
        pred = model.rpn_fg(feat)
    with region("nuset.proposals.nms"):
        scores = pred["rpn_cls_prob"][:, 1]
        proposals = box_ops.decode(anchors, pred["rpn_bbox_pred"])
        x1, y1, x2, y2 = proposals.unbind(1)
        keep = (x2 - x1).clamp(min=0.0) * (y2 - y1).clamp(min=0.0) > 0.0
        scores = torch.where(keep, scores, -torch.inf)
        # lax.top_k keeps the lower index first among equal scores: a stable sort
        k = min(box_ops.PRE_NMS_TOP_N, scores.shape[0])
        top_scores, top_idx = torch.sort(scores, descending=True, stable=True)
        top_scores, top_idx = top_scores[:k], top_idx[:k]
        valid = top_scores > -torch.inf
        tf_order = box_ops.change_order(proposals[top_idx])
        tf_order = torch.where(valid[:, None], tf_order, 0.0)
        if k:
            packed, valid_host = box_ops.fetch_suppression(tf_order, valid, model.nms_threshold)
            sel_host = box_ops.greedy_walk(packed, valid_host, box_ops.POST_NMS_TOP_N)
        else:
            valid_host, sel_host = np.zeros(0, bool), np.zeros(0, np.int64)
        sel = torch.from_numpy(sel_host).to(device)
        out = box_ops.clip_boxes(box_ops.change_order(tf_order[sel]), im_shape)
        kept = fetch(torch.cat([out, top_scores[sel][:, None]], dim=1))
    _count(nms_candidates=int(valid_host.sum()), nms_kept=len(sel_host))
    return np.ascontiguousarray(kept[:, :4]), np.ascontiguousarray(kept[:, 4])


def fetch_mask(mask: torch.Tensor) -> np.ndarray:
    """A (H, W) bool mask on the host as float32 {0, 1}: packed 1 bit a
    pixel on its device, one copy, unpacked by the host table
    (``_fetch_mask``, ``ecseg_tpu/models/nuset_infer.py:100-104``)."""
    return unpack_mask_1bit(fetch(pack_mask_1bit(mask)), mask.shape[1]).astype(np.float32)


def _unet_input(image_norm: Union[np.ndarray, torch.Tensor], device) -> torch.Tensor:
    """A normalized (H, W) image, host array or tensor, as the U-Net's
    float32 (1, 1, H, W) input on ``device``."""
    if isinstance(image_norm, torch.Tensor):
        return image_norm.to(device).float().contiguous()[None, None]
    return torch.from_numpy(np.ascontiguousarray(image_norm, np.float32)).to(device)[None, None]


def unet_pass(unet: NuSeTUNet, image_norm: Union[np.ndarray, torch.Tensor], device):
    """One U-Net pass (stage ``nuset.forward``): (the float32 {0, 1} mask on
    the host, the bool mask on ``device``, the RPN feature).  On a card
    the pass holds ``watershed_gpu.card_alone`` until its mask is on the
    host, so that another thread's lex flood never shares the SMs with its
    convs; the wait for it falls outside the stage."""
    alone = card_alone(device) if torch.device(device).type == "cuda" else contextlib.nullcontext()
    with alone, stage("nuset.forward"), torch.no_grad():
        logits, feat = unet(_unet_input(image_norm, device))
        dev_mask = pred_mask(logits)
        mask = fetch_mask(dev_mask)
    return mask, dev_mask, feat


def mask_and_proposals(model: NuSeTModel, image_norm: Union[np.ndarray, torch.Tensor]):
    """The mask+feature pass on a foreground-normalized (H, W) image (host
    array or tensor): (the float32 {0, 1} mask, proposals (P, 4), scores
    (P,))."""
    mask, _, feat = unet_pass(model.unet_fg, image_norm, model.device)
    with stage("nuset.proposals"), torch.no_grad():
        proposals, scores = proposal_pass(model, feat, anchor_size_from_mask(mask), mask.shape)
    return mask, proposals, scores


def watershed_pass(model: NuSeTModel, mask: np.ndarray, proposals: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """The marker watershed in ``runtime/devicepath.fast_watershed_mode()``'s
    mode (the JAX package's dispatch, ``nuset_infer.py:276-319``): ``host``
    the host priority flood; ``auto`` the certified device watershed, the
    host flood of the device pass's inputs when its certificate is not
    clean (``watershed_gpu.nuset_marker_watershed_certified``, counted in
    ``runtime/fallbacks``); ``on`` the ungated device pass; ``check`` that
    pass with its tie count recorded.  float32."""
    mode = fast_watershed_mode()
    _count(markers=int(np.count_nonzero(np.asarray(scores) > model.bbox_min_score)))
    with stage("stat_fish.watershed"):
        if mode == "auto":
            out, n_unc = nuset_marker_watershed_certified(scores, proposals, mask, model.bbox_min_score, model.device)
            if n_unc:
                fallbacks.record(fallbacks.WATERSHED_UNCERTAIN_PX, n_unc)
                fallbacks.record(fallbacks.WATERSHED_HOST_RECOMPUTE)
            return out.astype(np.float32)
        if mode == "check":
            out, tie_px = nuset_marker_watershed_fast(scores, proposals, mask, model.bbox_min_score, model.device, count_ties=True)
            if tie_px:
                fallbacks.record(fallbacks.WATERSHED_TIE_PX, tie_px)
                fallbacks.record(fallbacks.WATERSHED_TIE_IMAGES)
            return out.astype(np.float32)
        elif mode == "on":
            return nuset_marker_watershed_fast(scores, proposals, mask, model.bbox_min_score, model.device).astype(np.float32)
        return nuset_marker_watershed(scores, proposals, mask, min_score=model.bbox_min_score).astype(np.float32)


def nuset_forward(model: NuSeTModel, image_norm: np.ndarray, pass_two: bool) -> np.ndarray:
    """One graph evaluation on a normalized (H, W) image: pass 1 gives the
    float32 {0, 1} mask; pass 2 the mask split by the marker watershed."""
    if pass_two:
        return watershed_pass(model, *mask_and_proposals(model, image_norm))
    return unet_pass(model.unet_whole, image_norm, model.device)[0]


def output_shape(shape, resize_scale: float) -> Tuple[int, int]:
    """The full-resolution shape the cleanup resizes back to (rescale's
    rounding of ``shape / resize_scale``)."""
    if resize_scale == 1:
        return tuple(shape)
    return tuple(int(d) for d in np.maximum(np.round(np.multiply(shape, 1 / resize_scale)), 1))


def cleanup_host(mask: np.ndarray, resize_scale: float, nuclei_size_t) -> np.ndarray:
    """The host cleanup chain (reference src/utils.py:153-163): clean_image
    -> rescale back -> min-max binarize through uint8 -> remove small
    objects.  uint8 {0, 255}."""
    mask = clean_image(mask)
    if resize_scale != 1:
        mask = rescale(mask, 1 / resize_scale)
    lo, hi = mask.min(), mask.max()
    with np.errstate(invalid="ignore", divide="ignore"):
        I8 = (((mask - lo) / (hi - lo)) * 255).astype(np.uint8)
    return remove_small_objects(I8 > 0, nuclei_size_t).astype(np.uint8) * np.uint8(255)


def cleanup_pass(mask: np.ndarray, out_hw: Tuple[int, int], nuclei_size_t, device) -> np.ndarray:
    """The device twin of the host cleanup chain (reference
    src/utils.py:153-163, the JAX package's ``_cleanup_pass``):
    ``clean_image`` -> resize to ``out_hw`` -> min-max binarize -> remove
    small objects (4-connected).  The binarize keeps the host's uint8
    truncation, ``(m - lo) / (hi - lo) * 255 >= 1``, and its quirk that
    hi == lo (0/0, NaN -> 0) gives an empty mask.  The result comes back
    packed 1 bit a pixel and is unpacked on the host.  uint8 {0, 255}."""
    m = clean_image_gpu(torch.from_numpy(np.asarray(mask) != 0).to(device)).float()
    if tuple(out_hw) != tuple(m.shape):
        m = resize_linear_matmul(m, out_hw)
    keep = remove_small_objects_gpu(binarize(m), nuclei_size_t, connectivity=1)
    return unpack_mask_1bit(fetch(pack_mask_1bit(keep)), keep.shape[1]) * np.uint8(255)


def binarize(m: torch.Tensor) -> torch.Tensor:
    """The cleanup's min-max binarize of the resized float mask:
    ``(m - lo) / (hi - lo) * 255 >= 1``, empty when hi == lo."""
    lo, hi = m.min(), m.max()
    return ((m - lo) / (hi - lo) * 255.0 >= 1.0) & (hi > lo)


def nuclei_segment_prepare(image: np.ndarray, resize_scale: float):
    """Host prep: rescale -> crop to /16 -> whole-image norm; returns
    (cropped image, normalized image)."""
    if resize_scale != 1:
        image = rescale(image, resize_scale, anti_aliasing=True)
    h, w = image.shape
    image = image[: h // 16 * 16, : w // 16 * 16]
    return image, whole_image_norm(image)


def prepare_device(image: Union[np.ndarray, torch.Tensor], resize_scale: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`nuclei_segment_prepare` of a 2-D uint8 image on ``device`` in
    float64 (``ops/resize.rescale_device``, ``whole_image_norm_device``):
    (cropped image, normalized image), both float64 tensors there.  The
    8-bit image crosses to the card once; ``resize_scale`` at most 1."""
    x = torch.as_tensor(image).to(device)
    x = rescale_device(x, resize_scale) if resize_scale != 1 else x.double()
    h, w = x.shape
    x = x[: h // 16 * 16, : w // 16 * 16]
    return x, whole_image_norm_device(x)


def prep_on_device(model: NuSeTModel, device_path: bool) -> bool:
    """Whether the prep and the foreground norm run on the model's card:
    a CUDA model, the device path, and a downscale (``resize_scale`` at
    most 1; above 1 the host's upscale has no prefilter to share).
    Otherwise the host chain, the JAX package's parity oracle."""
    return model.device.type == "cuda" and bool(device_path) and model.resize_scale <= 1


def nuclei_segment_front(
    image: np.ndarray, model: NuSeTModel, device_cleanup: Optional[bool] = None, pre=None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """:func:`nuclei_segment` up to the watershed: the prep, both U-Net
    passes and the proposals.  Returns host arrays only (pass 2's float32
    mask, proposals, scores) and whether the cleanup runs on the card, for
    :func:`nuclei_segment_back`."""
    if device_cleanup is None:
        device_cleanup = use_device_path()
    resize_scale = model.resize_scale
    if resize_scale > 1:
        device_cleanup = False
    if pre is None and prep_on_device(model, device_cleanup):
        with stage("nuset.prep"):
            image, image_wn = prepare_device(image, resize_scale, model.device)
        _, mask1, _ = unet_pass(model.unet_whole, image_wn, model.device)
        with stage("nuset.fg_norm"):
            image_fg = foreground_norm_device(image, mask1)
    else:
        if pre is None:
            with stage("nuset.prep"):
                pre = nuclei_segment_prepare(image, resize_scale)
        image, image_wn = pre
        masks1 = nuset_forward(model, image_wn, pass_two=False)
        with stage("nuset.fg_norm"):
            image_fg = foreground_norm(image, masks1)
    return mask_and_proposals(model, image_fg) + (bool(device_cleanup),)


def nuclei_segment_back(front, model: NuSeTModel, nuclei_size_t) -> np.ndarray:
    """:func:`nuclei_segment` from a :func:`nuclei_segment_front` result:
    the marker watershed and the cleanup.  It reads only host arrays, so
    it may run on another thread, on another CUDA stream, while the next
    image's front half runs."""
    mask, proposals, scores, device_cleanup = front
    masks_watershed = watershed_pass(model, mask, proposals, scores)
    if device_cleanup:
        with stage("stat_fish.cleanup"):
            return cleanup_pass(masks_watershed, output_shape(masks_watershed.shape, model.resize_scale), nuclei_size_t, model.device)
    return cleanup_host(masks_watershed, model.resize_scale, nuclei_size_t)


def nuclei_segment(
    image: np.ndarray, model: NuSeTModel, nuclei_size_t, device_cleanup: Optional[bool] = None, pre=None
) -> np.ndarray:
    """reference src/utils.py:134-163: uint8 {0, 255} nuclei mask at the
    input's resolution (:func:`nuclei_segment_front`, then
    :func:`nuclei_segment_back`).  ``pre``: a :func:`nuclei_segment_prepare`
    result made with the model's ``resize_scale``; without it the prep runs
    here, on the card when :func:`prep_on_device` says so.
    ``device_cleanup`` (default: ``runtime/devicepath.use_device_path()``)
    False runs the host prep and cleanup chain, as does ``resize_scale >
    1``: the host's downscale back then applies a gaussian prefilter the
    matmul resize does not."""
    return nuclei_segment_back(nuclei_segment_front(image, model, device_cleanup, pre), model, nuclei_size_t)
