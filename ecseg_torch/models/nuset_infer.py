"""NuSeT inference: the two passes of the reference's ``load_nuset`` graph and
``nuclei_segment`` (twin of ``ecseg_tpu/models/nuset_infer.py:49-432``;
reference src/utils.py:35-163).

Per image (:func:`nuclei_segment`): on the host rescale by ``resize_scale``,
crop to multiples of 16 and normalize the whole image
(:func:`nuclei_segment_prepare`, run on the pipeline's reader threads); then

1. the mask pass: the whole-image U-Net, per-pixel argmax;
2. foreground normalization by pass 1's mask (host);
3. the mask+feature pass: the foreground U-Net, its argmax mask and the RPN
   feature; the anchor base size from the mask (host); the RPN head,
   decode, the zero-area filter, the top 6000 by a stable descending sort,
   NMS to 800 and the clip (:func:`proposal_pass`);
4. the marker watershed (:func:`watershed_pass`) in the mode that
   ``ECSEG_FAST_WATERSHED`` selects: by default the certified device
   watershed (``ops/watershed_gpu``; kernel B3), recomputed on the host
   when its certificate is not clean, as the JAX package does, and counted
   in ``runtime/fallbacks``;
5. the cleanup pass (:func:`cleanup_pass`): ``clean_image`` on kernel B2,
   the resize back as a float32 matmul, the min-max binarize and
   ``remove_small_objects`` (B2), or the host chain when ``device_cleanup``
   is False (by default under ``ECSEG_DEVICE_PIPELINE=0``) or
   ``resize_scale > 1``.

Returns uint8 {0, 255}.  The JAX package's geometry bucketing and 1-bit
transfers exist for XLA's compile cache and a slow host link; they change no
value and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import boxes as box_ops
from ..ops.morphology import remove_small_objects
from ..ops.morphology_gpu import clean_image as clean_image_gpu
from ..ops.morphology_gpu import remove_small_objects as remove_small_objects_gpu
from ..ops.normalization import clean_image, foreground_norm, whole_image_norm
from ..ops.resize import rescale, resize_linear_matmul
from ..ops.watershed import anchor_size_from_mask, nuset_marker_watershed
from ..ops.watershed_gpu import nuset_marker_watershed_auto, nuset_marker_watershed_fast
from ..runtime import fallbacks
from ..runtime.devicepath import fast_watershed_mode, use_device_path
from ..runtime.trace import stage
from .nuset import NuSeTRPN, NuSeTUNet, pred_mask

SCALES = np.array([0.5, 1, 2])
RATIOS = np.array([0.125, 0.25, 0.5, 1, 2, 4, 8])
STRIDE = 16  # anchor stride (reference src/utils.py:64)


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
    scores (P,)), float32, P <= 800, in NMS order."""
    device = feat.device
    gh, gw = feat.shape[2], feat.shape[3]
    ref = box_ops.generate_anchors_reference(base_size, RATIOS, SCALES)
    anchors = torch.from_numpy(box_ops.generate_anchors(ref, STRIDE, (gh, gw))).to(device)
    pred = model.rpn_fg(feat)
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
    sel = torch.from_numpy(box_ops.nms_sorted(tf_order, valid, box_ops.POST_NMS_TOP_N, model.nms_threshold)).to(device)
    out = box_ops.clip_boxes(box_ops.change_order(tf_order[sel]), im_shape)
    return out.cpu().numpy(), top_scores[sel].cpu().numpy()


def mask_and_proposals(model: NuSeTModel, image_norm: np.ndarray):
    """The mask+feature pass on a foreground-normalized (H, W) image: (the
    float32 {0, 1} mask, proposals (P, 4), scores (P,))."""
    x = torch.from_numpy(np.ascontiguousarray(image_norm, np.float32)).to(model.device)[None, None]
    with torch.no_grad():
        logits, feat = model.unet_fg(x)
        mask = pred_mask(logits).cpu().numpy().astype(np.float32)
        proposals, scores = proposal_pass(model, feat, anchor_size_from_mask(mask), mask.shape)
    return mask, proposals, scores


def watershed_pass(model: NuSeTModel, mask: np.ndarray, proposals: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """The marker watershed in ``runtime/devicepath.fast_watershed_mode()``'s
    mode (the JAX package's dispatch, ``nuset_infer.py:276-319``): ``host``
    the host priority flood; ``auto`` the certified device watershed, the
    host flood when its certificate is not clean (counted in
    ``runtime/fallbacks``); ``on`` the ungated device pass; ``check`` that
    pass with its tie count recorded.  float32."""
    mode = fast_watershed_mode()
    with stage("stat_fish.watershed"):
        if mode == "auto":
            out, n_unc = nuset_marker_watershed_auto(scores, proposals, mask, model.bbox_min_score, model.device)
            if out is not None:
                return out.astype(np.float32)
            fallbacks.record(fallbacks.WATERSHED_UNCERTAIN_PX, n_unc)
            fallbacks.record(fallbacks.WATERSHED_HOST_RECOMPUTE)
        elif mode == "check":
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
    x = torch.from_numpy(np.ascontiguousarray(image_norm, np.float32)).to(model.device)[None, None]
    with torch.no_grad():
        logits, _ = model.unet_whole(x)
    return pred_mask(logits).cpu().numpy().astype(np.float32)


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
    hi == lo (0/0, NaN -> 0) gives an empty mask.  uint8 {0, 255}."""
    m = clean_image_gpu(torch.from_numpy(np.asarray(mask) != 0).to(device)).float()
    if tuple(out_hw) != tuple(m.shape):
        m = resize_linear_matmul(m, out_hw)
    keep = remove_small_objects_gpu(binarize(m), nuclei_size_t, connectivity=1)
    return keep.cpu().numpy().astype(np.uint8) * np.uint8(255)


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


def nuclei_segment(
    image: np.ndarray, model: NuSeTModel, nuclei_size_t, device_cleanup: Optional[bool] = None, pre=None
) -> np.ndarray:
    """reference src/utils.py:134-163: uint8 {0, 255} nuclei mask at the
    input's resolution.  ``pre``: a :func:`nuclei_segment_prepare` result
    made with the model's ``resize_scale``.  ``device_cleanup`` (default:
    ``runtime/devicepath.use_device_path()``) False runs the host cleanup
    chain, as does ``resize_scale > 1``: the host's downscale back then
    applies a gaussian prefilter the matmul resize does not."""
    if device_cleanup is None:
        device_cleanup = use_device_path()
    resize_scale = model.resize_scale
    if resize_scale > 1:
        device_cleanup = False
    image, image_wn = pre if pre is not None else nuclei_segment_prepare(image, resize_scale)
    masks1 = nuset_forward(model, image_wn, pass_two=False)
    masks_watershed = nuset_forward(model, foreground_norm(image, masks1), pass_two=True)

    if device_cleanup:
        with stage("stat_fish.cleanup"):
            return cleanup_pass(masks_watershed, output_shape(masks_watershed.shape, resize_scale), nuclei_size_t, model.device)
    return cleanup_host(masks_watershed, resize_scale, nuclei_size_t)
