"""Plain reference of NuSeT's segmentation of one stat_fish image: what
``make stat_fish`` computes as the nuclei mask of a uint16 RGB image,
written from the ecSeg sources (src/utils.py:35-163,
src/model_layers/models.py:5-136, model_RPN.py:5-46, rpn_proposal.py:4-187,
marker_watershed.py:9-103, src/nuset_utils/) in plain PyTorch, NumPy and
SciPy.  It imports nothing of the program and takes only the benchmark's
weights and images.

- decode: ``cv2.imread`` of a 16-bit colour TIFF (8-bit BGR, each sample
  ``rint(x / 257)``); the blue (DAPI) channel;
- the prep: ``skimage.transform.rescale(img, 0.3, anti_aliasing=True)`` by
  its documented semantics on SciPy (``img_as_float``, the gaussian
  prefilter with sigma ``(in / out - 1) / 2`` per axis and mode 'mirror',
  ``ndi.zoom(order=1, grid_mode=True, mode='mirror')``, the clip to the
  input's range), the crop to multiples of 16, ``whole_image_norm``;
- the whole-image U-Net in float32 (cuDNN: no TF32, deterministic, no
  autotuning; each conv's bias added after its output is rounded, as TF
  adds it; TF's 'SAME' stride-2 transpose conv as the full transpose conv
  cut to twice its input), the argmax (class 0 on ties);
- ``foreground_norm`` by that mask (zero values of the masked image
  dropped, numpy's median, the population std);
- the foreground U-Net, its mask and its feature; the RPN head; the anchor
  base size (the median larger bounding-box side of the mask's 8-connected
  regions), the anchors at stride 16, the box decode with its -1, the
  zero-area filter, the top 6000 scores by a stable sort, a plain O(n^2)
  greedy NMS to 800 at IoU > 0.01 in float32, the clip;
- the marker watershed: a point marker at the centre of each proposal
  scoring above ``min_score`` outside the 20-pixel edge band, in ascending
  score order, then the bounding-box centre of each 8-connected mask region
  of 10 pixels or more that holds none; the markers dilated by ``disk(3)``;
  the EDT of the hole-filled mask; a priority flood of its negative from
  the markers within the mask, 4-connected with watershed lines, in
  skimage's (value, age) order; the mask where the flood labelled;
- the cleanup: regions and holes under a fifth of the mean 4-connected
  region's area removed (8-connected), the rescale back by 1 / 0.3 (no
  prefilter when upscaling), the min-max binarize through uint8, objects
  under ``nuclei_size_T`` removed (4-connected); uint8 {0, 255}, cut to the
  image.

Departures from the ecSeg sources: the flood's markers enter the heap in
raster order with ages 0, 1, ... (skimage gives them all age 0 and leaves
their order to its heap), so every tie of the EDT's values is broken one
way; the greedy NMS walks the boxes in the stable score order where TF's
``non_max_suppression`` leaves equal scores to its own sort.  The model's
checkpoints are not in the repository: the weights are the benchmark's.

``tf32=True`` computes every conv on operands rounded to TF32 (10-bit
mantissa, to nearest, ties away), with float32 sums: the control.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi

EDGE = 20  # the watershed's marker-free edge band, px
S4 = ndi.generate_binary_structure(2, 1)
S8 = ndi.generate_binary_structure(2, 2)


# ----------------------------------------------------------------- decode, prep

def dapi_u8(image: np.ndarray) -> np.ndarray:
    """The blue channel of a uint16 RGB image as ``cv2.imread`` gives it."""
    return np.rint(image[..., 2] / 257.0).astype(np.uint8)


def _sk_resize(image: np.ndarray, out_shape: Tuple[int, int], anti_aliasing: bool) -> np.ndarray:
    """``skimage.transform.resize(image, out_shape, order=1, mode='reflect')``
    of a uint8 image: float64 in [0, 1]."""
    image = image.astype(np.float64) / 255.0
    factors = np.divide(image.shape, out_shape)
    filtered = image
    if anti_aliasing:
        filtered = ndi.gaussian_filter(image, np.maximum(0, (factors - 1) / 2), mode="mirror")
    out = ndi.zoom(filtered, 1 / factors, order=1, mode="mirror", grid_mode=True)
    return np.clip(out, image.min(), image.max())


def rescaled_shape(shape, scale: float) -> Tuple[int, int]:
    return tuple(int(d) for d in np.maximum(np.round(np.multiply(shape, scale)), 1))


def prep(dapi: np.ndarray, scale: float) -> Tuple[np.ndarray, np.ndarray]:
    """(the rescaled image cropped to /16, its whole-image normalization)."""
    img = _sk_resize(dapi, rescaled_shape(dapi.shape, scale), anti_aliasing=True)
    h, w = img.shape
    img = img[: h // 16 * 16, : w // 16 * 16]
    return img, (img - img.mean()) / img.std()


def foreground_norm(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    values = (img * mask).ravel()
    values = values[values != 0]
    return (img - np.median(values)) / (np.std(values) + 1e-5)


# ---------------------------------------------------------------------- networks

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10-bit mantissa, ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _flags():
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)


def unet(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, tf32: bool = False):
    """(1, 1, H, W) float32 -> (logits (1, 2, H, W), the feature after the
    fourth pool)."""
    r = tf32_round if tf32 else (lambda t: t)

    def conv(name, t, relu=True):
        wt = params[f"layers.{name}.weight"]
        y = F.conv2d(r(t), r(wt), None, padding=wt.shape[-1] // 2)
        if f"layers.{name}.bias" in params:
            y = y + params[f"layers.{name}.bias"][:, None, None]
        return torch.relu(y) if relu else y

    def up(name, t):
        y = F.conv_transpose2d(r(t), r(params[f"layers.{name}.weight"]), None, stride=2)
        return y[..., : 2 * t.shape[-2], : 2 * t.shape[-1]] + params[f"layers.{name}.bias"][:, None, None]

    n = len(cfg["widths"])
    with _flags():
        skips, t = [], x
        for i in range(1, n + 1):
            t = conv(f"conv{i}-2", conv(f"conv{i}-1", t))
            skips.append(t)
            t = F.max_pool2d(t, 2, 2)
        feat = t
        t = conv("conv5-2", conv("conv5-1", t))
        for i in range(n, 0, -1):
            if i == n and not cfg["level4_skip"]:
                t = torch.relu(up(f"deconv{i}", t))
            else:
                t = torch.cat([skips[i - 1], up(f"deconv{i}", t)], dim=1)
            t = conv(f"conv{i}-4", conv(f"conv{i}-3", t))
        return conv("final", t, relu=False), feat


def rpn(params: Dict[str, torch.Tensor], feat: torch.Tensor, tf32: bool = False):
    """(scores (h*w*A,), deltas (h*w*A, 4)) on the host, float32: the
    class-1 softmax and the box deltas, cells row-major, anchors inside."""
    r = tf32_round if tf32 else (lambda t: t)

    def conv(name, t):
        wt = params[f"layers.{name}.weight"]
        return F.conv2d(r(t), r(wt), None, padding=wt.shape[-1] // 2) + params[f"layers.{name}.bias"][:, None, None]

    with _flags():
        t = conv("rpn_conv", feat)
        score = conv("rpn_cls_score", t).permute(0, 2, 3, 1).reshape(-1, 2)
        delta = conv("rpn_bbox_pred", t).permute(0, 2, 3, 1).reshape(-1, 4)
    return torch.softmax(score, dim=-1)[:, 1].cpu().numpy(), delta.cpu().numpy()


def mask_of(logits: torch.Tensor) -> np.ndarray:
    return (logits[0].argmax(dim=0) == 1).cpu().numpy()


# --------------------------------------------------------------------- proposals

def _boxes(mask: np.ndarray, structure) -> List[Tuple[int, int, int, int, int]]:
    """(min row, min col, max row, max col exclusive, area) of each
    connected region, in label order."""
    lab, _ = ndi.label(mask, structure=structure)
    area = np.bincount(lab.ravel())
    return [(sl[0].start, sl[1].start, sl[0].stop, sl[1].stop, int(area[k]))
            for k, sl in enumerate(ndi.find_objects(lab), 1) if sl is not None]


def anchor_base(mask: np.ndarray) -> float:
    sides = [max(c1 - c0, r1 - r0) for r0, c0, r1, c1, _ in _boxes(mask, S8)]
    return float(np.median(sides)) if sides else float("nan")


def anchors(base: float, cfg: Dict, feat_hw: Tuple[int, int]) -> np.ndarray:
    """(fh * fw * A, 4) float32 (x1, y1, x2, y2): the 3 scales x 7 ratios
    about the origin, shifted to each cell of the stride grid."""
    scales, ratios = np.meshgrid(np.asarray(cfg["anchor_scales"], float), np.asarray(cfg["anchor_ratios"], float))
    scales, sq = scales.ravel(), np.sqrt(ratios.ravel())
    hs, ws = scales * sq * base, scales / sq * base
    ref = np.stack([-(ws - 1) / 2, -(hs - 1) / 2, (ws - 1) / 2, (hs - 1) / 2], axis=1)
    step = cfg["anchor_stride"]
    xs, ys = np.meshgrid(np.arange(feat_hw[1]) * step, np.arange(feat_hw[0]) * step)
    shift = np.stack([xs.ravel(), ys.ravel(), xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    return (ref[None] + shift[:, None]).reshape(-1, 4).astype(np.float32)


def decode(a: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Boxes (x1, y1, x2, y2) of anchors ``a`` moved by deltas ``d``, float32."""
    w, h = a[:, 2] - a[:, 0] + np.float32(1), a[:, 3] - a[:, 1] + np.float32(1)
    cx, cy = a[:, 0] + np.float32(0.5) * w, a[:, 1] + np.float32(0.5) * h
    px, py = d[:, 0] * w + cx, d[:, 1] * h + cy
    pw, ph = np.exp(d[:, 2]) * w, np.exp(d[:, 3]) * h
    half = np.float32(0.5)
    return np.stack([px - half * pw, py - half * ph, px + half * pw - np.float32(1), py + half * ph - np.float32(1)], 1)


def nms(boxes: np.ndarray, count: int, thresh: float, limit: int) -> List[int]:
    """Greedy NMS over the first ``count`` boxes (y1, x1, y2, x2), in order:
    keep the next live box, drop every box whose IoU with it exceeds
    ``thresh``; at most ``limit`` kept."""
    y1, x1, y2, x2 = (boxes[:count, k] for k in range(4))
    zero = np.float32(0)
    area = np.maximum(y2 - y1, zero) * np.maximum(x2 - x1, zero)
    live = np.ones(count, bool)
    kept: List[int] = []
    thr = np.float32(thresh)
    for i in range(count):
        if not live[i]:
            continue
        kept.append(i)
        if len(kept) == limit:
            break
        inter = np.maximum(np.minimum(y2[i], y2) - np.maximum(y1[i], y1), zero) * \
            np.maximum(np.minimum(x2[i], x2) - np.maximum(x1[i], x1), zero)
        union = area[i] + area - inter
        iou = np.divide(inter, union, out=np.zeros_like(inter), where=union > 0)
        live &= ~(iou > thr)
    return kept


def proposals(scores: np.ndarray, deltas: np.ndarray, mask: np.ndarray, feat_hw, cfg: Dict):
    """(boxes (P, 4) x1 y1 x2 y2 clipped, scores (P,)), in NMS order."""
    boxes = decode(anchors(anchor_base(mask), cfg, feat_hw), deltas)
    zero = np.float32(0)
    valid = np.maximum(boxes[:, 2] - boxes[:, 0], zero) * np.maximum(boxes[:, 3] - boxes[:, 1], zero) > 0
    scores = np.where(valid, scores, -np.inf).astype(np.float32)
    order = np.argsort(-scores, kind="stable")[: cfg["pre_nms_top_n"]]
    count = int(np.count_nonzero(scores[order] > -np.inf))  # the valid ones sort first
    kept = order[nms(boxes[order][:, [1, 0, 3, 2]], count, cfg["nms_threshold"], cfg["post_nms_top_n"])]
    h, w = mask.shape
    out = boxes[kept]
    out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0, w - 1)
    out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0, h - 1)
    return out, scores[kept]


# --------------------------------------------------------------------- watershed

def markers_of(boxes: np.ndarray, scores: np.ndarray, mask: np.ndarray, min_score: float):
    """The marker map, or None when no proposal scores above ``min_score``."""
    if not (scores.size and scores.max() > min_score):
        return None
    h, w = mask.shape
    markers = np.zeros((h, w), np.float32)
    top = scores > min_score
    p = 1
    for b in boxes[top][scores[top].argsort()]:
        row, col = int(round((b[3] + b[1]) / 2)), int(round((b[2] + b[0]) / 2))
        if EDGE <= row < h - EDGE and EDGE <= col < w - EDGE:
            markers[row, col] = p
            p += 1
    for r0, c0, r1, c1, area in _boxes(mask, S8):
        if area < 10:
            continue
        r0, c0, r1, c1 = (int(np.clip(v, 0, n - 1)) for v, n in ((r0, h), (c0, w), (r1, h), (c1, w)))
        if markers[r0:r1, c0:c1].sum() == 0:
            markers[int(round((r0 + r1) / 2)), int(round((c0 + c1) / 2))] = p
            p += 1
    return markers


def flood(height: np.ndarray, seeds: np.ndarray, within: np.ndarray) -> np.ndarray:
    """skimage's ``watershed(height, seeds, mask=within, watershed_line=True)``
    4-connected: a min-heap of (height, age); a pixel takes its label when
    popped; a pixel next to another label is a line pixel, 0 at the end."""
    h, w = height.shape
    label = np.where(within, seeds, 0).astype(np.int64)
    line = np.zeros((h, w), bool)
    heap = [(height[y, x], age, y, x, y, x) for age, (y, x) in enumerate(zip(*np.nonzero(label)))]
    heapq.heapify(heap)
    age = len(heap)
    while heap:
        _, _, y, x, sy, sx = heapq.heappop(heap)
        if label[y, x] and (y, x) != (sy, sx):
            continue
        label[y, x] = label[sy, sx]
        for ny, nx in ((y - 1, x), (y, x - 1), (y, x + 1), (y + 1, x)):
            if not (0 <= ny < h and 0 <= nx < w) or not within[ny, nx]:
                continue
            if label[ny, nx]:
                line[y, x] |= label[ny, nx] != label[y, x]
                continue
            age += 1
            heapq.heappush(heap, (height[ny, nx], age, ny, nx, y, x))
    label[line] = 0
    return label


def disk(radius: int) -> np.ndarray:
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    return yy**2 + xx**2 <= radius**2


def watershed(boxes, scores, mask: np.ndarray, min_score: float) -> np.ndarray:
    markers = markers_of(boxes, scores, mask, min_score)
    if markers is None:
        return mask.astype(np.int32)
    seeds = ndi.grey_dilation(markers, footprint=disk(3))
    height = -ndi.distance_transform_edt(ndi.binary_fill_holes(mask))
    return (mask & (flood(height, seeds, mask) != 0)).astype(np.int32)


# ----------------------------------------------------------------------- cleanup

def _drop_small(mask: np.ndarray, size: float, structure) -> np.ndarray:
    """``mask`` without its connected regions of fewer than ``size`` pixels."""
    lab, n = ndi.label(mask, structure=structure)
    if n == 0 or size <= 1:
        return mask.copy()
    keep = np.bincount(lab.ravel()) >= size
    keep[0] = False
    return keep[lab]


def cleanup(mask: np.ndarray, scale: float, size_t: int) -> np.ndarray:
    mask = mask != 0
    n = ndi.label(mask, structure=S4)[1]
    small = mask.sum() / n / 5 if n else 0.0
    mask = _drop_small(mask, small, S8)
    mask = ~_drop_small(~mask, small + 1, S8)  # holes of at most ``small`` pixels filled
    up = _sk_resize(mask.astype(np.uint8), rescaled_shape(mask.shape, 1 / scale), anti_aliasing=False)
    lo, hi = up.min(), up.max()
    with np.errstate(invalid="ignore", divide="ignore"):
        u8 = ((up - lo) / (hi - lo) * 255).astype(np.uint8)
    return _drop_small(u8 > 0, size_t, S4).astype(np.uint8) * np.uint8(255)


# ------------------------------------------------------------------------ segment

def segment(params: Dict[str, Dict[str, torch.Tensor]], image: np.ndarray, cfg: Dict, tf32: bool = False) -> np.ndarray:
    """The uint8 {0, 255} nuclei mask of one uint16 RGB image, cut to the
    image, with the networks on the weights' device."""
    dapi = dapi_u8(image)
    img, whole = prep(dapi, cfg["scale_ratio"])
    device = params["rpn"]["layers.rpn_conv.weight"].device
    as_input = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)[None, None]
    with torch.no_grad():
        mask1 = mask_of(unet(params["whole"], as_input(whole), cfg, tf32)[0])
        logits, feat = unet(params["fg"], as_input(foreground_norm(img, mask1)), cfg, tf32)
        mask2 = mask_of(logits)
        scores, deltas = rpn(params["rpn"], feat, tf32)
    boxes, kept_scores = proposals(scores, deltas, mask2, feat.shape[-2:], cfg)
    split = watershed(boxes, kept_scores, mask2, cfg["min_score"])
    out = cleanup(split, cfg["scale_ratio"], cfg["nuclei_size_T"])
    h, w = dapi.shape
    return out[:h, :w]
