"""Plain reference of metaseg on one image: what ``make metaseg`` computes
from a uint16 DAPI image, written from the ecSeg source (src/utils.py:109-120,
src/image_tools.py:15-252) in plain PyTorch, NumPy and SciPy.  It imports
nothing of the program and takes only the benchmark's weights and images.

- preprocess: uint16 -> uint8 (``convertScaleAbs(alpha=255/65535)``: round
  half to even, saturate), the blue channel of a colour image, Otsu's
  threshold as OpenCV computes it, inverted when more than half the image
  is above it;
- the overlap patches (256 px, 25 px overlap) and the reference's stitch
  plan, its asymmetric rim copies and its ``:242`` axis mix-up included;
- the U-Net forward in float32 (cuDNN's TF32 off), softmax, ``img_as_ubyte``
  and the argmax (first maximum on ties) of each patch;
- ``meta_inference`` with its quirks (``merge_comp`` skips scipy's last
  label, the stale ecDNA list of ``size_thresh``, NaN means);
- the ecDNA count: 8-connected components of class 3.

``tf32=True`` computes every conv on operands rounded to TF32 (10-bit
mantissa, to nearest, ties away), with float32 sums: the control.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage as ndi

OVERLAP = 25
SCW = 256
EC_SIZE_THRESHOLD = 15
S8 = ndi.generate_binary_structure(2, 2)
D1 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


# ---------------------------------------------------------------- preprocess

def otsu_u8(img: np.ndarray) -> int:
    """OpenCV's ``getThreshVal_Otsu_8u``: double sums, FLT_EPSILON skips,
    first maximum."""
    hist = np.bincount(img.ravel(), minlength=256).astype(np.float64)
    scale = 1.0 / img.size
    mu = float((np.arange(256) * hist).sum()) * scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = best = 0.0
    thresh = 0
    for i in range(256):
        p = hist[i] * scale
        mu1 *= q1
        q1 += p
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) ** 2
        if sigma > best:
            best, thresh = sigma, i
    return thresh


def preprocess(img: np.ndarray) -> np.ndarray:
    img = np.clip(np.rint(img.astype(np.float64) * (255.0 / 65535.0)), 0, 255).astype(np.uint8)
    if img.ndim > 2:
        img = img[:, :, 2]
    img = np.ascontiguousarray(img)
    if np.sum(img > otsu_u8(img)) > img.shape[0] * img.shape[1] * 0.5:
        img = ~img
    return img


# -------------------------------------------------------------- patch, stitch

def positions(h: int, w: int) -> List[Tuple[int, int]]:
    spw = SCW - 2 * OVERLAP
    qh, rh = divmod(h - 2 * OVERLAP, spw)
    qw, rw = divmod(w - 2 * OVERLAP, spw)
    ys = [spw * e for e in range(qh)] + ([h - 2 * OVERLAP - spw] if rh else [])
    xs = [spw * e for e in range(qw)] + ([w - 2 * OVERLAP - spw] if rw else [])
    xx, yy = np.meshgrid(ys, xs)  # the reference's meshgrid order
    return [(int(a), int(b)) for a, b in zip(xx.ravel(), yy.ravel())]


def stitch(labels: np.ndarray, pos: List[Tuple[int, int]]) -> np.ndarray:
    """The reference's stitcher (src/image_tools.py:188-252) on label patches."""
    ov, spw = OVERLAP, SCW - 2 * OVERLAP
    h_l, w_l = max(p[0] for p in pos), max(p[1] for p in pos)
    H, W = h_l + SCW, w_l + SCW
    out = np.zeros((H, W), labels.dtype)

    def put(i, sy, sx, dy, dx, sh, sw):
        if sh > 0 and sw > 0:
            out[dy : dy + sh, dx : dx + sw] = labels[i, sy : sy + sh, sx : sx + sw]

    for i, (py, px) in enumerate(pos):
        if py == 0:
            if px == 0:
                put(i, 0, 0, 0, 0, ov, ov)
                put(i, ov, 0, ov, 0, SCW - 2 * ov, ov)
                put(i, 0, ov, 0, ov, ov, SCW - 2 * ov)
            else:
                if px == w_l:
                    put(i, 0, SCW - ov, 0, W - ov, ov, ov)
                put(i, 0, ov, 0, px + ov, ov, SCW - 2 * ov)
        if px == 0 and py != 0:
            put(i, ov, 0, py + ov, 0, SCW - 2 * ov, ov)
        if py == h_l:
            if px == w_l:
                put(i, SCW - ov, SCW - ov, H - ov, W - ov, ov, ov)
                put(i, ov, SCW - ov, h_l + ov, W - ov, H - ov - (h_l + ov), ov)
                put(i, SCW - ov, ov, H - ov, w_l + ov, ov, W - ov - (w_l + ov))
            else:
                if px == 0:
                    put(i, SCW - ov, 0, H - ov, 0, ov, ov)
                put(i, SCW - ov, ov, H - ov, px + ov, ov, SCW - 2 * ov)
        if px == w_l and px != h_l:  # the reference's :242
            put(i, ov, SCW - ov, py + ov, W - ov, SCW - 2 * ov, ov)
    for i, (py, px) in enumerate(pos):
        put(i, ov, ov, py + ov, px + ov, spw, spw)
    return out


# ------------------------------------------------------------------- forward

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10-bit mantissa, ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: Dict, tf32: bool = False) -> torch.Tensor:
    """(N, 256, 256) uint8 patches -> (N, 256, 256) uint8 labels."""
    r = tf32_round if tf32 else (lambda t: t)

    def conv(name, t, relu=True):
        wt = params[f"layers.{name}.weight"]
        y = F.conv2d(r(t), r(wt), params[f"layers.{name}.bias"], padding=wt.shape[-1] // 2)
        return torch.relu(y) if relu else y

    def up(name, t):
        y = F.conv_transpose2d(r(t), r(params[f"layers.{name}.weight"]), params[f"layers.{name}.bias"], stride=2)
        return torch.relu(y[..., : 2 * t.shape[-2], : 2 * t.shape[-1]])

    n = len(cfg["widths"])
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        t = x[:, None].float() / 255.0
        skips = []
        for i in range(1, n + 1):
            t = conv(f"enc{i}_2", conv(f"enc{i}_1", t))
            skips.append(t)
            t = F.max_pool2d(t, 2, 2, ceil_mode=True)
        t = conv("bott_2", conv("bott_1", t))
        for i in range(n, 0, -1):
            t = torch.cat([skips[i - 1], up(f"up{i}", t)], dim=1)
            t = conv(f"dec{i}_2", conv(f"dec{i}_1", t))
        probs = torch.softmax(conv("head", t, relu=False).float(), dim=1)
    q = torch.round(probs.double() * 255).clamp(0, 255).to(torch.uint8)
    return torch.argmax(q, dim=1).to(torch.uint8)


# ---------------------------------------------------------------------- post

def _lut_write(img, labels, flags, value):
    img[flags[labels]] = value


def _regions(mask):
    lab, n = ndi.label(mask, structure=S8)
    return lab, n, np.bincount(lab.ravel(), minlength=n + 1)


def _mean_area(areas, n):
    return areas[1:].mean() if n else np.nan


def _merge_comp(img: np.ndarray, class_id: int) -> np.ndarray:
    mask_id = 2 if class_id == 1 else 1
    temp = img == mask_id
    img[temp] = 0
    lab, n = ndi.label(img, structure=S8)
    lut = np.zeros(n + 1, bool)
    lut[np.unique(lab[img == class_id])] = True
    lut[0] = False
    if n >= 1:
        lut[n] = False  # the reference's loop stops before the last label
    img[lut[lab]] = class_id
    opened = ndi.grey_dilation(ndi.grey_erosion(img, footprint=D1), footprint=D1)
    img[opened == class_id] = class_id
    img[temp] = mask_id
    return img


def _centroids(mask):
    lab, n = ndi.label(mask, structure=S8)
    flat = lab.ravel()
    ys, xs = np.indices(mask.shape)
    counts = np.bincount(flat, minlength=n + 1)[1:]
    cy = np.bincount(flat, ys.ravel().astype(np.float64), minlength=n + 1)[1:] / counts
    cx = np.bincount(flat, xs.ravel().astype(np.float64), minlength=n + 1)[1:] / counts
    return lab, cy, cx


def post(img: np.ndarray) -> np.ndarray:
    """``meta_inference`` (src/image_tools.py:15-84) of an int64 label map."""
    img = img.astype(np.int64)
    for c in (1, 2):
        img[ndi.binary_fill_holes(img == c)] = c
    # size thresholds (src/image_tools.py:41-59)
    nuc, n_n, a_n = _regions(img == 1)
    _, n_c, a_c = _regions(img == 2)
    _lut_write(img, nuc, np.r_[False, a_n[1:] < _mean_area(a_c, n_c)], 0)
    chrom, n_c, a_c = _regions(img == 2)
    ec, n_e, a_e = _regions(img == 3)
    _lut_write(img, chrom, np.r_[False, a_c[1:] < _mean_area(a_e, n_e)], 3)
    _lut_write(img, ec, np.r_[False, a_e[1:] < EC_SIZE_THRESHOLD], 0)  # the stale list
    ec = img == 3
    img[ndi.binary_dilation(ec, D1) ^ ndi.binary_erosion(ec, D1, border_value=1)] = 0
    # metaphase removal (src/image_tools.py:61-81)
    _, c_y, c_x = _centroids(img == 2)
    nuc, n_y, n_x = _centroids(img == 1)
    remove = [False]
    for ny, nx in zip(n_y, n_x):
        left = np.sum((c_x > nx) & (c_x < nx + 70)) > 5
        right = np.sum((c_x < nx) & (c_x > nx - 70)) > 5
        bottom = np.sum((c_y < ny) & (c_y > ny - 70)) > 5
        top = np.sum((c_y > ny) & (c_y < ny + 70)) > 5
        remove.append(bool(left and right and bottom and top))
    _lut_write(img, nuc, np.array(remove), 0)
    img = _merge_comp(_merge_comp(img, 1), 2)
    img[ndi.binary_dilation(img == 3, D1)] = 3
    return img


def count_ec(labels: np.ndarray) -> int:
    return int(ndi.label(labels == 3, structure=S8)[1])


def segment(params: Dict[str, torch.Tensor], image: np.ndarray, cfg: Dict, tf32: bool = False) -> Tuple[np.ndarray, int]:
    """(int64 labels, #ecDNA) of one uint16 image, on the weights' device."""
    img = preprocess(image)
    pos = positions(*img.shape)
    patches = np.stack([img[y : y + SCW, x : x + SCW] for y, x in pos])
    device = params["layers.head.weight"].device
    with torch.no_grad():
        labels = forward(params, torch.from_numpy(patches).to(device), cfg, tf32).cpu().numpy()
    out = post(stitch(labels, pos))
    return out, count_ec(out)
