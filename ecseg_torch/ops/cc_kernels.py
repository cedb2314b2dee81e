"""The metaseg path's CUDA kernels, their plain PyTorch twins, and launch
counters.

| B  | wrapper             | CUDA source          | replaces (ecseg_tpu/ops/...)          |
|----|---------------------|----------------------|---------------------------------------|
| B1 | stitch_labels       | csrc/stitch.cu       | cc_pallas.stitch_labels_pallas        |
| B2 | label               | csrc/cc_label.cu     | cc_pallas.label_pallas (+ banded)     |
| B3 | flood_from_border   | csrc/cc_flood.cu     | cc_pallas.flood_from_border_pallas    |
| B4 | flood_from_seeds    | csrc/cc_flood.cu     | cc_pallas.flood_from_seeds_pallas (+ banded) |
| B5 | label_multiclass    | csrc/cc_label.cu     | cc_pallas.label_multiclass_pallas     |
| B6 | flood_multiclass    | csrc/cc_flood.cu     | cc_pallas.flood_multiclass_pallas     |
| B8a | count_components   | csrc/cc_count.cu     | cc_pallas.count_cc_pallas             |
| B8b | count_from_patches | csrc/cc_count.cu     | cc_pallas.count_cc_from_patches       |
| B9 | label_and_flood     | csrc/cc_flood.cu     | cc_pallas.label_and_flood_pallas      |

B2 (entry ``ecseg_label``), B3 (``ecseg_flood_border``), B4
(``ecseg_flood``), B5 (``ecseg_label_mc``), B6 (``ecseg_flood_mc``) and B9
(``ecseg_label_flood``) build the tiled union-find forest of
csrc/cc_label.cuh: each 32x32 tile united in shared memory, then unions
across tile edges only; B8a (``ecseg_count``) and B8b
(``ecseg_count_patches``) count on the same passes, over a forest of the
tiles' border pixels, B8a reading its mask row-major.  B1 and B8b read the
stitch plan as per-row and per-column descriptors (``stitch_descriptors``,
checked against the replayed plan before first use), never a per-pixel
source map.

Dispatch is by where the input lies: a CPU tensor goes to the plain twin
(``*_plain``), a CUDA tensor to the kernel, anything else raises.  There is
no fallback from a failing kernel to its twin.  ``LAUNCHES`` counts kernel
launches per wrapper (never twin calls), so a run can show that it went
through the kernels; it and the ctypes bindings (``_launch``) also serve
B10 (``ops/fused_tail.py``), B11 (``ops/convt.py``) and H1 (``ops/conv3x3.py``).  The twins are plain torch on any device and are the
reference the kernels are held against on the card.  Class maps (B5, B6)
enter the kernels as contiguous uint8; masks and seeds as bool.  B8b takes
the patch labels as uint8 (``tiling.patch_labels``) or int32 (kernel B10's
output).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .tiling import SCW, stitch_plan

LAUNCHES: Dict[str, int] = {
    "stitch": 0,
    "label": 0,
    "flood_border": 0,
    "flood_seeds": 0,
    "label_mc": 0,
    "flood_mc": 0,
    "label_flood": 0,
    "count": 0,
    "count_patches": 0,
    "fused_tail": 0,  # B10, ops/fused_tail.py
    "convt": 0,  # B11, ops/convt.py
    "conv3x3": 0,  # H1, ops/conv3x3.py
}


_launches_lock = threading.Lock()


def count_launch(key: str) -> None:
    """Add one to ``LAUNCHES[key]``; wrappers call it where they launch
    their kernel.  Under a lock: threads of a fan-out launch at once, and
    ``d[k] += 1`` can lose increments between threads."""
    with _launches_lock:
        LAUNCHES[key] += 1


def reset_launches() -> None:
    with _launches_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# plain twins
# --------------------------------------------------------------------------


def stitch_plain(label_patches: torch.Tensor, positions) -> torch.Tensor:
    """B1 twin: replay the copy plan with slicing; (H, W) int32."""
    copies, H, W = stitch_plan(tuple(map(tuple, positions)))
    canvas = torch.zeros((H, W), dtype=torch.int32, device=label_patches.device)
    for (i, sy, sx, dy, dx, sh, sw) in copies:
        canvas[dy : dy + sh, dx : dx + sw] = label_patches[i, sy : sy + sh, sx : sx + sw]
    return canvas


def _neighbour_min(lab: torch.Tensor, big: int, connectivity: int) -> torch.Tensor:
    p = F.pad(lab, (1, 1, 1, 1), value=big)
    if connectivity == 2:  # separable 3x3 window
        m = torch.minimum(torch.minimum(p[:, :-2], p[:, 1:-1]), p[:, 2:])
        return torch.minimum(torch.minimum(m[:-2], m[1:-1]), m[2:])
    m = torch.minimum(lab, p[:-2, 1:-1])
    m = torch.minimum(m, p[2:, 1:-1])
    m = torch.minimum(m, p[1:-1, :-2])
    return torch.minimum(m, p[1:-1, 2:])


def _run_min_rows(lab: torch.Tensor, mask: torch.Tensor, big: int) -> torch.Tensor:
    """Min of ``lab`` over each horizontal run of ``mask`` (one step for any
    run length)."""
    n = lab.numel()
    start = mask.clone()
    start[:, 1:] &= ~mask[:, :-1]
    run = torch.cumsum(start.reshape(-1), 0) - 1
    run = torch.where(mask.reshape(-1), run, n)  # background -> spare slot
    mins = torch.full((n + 1,), big, dtype=lab.dtype, device=lab.device)
    mins.scatter_reduce_(0, run, lab.reshape(-1), "amin")
    return torch.where(mask, mins[run].view_as(lab), big)


def _pointer_jump(lab: torch.Tensor, big: int) -> torch.Tensor:
    """``lab = lab.flatten()[lab]`` to its fixpoint (log-depth rounds)."""
    flat = torch.cat([lab.reshape(-1), lab.new_full((1,), big)])
    while True:
        nxt = flat[flat]
        if torch.equal(nxt, flat):
            return flat[:-1].view_as(lab)
        flat = nxt


def label_plain(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """B2 twin: canonical labels (min flat index of the component, -1 on
    background) by min-propagation -- 3x3 (or cross) window, row and column
    run minima -- plus pointer jumping, to a fixpoint.  Every label is always
    the index of a pixel of the same component and only decreases, so the
    fixpoint is the component minimum; runs and jumps keep snakes and
    spirals from costing one iteration per pixel of their length."""
    h, w = mask.shape
    n = h * w
    if n == 0:
        return torch.empty((h, w), dtype=torch.int32, device=mask.device)
    mask = mask.bool()
    mask_t = mask.t().contiguous()
    idx = torch.arange(n, device=mask.device).view(h, w)
    lab = torch.where(mask, idx, n)
    while True:
        new = torch.where(mask, _neighbour_min(lab, n, connectivity), n)
        new = _run_min_rows(new, mask, n)
        new = _run_min_rows(new.t().contiguous(), mask_t, n).t()
        new = _pointer_jump(new, n)
        if torch.equal(new, lab):
            break
        lab = new
    return torch.where(mask, lab, -1).to(torch.int32)


def _flood_plain(trav: torch.Tensor, seeds: torch.Tensor, connectivity: int) -> torch.Tensor:
    h, w = trav.shape
    n = h * w
    trav = trav.bool()
    lab = label_plain(trav, connectivity).reshape(-1).long()
    flat = torch.where(lab < 0, n, lab)
    marks = torch.zeros(n + 1, dtype=torch.bool, device=trav.device)
    marks[torch.where((seeds.bool() & trav).reshape(-1), flat, n)] = True
    marks[n] = False
    return marks[flat].view(h, w)


def _border_mask(h: int, w: int, device) -> torch.Tensor:
    b = torch.zeros((h, w), dtype=torch.bool, device=device)
    b[0, :] = b[-1, :] = True
    b[:, 0] = b[:, -1] = True
    return b


def flood_from_border_plain(trav: torch.Tensor) -> torch.Tensor:
    """B3 twin: traversable pixels 4-connected to the image border."""
    h, w = trav.shape
    if h * w == 0:
        return torch.zeros((h, w), dtype=torch.bool, device=trav.device)
    return _flood_plain(trav, _border_mask(h, w, trav.device), 1)


def flood_from_seeds_plain(
    trav: torch.Tensor, seeds: torch.Tensor, connectivity: int = 2
) -> torch.Tensor:
    """B4 twin: traversable pixels connected to a seed through traversable
    pixels (seeds off the mask are ignored)."""
    if trav.numel() == 0:
        return torch.zeros(trav.shape, dtype=torch.bool, device=trav.device)
    return _flood_plain(trav, seeds, connectivity)


def _classes(cls_map: torch.Tensor):
    return [int(c) for c in torch.unique(cls_map) if int(c) != 0]


def label_multiclass_plain(cls_map: torch.Tensor) -> torch.Tensor:
    """B5 twin: ``label_plain`` (8-connected) of each class present, merged;
    -1 on class 0."""
    out = torch.full(cls_map.shape, -1, dtype=torch.int32, device=cls_map.device)
    for c in _classes(cls_map):
        m = cls_map == c
        out = torch.where(m, label_plain(m, 2), out)
    return out


def flood_multiclass_plain(cls_map: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """B6 twin: OR over the classes present of the seeded flood of each
    class's mask from the seeds on it (seeds on class 0 are ignored)."""
    out = torch.zeros(cls_map.shape, dtype=torch.bool, device=cls_map.device)
    for c in _classes(cls_map):
        m = cls_map == c
        out |= flood_from_seeds_plain(m, seeds.bool() & m, 2)
    return out


def label_and_flood_plain(
    mask: torch.Tensor, seeds: torch.Tensor, connectivity: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9 twin: (``label_plain``, ``flood_from_seeds_plain``) of one mask."""
    return label_plain(mask, connectivity), flood_from_seeds_plain(mask, seeds, connectivity)


def count_components_plain(mask: torch.Tensor, connectivity: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8a twin: (number of components, foreground pixels) of a (H, W) mask
    as 0-d int32 tensors: the roots of ``label_plain`` (pixels labeled with
    their own flat index) and the labeled pixels."""
    lab = label_plain(mask, connectivity).reshape(-1)
    idx = torch.arange(lab.numel(), device=lab.device)
    return (lab == idx).sum().to(torch.int32), (lab >= 0).sum().to(torch.int32)


def count_from_patches_plain(
    label_patches: torch.Tensor, positions, class_id: int = 3, connectivity: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8b twin: replay the copy plan writing each copy's ``== class_id``
    into a zeroed mask, as the Pallas kernel does (a pixel no copy reaches
    is background, whatever ``class_id``), then count it.  (N, S, S) patch
    labels give 0-d (count, px); a batch (T, N, S, S) gives (T,) each."""
    copies, H, W = stitch_plan(tuple(map(tuple, positions)))
    lp = label_patches if label_patches.dim() == 4 else label_patches[None]
    masks = torch.zeros((lp.shape[0], H, W), dtype=torch.bool, device=lp.device)
    for (i, sy, sx, dy, dx, sh, sw) in copies:
        masks[:, dy : dy + sh, dx : dx + sw] = lp[:, i, sy : sy + sh, sx : sx + sw] == class_id
    pairs = [count_components_plain(m, connectivity) for m in masks]
    count = torch.stack([c for c, _ in pairs]) if pairs else torch.zeros(0, dtype=torch.int32)
    px = torch.stack([p for _, p in pairs]) if pairs else torch.zeros(0, dtype=torch.int32)
    if label_patches.dim() == 3:
        return count[0], px[0]
    return count, px


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ecseg_stitch": ("stitch.cu", [_P, _P, _P, _I, _I, _P]),
    "ecseg_label": ("cc_label.cu", [_P, _P, _I, _I, _I, _P]),
    "ecseg_flood_border": ("cc_flood.cu", [_P, _P, _P, _P, _I, _I, _P]),
    "ecseg_flood": ("cc_flood.cu", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "ecseg_label_mc": ("cc_label.cu", [_P, _P, _I, _I, _P]),
    "ecseg_flood_mc": ("cc_flood.cu", [_P, _P, _P, _P, _P, _I, _I, _P]),
    "ecseg_label_flood": ("cc_flood.cu", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "ecseg_count": ("cc_count.cu", [_P, _P, _I, _I, _I, _P, _P]),
    "ecseg_count_patches": ("cc_count.cu", [_P, _I, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P]),
    "ecseg_fused_tail": ("fused_tail.cu", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "ecseg_fused_tail_mma": ("fused_tail.cu", [_P, _P, _P, _P, _P, _P, _P] + [_I] * 13 + [_P]),
    "ecseg_convt": ("convt.cu", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "ecseg_convt_mma": ("convt.cu", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "ecseg_conv3x3": ("conv3x3_f32.cu", [_P, _P, _P, _P, _P] + [_I] * 10 + [_P]),
}
_cfuncs: Dict[str, ctypes._CFuncPtr] = {}


def _cfunc(name: str):
    fn = _cfuncs.get(name)
    if fn is None:
        from .._build import library

        source, argtypes = _SIGNATURES[name]
        fn = getattr(library(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _cfuncs[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the entry ``name`` on ``device``'s current stream.  The device is
    made current only when it is not (entering ``torch.cuda.device`` and
    building a ``Stream`` object cost more host time than the small kernels
    take on the card)."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        with torch.cuda.device(index):
            return _launch(name, device, *args)
    rc = _cfunc(name)(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.numel() >= 2**31:
        raise ValueError(f"{what}: {t.numel()} elements overflow the kernels' int32 indices")


def _check_pair(t: torch.Tensor, seeds: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    _check(t, what, dtype, 2)
    _check(seeds, f"{what} seeds", torch.bool, 2)
    if seeds.shape != t.shape or seeds.device != t.device:
        raise ValueError(f"{what}: seeds must match the map in shape and device")


@functools.lru_cache(maxsize=8)
def _source_map(positions: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    """int32 (H, W): flat index into the (N, SCW, SCW) patch stack of the
    plan's LAST copy onto each pixel, -1 where no copy lands."""
    copies, H, W = stitch_plan(positions)
    src = np.full((H, W), -1, np.int32)
    for (i, sy, sx, dy, dx, sh, sw) in copies:
        rows = (sy + np.arange(sh, dtype=np.int32))[:, None] * SCW
        cols = (sx + np.arange(sw, dtype=np.int32))[None, :]
        src[dy : dy + sh, dx : dx + sw] = i * SCW * SCW + rows + cols
    return torch.from_numpy(src).to(device)


def stitch_descriptors(src: np.ndarray) -> np.ndarray:
    """The (H, W) source map of a stitch plan (``_source_map``) as the
    per-column and per-row descriptors that kernels B1 and B8b read
    (csrc/stitch_plan.cuh): int32, W columns of {C, bits, run, 0} then H
    rows of {R, bits}.  Where a copy lands, src[y, x] = R[y] + C[x]; where
    none does, the row's and the column's bits share one (a bit per distinct
    set of unreached columns).  ``run``: how many columns from this one on
    continue it (C one more each, the same bits).  ``_descriptors`` checks
    the result against ``src``; this derivation only assumes the form."""
    h, w = src.shape
    src = src.astype(np.int64)
    cov = src >= 0
    # C from the row that most copies reach, R from a column each row
    # shares with it, then C of the columns that row misses
    y0 = int(cov.sum(1).argmax())
    c = np.where(cov[y0], src[y0], 0)
    shared = cov & cov[y0]
    xr = shared.argmax(1)
    r = np.where(shared.any(1), src[np.arange(h), xr] - c[xr], 0)
    yc = cov.argmax(0)
    c = np.where(cov.any(0) & ~cov[y0], src[yc, np.arange(w)] - r[yc], c)
    rbits = np.zeros(h, np.uint32)
    cbits = np.zeros(w, np.uint32)
    bits = {}
    for y in np.flatnonzero(~cov.all(1)):
        unreached = ~cov[y]
        key = unreached.tobytes()
        if key not in bits:
            if len(bits) == 32:
                raise ValueError(f"stitch plan {h}x{w}: more than 32 distinct sets of unreached columns")
            bits[key] = np.uint32(1 << len(bits))
            cbits[unreached] |= bits[key]
        rbits[y] |= bits[key]
    run = np.ones(w, np.int64)
    cont = (np.diff(c) == 1) & (cbits[1:] == cbits[:-1])  # column x + 1 continues x
    for x in range(w - 2, -1, -1):
        if cont[x]:
            run[x] = run[x + 1] + 1
    desc = np.zeros(4 * w + 2 * h, np.int32)
    cols = desc[: 4 * w].reshape(w, 4)
    rows = desc[4 * w :].reshape(h, 2)
    cols[:, 0], cols[:, 1], cols[:, 2] = c, cbits.view(np.int32), run
    rows[:, 0], rows[:, 1] = r, rbits.view(np.int32)
    return desc


def expand_descriptors(desc: np.ndarray, h: int, w: int) -> np.ndarray:
    """The (h, w) source map that ``stitch_descriptors`` output stands for
    (int64, -1 where no copy lands), computed as the kernels compute it."""
    cols = desc[: 4 * w].reshape(w, 4).astype(np.int64)
    rows = desc[4 * w : 4 * w + 2 * h].reshape(h, 2).astype(np.int64)
    unreached = (rows[:, 1:2] & cols[None, :, 1]) != 0
    return np.where(unreached, -1, rows[:, :1] + cols[None, :, 0])


def check_descriptors(desc: np.ndarray, src: np.ndarray, what: str) -> None:
    """Raise ``ValueError`` naming ``what`` unless ``desc`` reproduces the
    source map ``src`` pixel for pixel and every column's ``run`` holds."""
    h, w = src.shape
    if desc.shape != (4 * w + 2 * h,):
        raise ValueError(f"{what}: descriptors of shape {desc.shape}, expected ({4 * w + 2 * h},)")
    bad = int((expand_descriptors(desc, h, w) != src).sum())
    if bad:
        raise ValueError(f"{what}: the row/column descriptors give another source than the plan at {bad} pixels")
    cols = desc[: 4 * w].reshape(w, 4).astype(np.int64)
    run = cols[:, 2]
    nxt = np.append((np.diff(cols[:, 0]) == 1) & (cols[1:, 1] == cols[:-1, 1]), False)
    holds = (run >= 1) & (np.arange(w) + run <= w) & ((run == 1) | (nxt & (np.append(run[1:], 0) >= run - 1)))
    if not holds.all():
        raise ValueError(f"{what}: column runs wrong at columns {np.flatnonzero(~holds)[:8].tolist()}")


@functools.lru_cache(maxsize=8)
def _descriptors(positions: Tuple[Tuple[int, int], ...], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(``stitch_descriptors`` of a geometry on ``device``, an (H, W) int32
    view of one element there), checked against the replayed plan before
    first use (a mismatch raises; nothing falls back to the source map).
    ``empty_like`` of the view allocates a canvas for less host time than
    ``empty`` with a dtype and a device (B1 is host-bound)."""
    src = _source_map(positions, torch.device("cpu")).numpy()
    h, w = src.shape
    desc = stitch_descriptors(src)
    check_descriptors(desc, src, f"the {h}x{w} stitch plan of {len(positions)} patches")
    return torch.from_numpy(desc).to(device), torch.empty(1, dtype=torch.int32, device=device).expand(h, w)


def stitch_labels(label_patches: torch.Tensor, positions: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """B1: (N, SCW, SCW) uint8 patch labels -> (H, W) int32 canvas."""
    if label_patches.device.type == "cpu":
        return stitch_plain(label_patches, positions)
    _check(label_patches, "stitch_labels", torch.uint8, 3)
    pos = tuple(map(tuple, positions))
    if tuple(label_patches.shape) != (len(pos), SCW, SCW):
        raise ValueError(
            f"stitch_labels: {len(pos)} positions need ({len(pos)}, {SCW}, {SCW}) "
            f"patches, got {tuple(label_patches.shape)}"
        )
    desc, canvas = _descriptors(pos, label_patches.device)
    out = torch.empty_like(canvas)
    _launch("ecseg_stitch", label_patches.device, label_patches.data_ptr(), desc.data_ptr(), out.data_ptr(), *out.shape)
    count_launch("stitch")
    return out


def label(mask: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """B2: canonical labels of a (H, W) bool mask; int32, -1 on background."""
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    if mask.device.type == "cpu":
        return label_plain(mask, connectivity)
    _check(mask, "label", torch.bool, 2)
    h, w = mask.shape
    out = torch.empty((h, w), dtype=torch.int32, device=mask.device)
    if out.numel() == 0:
        return out
    _launch("ecseg_label", mask.device, mask.data_ptr(), out.data_ptr(), h, w, connectivity)
    count_launch("label")
    return out


def _flood(name, what, trav, seeds, *conn, labels=None):
    """Launch the flood entry ``name`` of csrc/cc_flood.cu and count it under
    ``what``; ``labels`` is the int32 label map it writes (scratch unless the
    caller keeps it, as B9's; B3's, B4's and B6's is a union-find forest,
    not labels).  ``seeds`` None: the border flood, whose entry takes no
    seeds.  The floods read their flags only at roots, whose output is their
    own flag, so the output serves as the flag array."""
    h, w = trav.shape
    out = torch.empty((h, w), dtype=torch.bool, device=trav.device)
    if out.numel() == 0:
        return out
    if labels is None:
        labels = torch.empty((h, w), dtype=torch.int32, device=trav.device)
    seed_ptr = () if seeds is None else (seeds.data_ptr(),)
    _launch(
        name, trav.device, trav.data_ptr(), *seed_ptr,
        labels.data_ptr(), out.data_ptr(), out.data_ptr(), h, w, *conn,
    )
    count_launch(what)
    return out


def flood_from_border(trav: torch.Tensor) -> torch.Tensor:
    """B3: pixels of the (H, W) bool ``trav`` 4-connected to the border."""
    if trav.device.type == "cpu":
        return flood_from_border_plain(trav)
    _check(trav, "flood_from_border", torch.bool, 2)
    return _flood("ecseg_flood_border", "flood_border", trav, None)


def flood_from_seeds(trav: torch.Tensor, seeds: torch.Tensor, connectivity: int = 2) -> torch.Tensor:
    """B4: pixels of ``trav`` connected to any pixel of ``seeds`` (both
    (H, W) bool) through ``trav``."""
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    if trav.device.type == "cpu" and seeds.device.type == "cpu":
        return flood_from_seeds_plain(trav, seeds, connectivity)
    _check_pair(trav, seeds, "flood_from_seeds", torch.bool)
    return _flood("ecseg_flood", "flood_seeds", trav, seeds, connectivity)


def label_multiclass(cls_map: torch.Tensor) -> torch.Tensor:
    """B5: per pixel, the min flat index of its same-class 8-connected
    component in the (H, W) class map (uint8 on the card); int32, -1 on
    class 0."""
    if cls_map.device.type == "cpu":
        return label_multiclass_plain(cls_map)
    _check(cls_map, "label_multiclass", torch.uint8, 2)
    h, w = cls_map.shape
    out = torch.empty((h, w), dtype=torch.int32, device=cls_map.device)
    if out.numel() == 0:
        return out
    _launch("ecseg_label_mc", cls_map.device, cls_map.data_ptr(), out.data_ptr(), h, w)
    count_launch("label_mc")
    return out


def flood_multiclass(cls_map: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """B6: pixels 8-connected to a seed through pixels of their own class
    in the (H, W) class map (uint8 on the card; seeds bool, ignored on class
    0)."""
    if cls_map.device.type == "cpu" and seeds.device.type == "cpu":
        return flood_multiclass_plain(cls_map, seeds)
    _check_pair(cls_map, seeds, "flood_multiclass", torch.uint8)
    return _flood("ecseg_flood_mc", "flood_mc", cls_map, seeds)


def label_and_flood(
    mask: torch.Tensor, seeds: torch.Tensor, connectivity: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B9: (labels as ``label``, flood as ``flood_from_seeds``) of one
    (H, W) bool mask, labeled once."""
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    if mask.device.type == "cpu" and seeds.device.type == "cpu":
        return label_and_flood_plain(mask, seeds, connectivity)
    _check_pair(mask, seeds, "label_and_flood", torch.bool)
    labels = torch.empty(mask.shape, dtype=torch.int32, device=mask.device)
    return labels, _flood("ecseg_label_flood", "label_flood", mask, seeds, connectivity, labels=labels)


def _check_conn(connectivity: int) -> None:
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")


def _count_scratch(t: int, h: int, w: int, what: str) -> int:
    """int32 elements of B8's scratch for ``t`` maps of (h, w): 128 border
    slots per 32x32 tile, then a byte per strip of four tiles (csrc/cc_count.cu);
    raises, naming ``what``, where its int32 indices would overflow."""
    tiles_y, tiles_x = -(-h // 32), -(-w // 32)
    slots = 4 * 32 * tiles_y * tiles_x
    if t * slots >= 2**31 or t > 65535:
        raise ValueError(f"{what}: {t} maps of {h}x{w} overflow the kernel's int32 indices")
    return t * slots + -(-t * tiles_y * -(-tiles_x // 4) // 4)


def count_components(mask: torch.Tensor, connectivity: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8a: (number of components, foreground pixels) of a (H, W) bool mask,
    0-d int32 tensors on the mask's device.  Three launches and no per-pixel
    scratch: the tile-local pieces of 32x32 tiles minus the links across
    their edges."""
    _check_conn(connectivity)
    if mask.device.type == "cpu":
        return count_components_plain(mask, connectivity)
    _check(mask, "count_components", torch.bool, 2)
    h, w = mask.shape
    if mask.numel() == 0:
        zero = torch.zeros((), dtype=torch.int32, device=mask.device)
        return zero, zero.clone()
    out = torch.empty(2, dtype=torch.int32, device=mask.device)  # zeroed by the kernel's memset
    parent = torch.empty(_count_scratch(1, h, w, "count_components"), dtype=torch.int32, device=mask.device)
    _launch("ecseg_count", mask.device, mask.data_ptr(), parent.data_ptr(), h, w, connectivity, out.data_ptr())
    count_launch("count")
    return out[0], out[1]


def count_from_patches(
    label_patches: torch.Tensor, positions: Sequence[Tuple[int, int]], class_id: int = 3, connectivity: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8b: the overlap stitch of (N, SCW, SCW) patch labels at
    ``positions``, its ``== class_id`` mask and that mask's (number of
    components, foreground pixels), in one launch; 0-d int32 tensors, or
    (T,) each for a batch (T, N, SCW, SCW) of tiles.  The canvas is never
    materialised, nor any per-pixel array."""
    _check_conn(connectivity)
    if label_patches.device.type == "cpu":
        return count_from_patches_plain(label_patches, positions, class_id, connectivity)
    _check(label_patches, "count_from_patches", label_patches.dtype, label_patches.dim())
    if label_patches.dim() not in (3, 4):
        raise ValueError(f"count_from_patches: expected (N, S, S) or (T, N, S, S) patches, got {tuple(label_patches.shape)}")
    if label_patches.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"count_from_patches: expected uint8 or int32 labels, got {label_patches.dtype}")
    pos = tuple(map(tuple, positions))
    lp = label_patches if label_patches.dim() == 4 else label_patches[None]
    t = lp.shape[0]
    if tuple(lp.shape[1:]) != (len(pos), SCW, SCW):
        raise ValueError(
            f"count_from_patches: {len(pos)} positions need ({len(pos)}, {SCW}, {SCW}) "
            f"patches per tile, got {tuple(label_patches.shape)}"
        )
    desc, canvas = _descriptors(pos, label_patches.device)
    h, w = canvas.shape
    scratch = _count_scratch(t, h, w, "count_from_patches")
    out = torch.empty((t, 2), dtype=torch.int32, device=label_patches.device)
    if t:
        parent = torch.empty(scratch, dtype=torch.int32, device=label_patches.device)
        _launch(
            "ecseg_count_patches", label_patches.device, lp.data_ptr(), int(lp.dtype == torch.int32),
            desc.data_ptr(), t, len(pos) * SCW * SCW, h, w, int(class_id), connectivity,
            parent.data_ptr(), out.data_ptr(),
        )
        count_launch("count_patches")
    if label_patches.dim() == 3:
        return out[0, 0], out[0, 1]
    return out[:, 0], out[:, 1]
