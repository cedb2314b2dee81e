"""The certified NuSeT watershed on device tensors (twin of
``ecseg_tpu/ops/watershed_tpu.py:42-118,176-370``), plain torch ops
around kernel B3.

:func:`nuset_fast_pass` is the device body of the reference's watershed
post-pass (src/model_layers/marker_watershed.py:82-91): grayscale-dilate the
point markers by disk(3), fill the mask's holes (B3), flood ``-EDT^2`` (exact
int32) within the mask by the lexicographic relaxation :func:`lex_flood`,
zero the boundary ("watershed line") pixels, AND with the mask.  Beside the
contour it counts the pixels whose host outcome rests on the priority
queue's insertion age rather than on the (cost, pcost) order, plus 2^20 if
the flood hit its 4096-iteration cap: the per-image certificate.  When it is
0 the contour equals the host priority flood's (``ops/watershed.py``) bit
for bit; :func:`nuset_marker_watershed_auto` returns it then and ``None``
otherwise, and the caller recomputes on the host.

The JAX package pads the pass to multiples of 128 so that a folder of mixed
sizes compiles few programs; nothing here compiles, so the certified pass
runs at the mask's own size, the host chain's geometry (the certificate
gates what leaves it); :func:`nuset_marker_watershed_certified` is that
path with the host recompute started from the pass's own inputs.  On the
card the flood's relaxations replay as CUDA graphs.  The ungated fast path
(:func:`nuset_marker_watershed_fast`, ``ECSEG_FAST_WATERSHED=on|check``)
returns its contour as it is, and the padding moves the EDT of blobs cut by
the bottom or right edge, so it runs the JAX package's padded geometry and
crops.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .edt_gpu import edt_sq
from .morphology import disk
from .morphology_gpu import _offsets, _shift, binary_fill_holes
from .packing import fetch, pack_mask_1bit, unpack_mask_1bit
from .watershed import nuset_place_markers, watershed

MAX_ITERS = 4096
# flood iterations between convergence tests; it divides MAX_ITERS, so a
# flood that does not converge stops at the cap where the JAX loop does
CHECK_EVERY = 16
UNCONVERGED = 1 << 20  # certificate penalty of a flood cut at MAX_ITERS
_OFFS4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
_BIG = torch.iinfo(torch.int32).max  # the unreached cost


def _lex_step(cost, pcost, lab, image, mask, markers, cost0):
    """One relaxation of (cost, pcost, lab) over the 4 neighbours
    (``_lex_flood``'s body): a pixel takes a labelled neighbour q when
    max(cost(q), image) is lower, or equal with a lower cost(q)."""
    nc, npc, nl = cost, pcost, lab
    for dy, dx in _OFFS4:
        qcost = _shift(cost, dy, dx, _BIG)
        qlab = _shift(lab, dy, dx, 0)
        cand = torch.maximum(qcost, image)
        take = ((cand < nc) | ((cand == nc) & (qcost < npc))) & (qlab > 0)
        nc = torch.where(take, cand, nc)
        npc = torch.where(take, qcost, npc)
        nl = torch.where(take, qlab, nl)
    ismark = markers > 0
    nc = torch.where(ismark, cost0, torch.where(mask, nc, _BIG))
    npc = torch.where(ismark, cost0, torch.where(mask, npc, _BIG))
    nl = torch.where(ismark, markers, torch.where(mask, nl, 0))
    return nc, npc, nl


class _LexBlock:
    """``CHECK_EVERY`` relaxations of :func:`lex_flood` on one (shape,
    device), captured once as a CUDA graph over static buffers: a replay
    launches the block's some thousand small kernels at once, where the
    host would enqueue them one by one.  ``changed`` holds whether the
    block's last relaxation changed anything; the state is left in
    ``cost``, ``pcost`` and ``lab``.  The same kernels as the loop, so the
    same integers.  ``lock`` keeps one flood at a time on the buffers."""

    def __init__(self, shape: Tuple[int, int], device: torch.device):
        def buf(dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.image, self.markers, self.cost0 = buf(torch.int32), buf(torch.int32), buf(torch.int32)
        self.mask = buf(torch.bool)
        self.cost, self.pcost, self.lab = buf(torch.int32), buf(torch.int32), buf(torch.int32)
        self.changed = torch.zeros((), dtype=torch.bool, device=device)
        self.lock = threading.Lock()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._block()  # warm-up outside the capture
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the capture binds this thread alone, so another thread's
        # work on the card (the next image's passes) goes on meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self._block()

    def _block(self) -> None:
        cost, pcost, lab = self.cost, self.pcost, self.lab
        for it in range(1, CHECK_EVERY + 1):
            new = _lex_step(cost, pcost, lab, self.image, self.mask, self.markers, self.cost0)
            if it == CHECK_EVERY:
                self.changed.copy_(((new[0] != cost) | (new[1] != pcost) | (new[2] != lab)).any())
            cost, pcost, lab = new
        self.cost.copy_(cost)
        self.pcost.copy_(pcost)
        self.lab.copy_(lab)


_BLOCKS: Dict[Tuple, _LexBlock] = {}
_BLOCKS_LOCK = threading.Lock()
_ALONE: Dict[str, threading.Lock] = {}


def card_alone(device) -> threading.Lock:
    """The lock that :func:`lex_flood` holds on ``device`` while it
    replays: its graphs are some thousand small kernels in a row, bound by
    latency, and take four times as long when long conv blocks hold the
    SMs.  Work that would share the card with it from another thread
    (NuSeT's U-Net passes beside stat_fish's watershed worker) holds the
    lock until its own device work is done."""
    key = str(torch.device(device))
    with _BLOCKS_LOCK:
        return _ALONE.setdefault(key, threading.Lock())


def _lex_block(shape: Tuple[int, int], device: torch.device) -> _LexBlock:
    key = (tuple(shape), str(device))
    with _BLOCKS_LOCK:
        if key not in _BLOCKS:
            with torch.cuda.device(device):
                _BLOCKS[key] = _LexBlock(tuple(shape), device)
        return _BLOCKS[key]


def _lex_flood_graph(image, markers, mask, cost0):
    """:func:`lex_flood` on the card by replays of the shape's
    :class:`_LexBlock`, reading convergence after each (one sync each),
    with the card to itself (:func:`card_alone`)."""
    blk = _lex_block(image.shape, image.device)
    with card_alone(image.device), blk.lock, torch.cuda.device(image.device):
        for dst, src in ((blk.image, image), (blk.markers, markers), (blk.mask, mask), (blk.cost0, cost0),
                         (blk.cost, cost0), (blk.pcost, cost0), (blk.lab, markers)):
            dst.copy_(src)
        converged = False
        for _ in range(MAX_ITERS // CHECK_EVERY):
            blk.graph.replay()
            if not bool(blk.changed):
                converged = True
                break
        return blk.cost.clone(), blk.pcost.clone(), blk.lab.clone(), converged


def lex_flood(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor):
    """(cost, pcost, lab, converged) of ``_lex_flood``: relax until an
    iteration changes nothing or ``MAX_ITERS`` iterations ran.  Convergence
    is read every ``CHECK_EVERY`` iterations (one sync each); a fixpoint
    stays one, so the iterations run past it change nothing.  ``image``
    int32, ``markers`` int32.  On the card each ``CHECK_EVERY`` iterations
    are one CUDA graph's replay (:class:`_LexBlock`)."""
    cost0 = torch.where(markers > 0, image, _BIG)
    if image.is_cuda:
        return _lex_flood_graph(image, markers.to(torch.int32), mask.to(torch.bool), cost0)
    cost, pcost, lab = cost0, cost0, markers
    for it in range(1, MAX_ITERS + 1):
        new = _lex_step(cost, pcost, lab, image, mask, markers, cost0)
        if it % CHECK_EVERY == 0:
            changed = bool(((new[0] != cost) | (new[1] != pcost) | (new[2] != lab)).any())
            cost, pcost, lab = new
            if not changed:
                return cost, pcost, lab, True
        else:
            cost, pcost, lab = new
    return cost, pcost, lab, False


def flood_inputs(mask: torch.Tensor, markers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lex_flood`'s (image, markers) for a bool mask and int32 point
    markers: ``-EDT^2`` of the mask with its holes filled (B3), and the
    markers grey-dilated by disk(3) within the mask."""
    markers = markers.to(torch.int32)
    m = markers
    for dy, dx in _offsets(disk(3).astype(bool)):
        m = torch.maximum(m, _shift(markers, dy, dx, 0))
    return -edt_sq(binary_fill_holes(mask)), torch.where(mask, m, 0)


def nuset_fast_pass(pred_mask: torch.Tensor, markers: torch.Tensor) -> Tuple[np.ndarray, int]:
    """(contour AND mask packed 1 bit a pixel, certificate) for a (H, W)
    bool mask and int32 point markers (``_nuset_fast_pass``), on the host:
    the packed contour and the certificate come back in one copy, as the JAX
    package's ``device_get`` of both (``_run_fast_pass``).  The line rule
    and the certificate are the JAX package's: a pixel next to a
    different-label marker pixel is a line pixel; otherwise the later-popped
    side of a boundary is (lower cost first, a marker before a non-marker at
    equal cost, then the lower label); an equal-cost pair of non-markers
    with different labels, or a second argmin predecessor of another label,
    is uncertain."""
    mask = pred_mask.bool()
    return _fast_pass(mask, *flood_inputs(mask, markers))


def _fast_pass(mask: torch.Tensor, img: torch.Tensor, m: torch.Tensor) -> Tuple[np.ndarray, int]:
    """:func:`nuset_fast_pass` on its flood inputs (:func:`flood_inputs`)."""
    cost, pcost, lab, converged = lex_flood(img, m, mask)
    ismark = m > 0
    line = torch.zeros_like(mask)
    unc = torch.zeros_like(mask)
    for dy, dx in _OFFS4:
        nlab = _shift(lab, dy, dx, 0)
        ncost = _shift(cost, dy, dx, _BIG)
        nmark = _shift(ismark, dy, dx, False)
        both = (nlab > 0) & (lab > 0)
        other = nlab != lab
        nonmark_pair = ~nmark & ~ismark
        earlier = nmark | (ncost < cost) | ((ncost == cost) & nonmark_pair & (nlab < lab))
        line |= both & other & earlier
        own_tie = (ncost == pcost) & other
        line_tie = (ncost == cost) & other & nonmark_pair
        unc |= both & ~ismark & (own_tie | line_tie)
    n_unc = unc.sum(dtype=torch.int64) + (0 if converged else UNCONVERGED)
    packed = pack_mask_1bit((lab > 0) & ~line & mask)
    count = ((n_unc >> torch.arange(0, 32, 8, device=packed.device)) & 0xFF).to(torch.uint8)
    host = fetch(torch.cat([packed.reshape(-1), count]))
    return host[:-4].reshape(packed.shape), int.from_bytes(host[-4:].tobytes(), "little")


def nuset_marker_watershed_certified(
    scores: np.ndarray, proposals: np.ndarray, pred_mask: np.ndarray, min_score: float, device
) -> Tuple[np.ndarray, int]:
    """stat_fish's default watershed: :func:`nuset_marker_watershed_auto`'s
    certified device pass, and where its certificate is not clean the host
    priority flood (``ops/watershed.watershed``) of that pass's own inputs,
    ``-EDT^2`` of the hole-filled mask and the dilated markers, fetched in
    one copy.  The flood compares heights only by order and equality, and
    ``-EDT^2`` orders the pixels as the host chain's ``-EDT`` does, so the
    result is :func:`~.watershed.nuset_marker_watershed`'s without placing
    the markers, filling the holes and taking the EDT on the host again.
    Returns (int32 result, the certificate: 0 when the device pass stood)."""
    pred_mask = np.asarray(pred_mask)
    markers = nuset_place_markers(scores, proposals, pred_mask, min_score)
    if markers is None:
        return pred_mask.astype(np.int32), 0
    mask = torch.from_numpy(pred_mask != 0).to(device)
    img, m = flood_inputs(mask, torch.from_numpy(markers.astype(np.int32)).to(device))
    packed, n_unc = _fast_pass(mask, img, m)
    if not n_unc:
        return (pred_mask * unpack_mask_1bit(packed, pred_mask.shape[1])).astype(np.int32), 0
    height, seeds = fetch(torch.stack([img, m]))
    contour = watershed(height.astype(np.float64), seeds, mask=pred_mask != 0, watershed_line=True)
    return (pred_mask * (contour != 0)).astype(np.int32), n_unc


FAST_PAD = 128  # the JAX package's fast-pass geometry: each side up to a multiple of 128


def _run_fast_pass(pred_mask: np.ndarray, markers: np.ndarray, device) -> np.ndarray:
    """:func:`nuset_fast_pass` on ``device`` at the JAX package's padded
    geometry (``_run_fast_pass``, ``watershed_tpu.py:277-294``), cropped
    back: the bool (H, W) contour."""
    h, w = pred_mask.shape
    hp, wp = (max(FAST_PAD, -(-d // FAST_PAD) * FAST_PAD) for d in (h, w))
    mask_p = torch.zeros((hp, wp), dtype=torch.bool, device=device)
    mask_p[:h, :w] = torch.from_numpy(pred_mask != 0)
    mark_p = torch.zeros((hp, wp), dtype=torch.int32, device=device)
    mark_p[:h, :w] = torch.from_numpy(markers.astype(np.int32))
    packed, _ = nuset_fast_pass(mask_p, mark_p)
    return unpack_mask_1bit(packed, wp)[:h, :w].astype(bool)


def nuset_marker_watershed_fast(
    scores: np.ndarray, proposals: np.ndarray, pred_mask: np.ndarray, min_score: float, device, count_ties: bool = False
):
    """The ungated device watershed (``ECSEG_FAST_WATERSHED=on|check``, the
    JAX package's ``nuset_marker_watershed_fast``): host marker placement,
    then the fast pass at the padded geometry, its contour kept whatever
    the certificate says.  int32 result; with no marker ``pred_mask``
    itself.  ``count_ties``: a second pass with the marker ids permuted
    (id -> max + 1 - id) and ``(result, the contour pixels that differ)``
    returned."""
    pred_mask = np.asarray(pred_mask)
    markers = nuset_place_markers(scores, proposals, pred_mask, min_score)
    if markers is None:  # reference marker_watershed.py:86-89: all-ones contour
        out = pred_mask.astype(np.int32)
        return (out, 0) if count_ties else out
    contour = _run_fast_pass(pred_mask, markers, device)
    result = (pred_mask * contour).astype(np.int32)
    if not count_ties:
        return result
    perm = np.where(markers > 0, int(markers.max()) + 1 - markers, 0)
    return result, int(np.count_nonzero(contour != _run_fast_pass(pred_mask, perm, device)))


def nuset_marker_watershed_auto(
    scores: np.ndarray, proposals: np.ndarray, pred_mask: np.ndarray, min_score: float, device
) -> Tuple[Optional[np.ndarray], int]:
    """The parity-gated device watershed (``ECSEG_FAST_WATERSHED`` unset or
    ``auto`` in the JAX package): host marker placement, then
    :func:`nuset_fast_pass` on ``device``.  Returns (int32 result, 0) when
    the certificate is clean, (None, certificate) otherwise; with no marker
    the reference's all-ones contour, ``pred_mask`` itself."""
    pred_mask = np.asarray(pred_mask)
    markers = nuset_place_markers(scores, proposals, pred_mask, min_score)
    if markers is None:
        return pred_mask.astype(np.int32), 0
    packed, n_unc = nuset_fast_pass(
        torch.from_numpy(pred_mask != 0).to(device), torch.from_numpy(markers.astype(np.int32)).to(device)
    )
    if n_unc:
        return None, n_unc
    return (pred_mask * unpack_mask_1bit(packed, pred_mask.shape[1])).astype(np.int32), 0
