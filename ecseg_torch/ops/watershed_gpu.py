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
gates what leaves it).  The ungated fast path
(:func:`nuset_marker_watershed_fast`, ``ECSEG_FAST_WATERSHED=on|check``)
returns its contour as it is, and the padding moves the EDT of blobs cut by
the bottom or right edge, so it runs the JAX package's padded geometry and
crops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .edt_gpu import edt_sq
from .morphology import disk
from .morphology_gpu import _offsets, _shift, binary_fill_holes
from .watershed import nuset_place_markers

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


def lex_flood(image: torch.Tensor, markers: torch.Tensor, mask: torch.Tensor):
    """(cost, pcost, lab, converged) of ``_lex_flood``: relax until an
    iteration changes nothing or ``MAX_ITERS`` iterations ran.  Convergence
    is read every ``CHECK_EVERY`` iterations (one sync each); a fixpoint
    stays one, so the iterations run past it change nothing.  ``image``
    int32, ``markers`` int32."""
    cost0 = torch.where(markers > 0, image, _BIG)
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


def nuset_fast_pass(pred_mask: torch.Tensor, markers: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(contour AND mask, certificate) for a (H, W) bool mask and int32
    point markers (``_nuset_fast_pass``).  The line rule and the
    certificate are the JAX package's: a pixel next to a different-label
    marker pixel is a line pixel; otherwise the later-popped side of a
    boundary is (lower cost first, a marker before a non-marker at equal
    cost, then the lower label); an equal-cost pair of non-markers with
    different labels, or a second argmin predecessor of another label, is
    uncertain."""
    mask = pred_mask.bool()
    img, m = flood_inputs(mask, markers)
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
    n_unc = int(unc.sum()) + (0 if converged else UNCONVERGED)
    return (lab > 0) & ~line & mask, n_unc


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
    contour, _ = nuset_fast_pass(mask_p, mark_p)
    return contour[:h, :w].cpu().numpy()


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
    contour, n_unc = nuset_fast_pass(
        torch.from_numpy(pred_mask != 0).to(device), torch.from_numpy(markers.astype(np.int32)).to(device)
    )
    if n_unc:
        return None, n_unc
    return (pred_mask * contour.cpu().numpy()).astype(np.int32), 0
