"""Half-width against full-width (XL) metaseg U-Net, trained and scored on
the card (twin of ``scripts/compare_archs.py``).

    python -m ecseg_torch.compare_archs [--steps 400] [--batch 16] [--lr 3e-4]
        [--seed 0] [--n-train 10] [--n-eval 4] [--sweep 400,2000,6000]

Both architectures train under one budget on the same seeded synthetic
4-class DAPI fields (:func:`synth_pair`: 1 nucleus, 2 chromosome, 3 ecDNA,
the class told by shape and intensity) and are scored on held-out 1024^2
fields through the product tiling path (:func:`evaluate`).  ``--sweep``
trains both from scratch at each budget on the same fields and prints the
IoU-against-budget table.  Output, as the script's: one JSON line an
architecture and budget on stdout (``arch, steps, batch, train_s, iou_bg,
iou_nucleus, iou_chromosome, iou_ec, mean_iou, pixel_acc``); on stderr the
``[arch] step N loss`` lines (every 50 steps and the last), the gap line of
each budget and, with ``--sweep``, the markdown table.

- The fields are the script's, drawn from numpy in its order.  Its
  ``cv2.GaussianBlur(img, (5, 5), 1.2)`` is :func:`gaussian_blur5`, which
  gives cv2's float32 bits (the card's machine has no cv2).  Its promotions
  are NumPy 2's, spelled out here so that an older NumPy draws the same
  fields.
- Training (:func:`train_model`) is ``runtime/train.train_step_on_mesh``
  over ``parallel/mesh.make_mesh`` of every card (one card: one entry), as
  the script trains over ``make_mesh()`` of every device: Adam at ``lr``,
  float32 under the parity flags (TF32 off), batches from
  ``runtime/data.crop_batches`` padded to the mesh with a ``valid`` mask.
  ``train_s`` is the host clock over the steps, ended by a device sync.
- The initial weights are the port's seeded draws (``MetasegUNet`` with a
  torch generator seeded ``--seed``), not ``PRNGKey(seed)``'s (ROADMAP
  deviation 2); :func:`train_model` takes any initial model.
- :func:`evaluate`: ``tiling.im2patches_overlap``, the float32 forward,
  ``tiling.patch_labels`` (exact uint8 quantize, then argmax), the stitch by
  ``cc_kernels.stitch_labels`` (kernel B1 on the card, its twin on the
  CPU), then the per-class intersections and unions and the pixel accuracy
  on the host, counted as the script counts them.

Without a card ``python -m`` exits 1; ``main(device="cpu")`` runs on the
CPU (the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import DeviceLike
from .models.metaseg_unet import BOTTLENECK, BOTTLENECK_XL, ENC_WIDTHS, ENC_WIDTHS_XL, MetasegUNet
from .ops import cc_kernels, tiling
from .parallel.mesh import Mesh, make_mesh
from .runtime.data import crop_batches, pad_to_multiple
from .runtime.hostmem import tune_host_allocator
from .runtime.study import no_card
from .runtime.train import train_step_on_mesh

ARCHS = {"default": (ENC_WIDTHS, BOTTLENECK), "xl": (ENC_WIDTHS_XL, BOTTLENECK_XL)}
# cv2.getGaussianKernel(5, 1.2, CV_32F): the outer taps, the next ones, the centre
GAUSS5 = np.array([0.0856291651725769, 0.24266760051250458, 0.34340646862983704], np.float32)
LOG_EVERY = 50

Pair = Tuple[np.ndarray, np.ndarray]


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64; the float64 sum's
    error (Knuth's two-sum) decides the one case where rounding it again to
    float32 could go the wrong way, a sum that lands on a float32 midpoint."""
    p = np.asarray(a, np.float64) * np.float64(b)
    c = np.asarray(c, np.float64)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    r = s.astype(np.float32)
    d = s - r
    nxt = np.nextafter(r, np.where(d > 0, np.float32(np.inf), np.float32(-np.inf)))
    tie = (d != 0) & (err != 0) & ((r.astype(np.float64) + nxt) * 0.5 == s)
    return np.where(tie, np.where(err > 0, np.maximum(r, nxt), np.minimum(r, nxt)), r)


def _taps(p: np.ndarray, n: int, axis: int) -> List[np.ndarray]:
    return [p[:, i:i + n] if axis else p[i:i + n] for i in range(5)]


def gaussian_blur5(img: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(img, (5, 5), 1.2)`` of a float32 (H, W) image, H
    and W >= 3, bit for bit: cv2's separable filter with its float32
    kernel and default border (reflect-101, numpy's ``"reflect"``), rows
    first, each output the sum of the symmetric pairs in cv2's order and
    rounding.  The row pass fuses ``(x[-1] + x[1]) * k1``, then the centre,
    then the outer pair, except at the last column of an odd width (its
    scalar tail: plain products and sums); the column pass fuses the
    centre's product, the inner pair, the outer pair, except past the last
    multiple of 8 columns (its vector width; plain there)."""
    k2, k1, k0 = GAUSS5
    h, w = img.shape
    t = _taps(np.pad(img, ((0, 0), (2, 2)), mode="reflect"), w, 1)
    rows = _fma32(t[0] + t[4], k2, _fma32(t[2], k0, (t[1] + t[3]) * k1))
    if w % 2:
        rows[:, -1] = (t[2][:, -1] * k0 + (t[1] + t[3])[:, -1] * k1) + (t[0] + t[4])[:, -1] * k2
    t = _taps(np.pad(rows, ((2, 2), (0, 0)), mode="reflect"), h, 0)
    out = _fma32(t[0] + t[4], k2, _fma32(t[1] + t[3], k1, t[2] * k0))
    v = w - w % 8
    out[:, v:] = (t[2][:, v:] * k0 + (t[1] + t[3])[:, v:] * k1) + (t[0] + t[4])[:, v:] * k2
    return out


def _window(cy: int, cx: int, reach: int, hw: int):
    """Rows and columns (float64, as NumPy 2 promotes the script's float32
    grid against an int64 centre) of the box within ``reach`` of a centre,
    less their centre, and the box's slices."""
    ys = slice(max(cy - reach, 0), min(cy + reach + 1, hw))
    xs = slice(max(cx - reach, 0), min(cx + reach + 1, hw))
    dy = np.arange(ys.start, ys.stop, dtype=np.float64)[:, None] - float(cy)
    dx = np.arange(xs.start, xs.stop, dtype=np.float64)[None, :] - float(cx)
    return dy, dx, (ys, xs)


def synth_pair(rng: np.random.Generator, hw: int = 1024) -> Pair:
    """Synthetic DAPI field (uint8) and its 4-class ground truth (int32),
    ``scripts/compare_archs.py``'s ``synth_pair`` draw for draw.  Each shape
    is evaluated on the box that holds it (a margin of 2 pixels past its
    reach) rather than the whole field: the same elementwise arithmetic
    on fewer pixels, the same pixels set in the same order."""
    img = (rng.random((hw, hw)) * 55).astype(np.float32)
    lab = np.zeros((hw, hw), np.int32)

    def rotated(cy, cx, reach, th):
        dy, dx, box = _window(int(cy), int(cx), reach, hw)
        c, s = np.cos(th), np.sin(th)
        return dy * c + dx * s, -dy * s + dx * c, box

    def paint(box, m, value, cls):
        img[box][m] = value
        lab[box][m] = cls

    for _ in range(6):  # nuclei: large ellipses, mid intensity
        cy, cx = rng.integers(80, hw - 80, 2)
        ry, rx = rng.integers(45, 110, 2)
        th = rng.random() * np.pi
        u, v, box = rotated(cy, cx, int(max(ry, rx)) + 2, th)
        m = (u / float(ry)) ** 2 + (v / float(rx)) ** 2 <= 1.0
        paint(box, m, float(rng.integers(85, 160)) + rng.random(int(m.sum())) * 25, 1)

    for _ in range(40):  # chromosomes: thin rotated bars, higher intensity
        cy, cx = rng.integers(30, hw - 30, 2)
        L, W = int(rng.integers(18, 48)), int(rng.integers(3, 8))
        th = rng.random() * np.pi
        u, v, box = rotated(cy, cx, (L + W) // 2 + 2, th)
        m = (np.abs(u) <= L / 2) & (np.abs(v) <= W / 2)
        paint(box, m, float(rng.integers(120, 200)) + rng.random(int(m.sum())) * 20, 2)

    for _ in range(140):  # ecDNA: small bright dots
        cy, cx = rng.integers(10, hw - 10, 2)
        r = int(rng.integers(2, 6))
        dy, dx, box = _window(int(cy), int(cx), r + 2, hw)
        m = dy ** 2 + dx ** 2 <= r * r
        paint(box, m, rng.integers(150, 250), 3)

    img = gaussian_blur5(img)
    img = np.clip(img.astype(np.float64) + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    return img, lab


def predict(model: MetasegUNet, img: np.ndarray, stitch: Callable = cc_kernels.stitch_labels) -> np.ndarray:
    """The (H, W) int32 label canvas of one uint8 field on the model's
    device: overlap patches, the float32 forward, exact quantize and argmax,
    ``stitch`` (B1's wrapper; tests and checks pass its twin)."""
    _, patches, positions = tiling.im2patches_overlap(img[..., None])
    dev = next(model.parameters()).device
    with torch.no_grad():
        labels = tiling.patch_labels(model(torch.from_numpy(patches).to(dev), dtype=torch.float32))
        return stitch(labels, positions).cpu().numpy()


def evaluate(model: MetasegUNet, eval_pairs: Sequence[Pair]):
    """Held-out full-field scores through the product tiling path: the
    per-class IoU (4,) and the pixel accuracy, as the script counts them."""
    inter = np.zeros(4, np.int64)
    union = np.zeros(4, np.int64)
    correct = total = 0
    for img, lab in eval_pairs:
        pred = predict(model, img)
        h, w = pred.shape
        gt = lab[:h, :w]
        for c in range(4):
            pi, gi = pred == c, gt == c
            inter[c] += np.count_nonzero(pi & gi)
            union[c] += np.count_nonzero(pi | gi)
        correct += np.count_nonzero(pred == gt)
        total += pred.size
    iou = inter / np.maximum(union, 1)
    return iou, float(correct) / total


def _sync(mesh: Mesh) -> None:
    for dev in dict.fromkeys(mesh.flat()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def train_model(model: MetasegUNet, arch: str, train_pairs: Sequence[Pair], eval_pairs: Sequence[Pair], steps: int,
                batch: int, lr: float, seed: int, mesh: Mesh) -> dict:
    """Train ``model`` (a copy of it, laid out on ``mesh``) for ``steps``
    Adam steps on crops of ``train_pairs``, then score it on
    ``eval_pairs``: the script's result dict."""
    n_dev = len(mesh.flat())
    step_fn = train_step_on_mesh(mesh, model, lr, dtype=torch.float32)
    t0 = time.perf_counter()
    for step, (x, y) in enumerate(crop_batches(list(train_pairs), batch, steps, seed=seed)):
        x, n = pad_to_multiple(x, n_dev)
        y, _ = pad_to_multiple(y, n_dev)
        valid = np.arange(len(x)) < n
        loss = step_fn(x, y, valid)
        if step % LOG_EVERY == 0 or step == steps - 1:
            print(f"[{arch}] step {step:4d} loss {float(loss):.4f}", file=sys.stderr, flush=True)
    _sync(mesh)
    train_s = time.perf_counter() - t0

    trained, _ = step_fn.gather()
    del step_fn
    iou, acc = evaluate(trained, eval_pairs)
    return {
        "arch": arch,
        "steps": steps,
        "batch": batch,
        "train_s": round(train_s, 1),
        "iou_bg": round(float(iou[0]), 4),
        "iou_nucleus": round(float(iou[1]), 4),
        "iou_chromosome": round(float(iou[2]), 4),
        "iou_ec": round(float(iou[3]), 4),
        "mean_iou": round(float(iou.mean()), 4),
        "pixel_acc": round(acc, 4),
    }


def train_arch(arch: str, train_pairs: Sequence[Pair], eval_pairs: Sequence[Pair], steps: int, batch: int, lr: float,
               seed: int, mesh: Mesh) -> dict:
    """:func:`train_model` from ``arch``'s ``MetasegUNet`` drawn from a
    torch generator seeded ``seed``."""
    widths, bottleneck = ARCHS[arch]
    model = MetasegUNet(widths, bottleneck, generator=torch.Generator().manual_seed(seed))
    return train_model(model, arch, train_pairs, eval_pairs, steps, batch, lr, seed, mesh)


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ecseg_torch.compare_archs")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=10)
    ap.add_argument("--n-eval", type=int, default=4)
    ap.add_argument("--sweep", help="comma-separated step budgets; trains both archs at each and "
                    "prints the IoU-vs-budget markdown table")
    args = ap.parse_args(sys.argv[1:] if argv is None else list(argv))
    tune_host_allocator()
    if device is None and no_card("compare_archs"):
        return 1
    mesh = make_mesh(None if device is None else [device])

    rng = np.random.default_rng(args.seed)
    print("generating synthetic DAPI fields...", file=sys.stderr, flush=True)
    train_pairs = [synth_pair(rng) for _ in range(args.n_train)]
    eval_pairs = [synth_pair(rng) for _ in range(args.n_eval)]

    budgets = (list(dict.fromkeys(int(s.strip()) for s in args.sweep.split(",") if s.strip()))
               if args.sweep else [args.steps])
    by_budget = {}
    for steps in budgets:
        results = []
        for arch in ARCHS:
            r = train_arch(arch, train_pairs, eval_pairs, steps, args.batch, args.lr, args.seed, mesh)
            results.append(r)
            print(json.dumps(r), flush=True)
        by_budget[steps] = results
        d, x = results
        print(
            f"\n[{steps} steps] mean IoU: half-width {d['mean_iou']:.4f} vs "
            f"xl {x['mean_iou']:.4f} (gap {x['mean_iou'] - d['mean_iou']:+.4f}); "
            f"ec IoU {d['iou_ec']:.4f} vs {x['iou_ec']:.4f}",
            file=sys.stderr, flush=True,
        )

    if args.sweep:
        print("\n| steps | half mIoU | xl mIoU | half ec IoU | xl ec IoU | half train s | xl train s |", file=sys.stderr)
        print("|---|---|---|---|---|---|---|", file=sys.stderr)
        for steps, (d, x) in sorted(by_budget.items()):
            print(f"| {steps} | {d['mean_iou']:.3f} | {x['mean_iou']:.3f} | {d['iou_ec']:.3f} | {x['iou_ec']:.3f} | "
                  f"{d['train_s']:.0f} | {x['train_s']:.0f} |", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
