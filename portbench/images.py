"""The one input generator: a folder of seeded uint16 images drawn from a
traffic mix's parameters (``traffic/<mix>.json``), and the TIFF writer
that puts them on disk.

An image is noise on each channel with objects blended over it, in the
mix's order: ``disc`` (every ``twin_every``-th with a touching twin
``twin_distance`` radii to its right), ``rod`` (segments scattered in a
disc of ``cluster_radius``: a metaphase spread), both with edges soft over
``edge_px``, and ``square`` (hard-edged; ``per_disc`` of them near each
disc drawn so far, plus ``count`` anywhere).  A ``[lo, hi]`` count is spread evenly over the
folder's images and the seed permutes which image gets which, so every
seed makes the same amount of work in another arrangement.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

CHANNELS = {"gray": ("gray",), "rgb": ("red", "green", "blue")}


def _spread(lo: int, hi: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """n counts spread evenly over [lo, hi], in the seed's order."""
    values = np.rint(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(np.int64)
    return rng.permutation(values)


def _blend(canvas: np.ndarray, y0: int, x0: int, alpha: np.ndarray, level: float) -> None:
    h, w = canvas.shape
    y1, x1 = min(h, y0 + alpha.shape[0]), min(w, x0 + alpha.shape[1])
    ya, xa = max(0, y0), max(0, x0)
    a = alpha[ya - y0 : y1 - y0, xa - x0 : x1 - x0]
    box = canvas[ya:y1, xa:x1]
    box += a * (level - box)


def _disc(canvas, cy, cx, r, level, edge):
    m = int(np.ceil(r + edge)) + 1
    yy, xx = np.mgrid[-m : m + 1, -m : m + 1]
    d = np.hypot(yy + (int(cy) - cy), xx + (int(cx) - cx))
    _blend(canvas, int(cy) - m, int(cx) - m, np.clip((r - d) / edge + 0.5, 0, 1), level)


def _rod(canvas, cy, cx, length, width, theta, level, edge):
    dy, dx = np.sin(theta) * length / 2, np.cos(theta) * length / 2
    m = int(np.ceil(length / 2 + width + edge)) + 1
    yy, xx = np.mgrid[-m : m + 1, -m : m + 1].astype(np.float64)
    # distance to the segment from (-dy, -dx) to (dy, dx)
    t = np.clip((yy * dy + xx * dx) / max(dy * dy + dx * dx, 1e-9), -1, 1)
    d = np.hypot(yy - t * dy, xx - t * dx)
    _blend(canvas, int(cy) - m, int(cx) - m, np.clip((width / 2 - d) / edge + 0.5, 0, 1), level)


def _level(spec: Dict, rng) -> float:
    lo, hi = spec["level"]
    return float(rng.integers(lo, hi + 1))


def draw(mix: Dict, seed: int, index: int, counts: List[int]) -> np.ndarray:
    """Image ``index`` of the folder: uint16 (H, W) gray or (H, W, 3) RGB."""
    rng = np.random.default_rng([seed, index])
    h, w = mix["height"], mix["width"]
    names = CHANNELS[mix["layout"]]
    canvas = {c: rng.random((h, w)) * mix["noise"][c] for c in names}
    discs: List[Tuple[float, float, float]] = []
    for k, obj in enumerate(mix["objects"]):
        n = counts[k]
        plane = canvas[obj["channel"]]
        edge = float(obj.get("edge_px", 1.0))
        if obj["kind"] == "disc":
            margin = obj["margin"]
            for j in range(n):
                r = float(rng.uniform(*obj["radius"]))
                twin = obj.get("twin_every") and j % obj["twin_every"] == 0
                cy = rng.uniform(margin + r, h - margin - r)
                cx = rng.uniform(margin + r, w - margin - r - (obj["twin_distance"] * r if twin else 0))
                for x in (cx, cx + obj["twin_distance"] * r) if twin else (cx,):
                    _disc(plane, cy, x, r, _level(obj, rng), edge)
                    discs.append((cy, x, r))
        elif obj["kind"] == "rod":
            big = float(rng.uniform(*obj["cluster_radius"]))
            oy, ox = rng.uniform(big, h - big), rng.uniform(big, w - big)
            for _ in range(n):
                rho, phi = big * np.sqrt(rng.random()), rng.uniform(0, 2 * np.pi)
                _rod(plane, oy + rho * np.sin(phi), ox + rho * np.cos(phi), rng.uniform(*obj["length"]),
                     rng.uniform(*obj["width"]), rng.uniform(0, np.pi), _level(obj, rng), edge)
        elif obj["kind"] == "square":
            lo, hi = obj.get("per_disc", [0, 0])
            spots = [(cy + rng.uniform(-r / 2, r / 2), cx + rng.uniform(-r / 2, r / 2))
                     for cy, cx, r in discs for _ in range(int(rng.integers(lo, hi + 1)))]
            spots += [(rng.uniform(0, h), rng.uniform(0, w)) for _ in range(n)]
            for cy, cx in spots:
                s = int(rng.integers(obj["size"][0], obj["size"][1] + 1))
                y, x = min(max(int(cy), 0), h - s), min(max(int(cx), 0), w - s)
                plane[y : y + s, x : x + s] = _level(obj, rng)
        else:
            raise ValueError(f"portbench: unknown object kind {obj['kind']!r}")
    img = np.stack([canvas[c] for c in names], axis=-1) if len(names) > 1 else canvas[names[0]]
    return np.clip(np.rint(img), 0, 65535).astype(np.uint16)


def folder(mix: Dict, seed: int) -> List[np.ndarray]:
    """The mix's ``images`` images for ``seed``."""
    n = mix["images"]
    rng = np.random.default_rng([seed, 1 << 20])
    counts = np.stack([_spread(*obj.get("count", [0, 0]), n, rng) for obj in mix["objects"]], axis=1)
    return [draw(mix, seed, i, [int(c) for c in counts[i]]) for i in range(n)]


def write_tiff(path: str, img: np.ndarray) -> None:
    """Baseline little-endian uncompressed TIFF, one strip: uint16 gray
    (H, W) or RGB (H, W, 3)."""
    img = np.ascontiguousarray(img, dtype="<u2")
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    data = img.tobytes()
    n_tags = 10
    bps_off = 8 + 2 + 12 * n_tags + 4
    data_off = bps_off + (2 * spp if spp > 1 else 0)
    entries = [
        (256, 4, 1, w), (257, 4, 1, h), (258, 3, spp, 16 if spp == 1 else bps_off), (259, 3, 1, 1),
        (262, 3, 1, 1 if spp == 1 else 2), (273, 4, 1, data_off), (277, 3, 1, spp), (278, 4, 1, h),
        (279, 4, 1, len(data)), (284, 3, 1, 1),
    ]
    out = [b"II", struct.pack("<HI", 42, 8), struct.pack("<H", n_tags)]
    for tag, typ, count, value in entries:
        val = struct.pack("<HH", value, 0) if (typ == 3 and count == 1) else struct.pack("<I", value)
        out.append(struct.pack("<HHI", tag, typ, count) + val)
    out.append(struct.pack("<I", 0))
    if spp > 1:
        out.append(struct.pack("<" + "H" * spp, *([16] * spp)))
    out.append(data)
    with open(path, "wb") as f:
        f.write(b"".join(out))
        f.flush()
        os.fsync(f.fileno())  # on disk before the window, not written back during it


def write_folder(images: List[np.ndarray], directory: str) -> List[str]:
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, img in enumerate(images):
        path = os.path.join(directory, f"img_{i:03d}.tif")
        write_tiff(path, img)
        paths.append(path)
    return paths
