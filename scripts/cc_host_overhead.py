"""Host time of the connected-component wrappers (``ops/cc_kernels.py``) and
of their parts, on one CUDA card.

    python3 scripts/cc_host_overhead.py [ROOT]

ROOT is the checkout whose ``ecseg_torch`` is imported (default: this
one), so two checkouts can be compared in turns on one card.  Each part is
called 2000 times back to back and timed on the host clock before the final
synchronize, which is the enqueue cost a caller pays (on a 32x32 mask the
card keeps up, so the host is the bound).  At 2048^2, on a map shaped like
the main path's (nucleus discs of class 1, ecDNA dots of class 3, sparse
class 2), B4 (``flood_from_seeds(raw != 0, raw == 3)``), B5
(``label_multiclass(raw)``), B6 (``flood_multiclass(raw, raw == 3)``) and
B9 (``label_and_flood(raw != 0, raw == 1)``), the main path's calls, and
B8a (``count_components(raw == 3)``) are also timed by CUDA events over 20
calls (what ``chip_smoke.py`` reports) and on the host clock over 200;
so are the two ways meta_overlay can take a (components, pixels) pair of a
mask it also labels (``ec``): B8a, or the root sums of the labeling it
holds (``pair_b8a``, ``pair_roots``; ``pair_roots`` leaves the labeling
out).  Prints one JSON object of microseconds per call.
"""

import json
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ecseg_torch.ops import cc_kernels as K  # noqa: E402


def host_us(fn, n=2000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def event_us(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return 1e3 * a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("cc_host_overhead: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    m = torch.zeros((32, 32), dtype=torch.bool, device=dev)
    m[3:9, 4:20] = True
    s = torch.zeros_like(m)
    s[5, 5] = True
    lab = torch.empty((32, 32), dtype=torch.int32, device=dev)
    flag = torch.empty(1024, dtype=torch.uint8, device=dev)
    o = torch.empty_like(m)
    flood, label = K._cfunc("ecseg_flood"), K._cfunc("ecseg_label")
    stream = torch.cuda.current_stream().cuda_stream

    def in_device():
        with torch.cuda.device(dev):
            pass

    out = {
        "torch_empty_2048sq_int32": host_us(lambda: torch.empty((2048, 2048), dtype=torch.int32, device=dev)),
        "with_torch_cuda_device": host_us(in_device),
        "current_stream_cuda_stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_current_stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(0)),
        "current_device": host_us(torch.cuda.current_device),
        "check_pair": host_us(lambda: K._check_pair(m, s, "x", torch.bool)),
        "ctypes_ecseg_flood_32sq": host_us(lambda: flood(m.data_ptr(), s.data_ptr(), lab.data_ptr(), flag.data_ptr(), o.data_ptr(), 32, 32, 2, stream)),
        "ctypes_ecseg_label_32sq": host_us(lambda: label(m.data_ptr(), lab.data_ptr(), 32, 32, 2, stream)),
        "wrapper_flood_from_seeds_32sq": host_us(lambda: K.flood_from_seeds(m, s, 2)),
        "wrapper_label_multiclass_32sq": host_us(lambda: K.label_multiclass(m.to(torch.uint8))),
        "wrapper_label_32sq": host_us(lambda: K.label(m, 2)),
        "wrapper_flood_from_border_32sq": host_us(lambda: K.flood_from_border(m)),
        "wrapper_flood_multiclass_32sq": host_us(lambda: K.flood_multiclass(m.to(torch.uint8), s)),
        "wrapper_label_and_flood_32sq": host_us(lambda: K.label_and_flood(m, s, 2)),
        "wrapper_count_components_32sq": host_us(lambda: K.count_components(m, 2)),
    }
    rng = np.random.default_rng(0)
    img = np.zeros((2048, 2048), np.uint8)
    yy, xx = np.ogrid[:2048, :2048]
    for _ in range(9):
        cy, cx = rng.integers(150, 1900, 2)
        r = int(rng.integers(50, 120))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    for _ in range(400):
        y, x = rng.integers(2, 2040, 2)
        img[y : y + 3, x : x + 3] = 3
    img[rng.random((2048, 2048)) < 0.01] = 2
    raw = torch.from_numpy(img).to(dev)
    fg, seeds, nuc = raw != 0, raw == 3, raw == 1
    hw = seeds.numel()
    lab = K.label(seeds, 2).reshape(-1)
    flat = torch.where(lab < 0, hw, lab).long()
    idx = torch.arange(hw, device=dev)
    calls = {
        "B4": lambda: K.flood_from_seeds(fg, seeds, 2),
        "B5": lambda: K.label_multiclass(raw),
        "B6": lambda: K.flood_multiclass(raw, seeds),
        "B9": lambda: K.label_and_flood(fg, nuc, 2),
        "B8a": lambda: K.count_components(seeds, 2),
        "pair_b8a": lambda: torch.stack(K.count_components(seeds, 2)),
        "pair_roots": lambda: torch.stack([(flat == idx).sum().int(), seeds.sum().int()]),
    }
    for k in range(3):
        for b, fn in calls.items():
            out[f"{b}_2048sq_event_{k}"] = event_us(fn)
            out[f"{b}_2048sq_host_{k}"] = host_us(fn, 200)
    print(json.dumps({"root": ROOT, "card": torch.cuda.get_device_name(0), **{k: round(v, 2) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
