"""Per-layer timing of the metaseg U-Net's convolutions on the card (twin of
``scripts/profile_layers.py``).

    python -m ecseg_torch.profile_layers [--n N] [--dtype bfloat16|float32 ...] [--reps R]

The JAX script's 24 ``LAYERS`` rows (:func:`layer_table`: the default-width
net's convolutions, the first pool, the transpose convs and the head) at N
(default 100) patches, each layer alone on the JAX script's seeded inputs
(``np.random.default_rng(0)``: per layer the input, then two kernels, in its
order, all drawn before the card is used; the first kernel is used; both
dtypes take the same draws), timed with ``runtime/devtime.split`` and
scaled to the bench's 800-patch chunk (each layer over about 0.2 s of calls,
10 to ``--reps``, default 200).  Per row: device ms a chunk, TFLOP/s
and the share of the card's dense peak for the dtype (989 TFLOP/s bf16, 67
TFLOP/s float32 outside the tensor cores: the float32 path runs with TF32
off; NVIDIA's data sheet, H100 SXM at 700 W; the card's power limit is
printed beside it).

Each layer runs through the op, memory format and dtype through which
``MetasegUNet``'s forward runs it (:func:`record_formats`: one forward on
two patches, or on 17 when N is over 16, so that its transpose convs take
the route N's do (:func:`record_patches`), with each convolution's and the
pool's input recorded; the
forward feeds its first conv a permuted, channels-last view of its
one-channel input, so no layout is assumed), with the bias as the forward
adds it, and under ``layers.parity_flags`` as the forward runs (both
dtypes, bf16 first).  ``bf16`` is the tile-count and bench path,
``float32`` metaseg's.  A row's ``op`` names what it times: ``H1`` where
the forward hands the layer to the hand-written 3x3 conv
(``ops/conv3x3.py``: the float32 forward on the card, channels-last, its
ReLU fused and ``dec*_1``'s two halves read apart; at N <= 16 the transpose
convs too, as 3x3 convs of the zero-spread input), else ``library``
(cuDNN's conv or transpose conv, ATen's pool).

FLOPs are what the work needs: a 3x3 conv 2*9*h^2*cin*cout*N, the 1x1 head
2*h^2*cin*cout*N, a stride-2 transpose conv 2*9*h^2*cin*cout*N at its input
resolution h.  The JAX script counts the transpose conv at its output
resolution, 4x this (the work of its lhs-dilated form); a share over 100 %
would mean the count is wrong.  The rows' sum is printed beside one whole
forward's ``split`` at the same N: what the rows leave out (ReLUs, concats,
the other pools, the softmax, the input cast) is the difference.
"""

from __future__ import annotations

import copy
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .device import DeviceLike, resolve_device
from .models import layers
from .models.layers import conv_same, max_pool_same, parity_flags, zero_spread
from .models import metaseg_unet
from .models.metaseg_unet import BOTTLENECK, ENC_WIDTHS, NUM_CLASSES, PATCH, MetasegUNet
from .ops import conv3x3
from .peaks import H100, PEAKS
from .profile_metaseg_2048 import DTYPES
from .runtime.hostmem import tune_host_allocator
from .runtime.study import Study, no_card, opt

N = 100  # patches per measured batch (the bench's chunk is 800: x8)
CHUNK = 800
PEAK = {dtype: PEAKS[H100][dtype] for dtype in ("bfloat16", "float32")}  # dense, per dtype
RECORD_PATCHES = 2
MAX_REPS = 200  # calls a layer's split takes at most (--reps)


def record_patches(n: int) -> int:
    """Patches of the forward that records the layers' formats: few, on
    the side of ``layers.ZERO_SPREAD_MAX_IMAGES`` that ``n`` is on (the
    transpose convs of at most that many take the hand-written conv)."""
    limit = layers.ZERO_SPREAD_MAX_IMAGES
    return min(n, RECORD_PATCHES) if n <= limit else max(RECORD_PATCHES, limit + 1)


def layer_table(widths: Sequence[int] = ENC_WIDTHS, bottleneck: int = BOTTLENECK) -> List[Tuple]:
    """(name, kind, h_in, cin, cout) of the JAX script's ``LAYERS`` for the
    given widths (its table is the default widths')."""
    rows, h, c = [], PATCH, 1
    for i, w in enumerate(widths, start=1):
        rows += [(f"enc{i}_1", "conv", h, c, w), (f"enc{i}_2", "conv", h, w, w)]
        if i == 1:
            rows.append(("pool1", "pool", h, w, w))
        c, h = w, h // 2
    rows += [("bott_1", "conv", h, c, bottleneck), ("bott_2", "conv", h, bottleneck, bottleneck)]
    c = bottleneck
    for i, w in zip(range(len(widths), 0, -1), reversed(widths)):
        rows.append((f"up{i}", "convt", h, c, w))
        h *= 2
        rows += [(f"dec{i}_1", "conv", h, 2 * w, w), (f"dec{i}_2", "conv", h, w, w)]
        c = w
    rows.append(("head", "conv1", h, c, NUM_CLASSES))
    return rows


def flops(kind: str, h: int, cin: int, cout: int, n: int = N) -> int:
    """The operations a layer needs (the transpose conv at its input
    resolution: the JAX script's count / 4)."""
    if kind == "pool":
        return 0
    k2 = 1 if kind == "conv1" else 9
    return 2 * k2 * h * h * cin * cout * n


def layer_inputs(rng, n: int, kind: str, h: int, cin: int, cout: int) -> Tuple[np.ndarray, np.ndarray]:
    """The JAX script's draws for one layer: the (n, h, h, cin) input, then
    two HWIO kernels, float32."""
    x = rng.standard_normal((n, h, h, cin), np.float32)
    kh = 1 if kind == "conv1" else 3
    return x, rng.standard_normal((2, kh, kh, cin, cout), np.float32)


def layout(t: torch.Tensor) -> str:
    """``channels_last``, ``contiguous`` (NCHW), ``both`` (one channel or
    a 1x1 map: the two are the same bytes) or ``strided``."""
    nchw, nhwc = t.is_contiguous(), t.is_contiguous(memory_format=torch.channels_last)
    return {(True, True): "both", (True, False): "contiguous", (False, True): "channels_last"}.get((nchw, nhwc), "strided")


class _Recorder(TorchFunctionMode):
    """Records each conv's, transpose conv's and max pool's input dtype and
    layout, and its output's, under the layer name the model's ``_conv`` /
    ``_dec_first`` / ``_conv_relu`` is running (the pools as ``pool1``,
    ``pool2``, ...); :meth:`h1` records a call of the hand-written conv."""

    FNS = {F.conv2d: "conv", F.conv_transpose2d: "convt", F.max_pool2d: "pool"}

    def __init__(self):
        super().__init__()
        self.current: Optional[str] = None
        self.pools = 0
        self.seen: Dict[str, Dict] = {}
        self.kernel = conv3x3.conv3x3_relu

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = self.FNS.get(func)
        if kind is not None:
            if kind == "pool":
                self.pools += 1
                name = f"pool{self.pools}"
            else:
                name = self.current
            x = args[0]
            y = out[0] if isinstance(out, tuple) else out
            self.seen.setdefault(name, {"dtype": str(x.dtype).replace("torch.", ""), "input": layout(x),
                                        "output": layout(y), "shape": list(x.shape), "op": "library"})
        return out

    def h1(self, x, weight, bias, x2=None, relu=True):
        y = self.kernel(x, weight, bias, x2, relu)
        self.seen.setdefault(self.current, {"dtype": str(x.dtype).replace("torch.", ""), "input": layout(x), "output": layout(y),
                                            "shape": list(x.shape), "op": "H1", "split": 0 if x2 is None else x2.shape[1]})
        return y


def record_formats(model: MetasegUNet, x: torch.Tensor, dtype: torch.dtype) -> Dict[str, Dict]:
    """Layer name -> the op (``library`` or ``H1``; with H1 the channels of
    the second input half, ``split``), dtype and layout of the input the
    forward hands its (first) convolution, and of that call's output, from
    one forward of ``x`` in ``dtype``."""
    rec = _Recorder()
    conv, dec_first, conv_relu, conv_transpose = model._conv, model._dec_first, model._conv_relu, model._conv_transpose

    def named_conv(name, x):
        rec.current = name
        return conv(name, x)

    def named_dec_first(skip, x, name):
        rec.current = name
        return dec_first(skip, x, name)

    def named_conv_relu(name, *args, **kw):
        rec.current = name
        return conv_relu(name, *args, **kw)

    def named_conv_transpose(name, *args, **kw):
        rec.current = name
        return conv_transpose(name, *args, **kw)

    model._conv, model._dec_first, model._conv_relu, model._conv_transpose = named_conv, named_dec_first, named_conv_relu, named_conv_transpose
    conv3x3.conv3x3_relu = rec.h1
    try:
        with torch.no_grad(), rec:
            model(x, dtype)
    finally:
        conv3x3.conv3x3_relu = rec.kernel
        del model._conv, model._dec_first, model._conv_relu, model._conv_transpose
    return rec.seen


def _in_layout(x_nhwc: torch.Tensor, fmt: str) -> torch.Tensor:
    """The NHWC array as NCHW in the recorded layout (``both``: the
    permuted view itself, as the forward hands its one-channel input)."""
    x = x_nhwc.permute(0, 3, 1, 2)
    if fmt == "both":
        return x
    return x.contiguous() if fmt == "contiguous" else x.contiguous(memory_format=torch.channels_last)


def layer_op(kind: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, h1_split: Optional[int] = None):
    """The layer as the forward calls it: with ``h1_split`` (the second
    half's channels) the hand-written conv on the channels-last halves (a
    transpose conv as the 3x3 conv of its zero-spread input, the spread
    included), else float32 with cuDNN's fused bias
    (``nn.Conv2d``/``TFConvTranspose2d.forward``), bf16 with the bias added
    after the rounding (``forward_bias_after``)."""
    if h1_split is not None and kind == "convt":
        k = w.permute(1, 0, 2, 3).flip(2, 3).contiguous()
        return lambda: conv3x3.conv3x3_relu(zero_spread(x), k, b)
    if h1_split is not None:
        ca = x.shape[1] - h1_split
        cl = torch.channels_last
        xa, xb = x[:, :ca].contiguous(memory_format=cl), x[:, ca:].contiguous(memory_format=cl) if h1_split else None
        return lambda: conv3x3.conv3x3_relu(xa, w, b, xb)
    if kind == "pool":
        return lambda: max_pool_same(x)
    fused = x.dtype == torch.float32
    if kind == "convt":
        def convt():
            y = F.conv_transpose2d(x, w, b if fused else None, 2)[..., : 2 * x.shape[-2], : 2 * x.shape[-1]]
            return y if fused else y + b[:, None, None]
        return convt
    if fused:
        return lambda: F.conv2d(x, w, b, padding=w.shape[-1] // 2)
    return lambda: conv_same(x, w, b)


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    tune_host_allocator()
    argv = sys.argv[1:] if argv is None else list(argv)
    if device is None and no_card("profile_layers"):
        return 1
    dev = resolve_device(device)
    n = opt(argv, "--n", N)
    dtypes = opt(argv, "--dtype", ["bfloat16", "float32"], str, many=True)
    widths, bottleneck = metaseg_unet.ENC_WIDTHS, metaseg_unet.BOTTLENECK  # read here: the tests narrow them
    max_reps = opt(argv, "--reps", MAX_REPS)
    table = layer_table(widths, bottleneck)
    study = Study("profile_layers", dev)
    # every draw before the card is used: a long idle stretch of the card
    # spoils torch.profiler's later windows (runtime/devtime.py)
    rng = np.random.default_rng(0)
    draws = [layer_inputs(rng, n, kind, h, cin, cout) for _, kind, h, cin, cout in table]
    model = MetasegUNet(widths, bottleneck, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    patches = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (n, PATCH, PATCH, 1), dtype=np.uint8)).to(dev)
    formats, sums = {}, {}
    for name in dtypes:
        dtype = DTYPES[name]
        m = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
        formats[name] = record_formats(m, patches[: record_patches(n)], dtype)
        print(f"-- {name} (peak {PEAK[name] / 1e12:g} TFLOP/s dense)", flush=True)
        total = 0.0
        with torch.no_grad(), parity_flags():
            for (layer, kind, h, cin, cout), (x_np, ks) in zip(table, draws):
                seen = formats[name].get(layer, {})
                fmt = seen.get("input", "contiguous")
                h1_split = seen.get("split") if seen.get("op") == "H1" else None
                x = _in_layout(torch.from_numpy(x_np).to(dev, dtype), fmt)
                k = torch.from_numpy(ks[0]).to(dev, dtype)
                w = (k.permute(2, 3, 0, 1) if kind == "convt" else k.permute(3, 2, 0, 1)).contiguous()
                b = torch.zeros(cout, dtype=dtype, device=dev)
                fl = flops(kind, h, cin, cout, n)
                est_s = max(fl / PEAK[name], n * h * h * cin * x.element_size() / PEAKS[H100]["hbm_bytes_per_s"])
                reps = int(min(max_reps, max(10, 0.2 / est_s)))
                study.device_row(layer, layer_op(kind, x, w, b, h1_split), reps, dtype=name, kind=kind, h=h, cin=cin, cout=cout,
                                 flops=fl, layout_in=fmt, layout_out=seen.get("output"), op=seen.get("op", "library"))
                row = study.rows[-1]
                if row["device_ms"] is not None:
                    row["chunk_ms"] = row["device_ms"] * CHUNK / n
                    row["tflops"] = fl / row["device_ms"] / 1e9
                    row["peak_share"] = row["tflops"] * 1e12 / PEAK[name]
                    total += row["chunk_ms"]
                    print(f"{layer:8s} {kind:5s} {row['op']:7s} {h:3d}² {cin:4d}->{cout:4d} {fmt:13s} {row['chunk_ms']:8.2f} ms/chunk "
                          f"{row['tflops']:7.1f} TFLOP/s ({100 * row['peak_share']:5.1f}% peak) reps={reps}", flush=True)
                del x
        with torch.no_grad():
            study.device_row("forward", lambda m=m, dtype=dtype: m(patches, dtype), 3, dtype=name, kind="forward")
        whole = study.rows[-1]
        if whole["device_ms"] is not None:
            sums[name] = {"rows_ms_per_chunk": total, "forward_ms_per_chunk": whole["device_ms"] * CHUNK / n}
            print(f"\nsum over layers: {total:.1f} ms/chunk ({CHUNK} patches) beside one whole forward's "
                  f"{sums[name]['forward_ms_per_chunk']:.1f} ms/chunk (device), {name}", flush=True)
    study.emit(n=n, formats=formats, sums=sums)
    return 0


if __name__ == "__main__":
    sys.exit(main())
