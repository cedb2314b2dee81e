"""Kernel B10, the fused level-1 decoder tail (``csrc/fused_tail.cu``), and
its plain PyTorch twin; replaces ``ecseg_tpu/ops/fused_tail.py``
``fused_dec1_head``.

``fused_dec1_head(x_cat, w1, b1, w2, b2, wh, bh)`` keeps the JAX layout:
``x_cat`` (N, 256, 256, c1) NHWC in bf16 or float32 (the level-1 concat,
``MetasegUNet.forward_cat1``), HWIO weights, and (N, 256, 256) int32 class
labels out.  It computes dec1_1 and dec1_2 (3x3 SAME conv, float32 sums of
inputs and weights in ``x_cat``'s dtype, float32 bias, ReLU, the result
rounded to ``x_cat``'s dtype), the 1x1 head (float32 sums and bias), the
softmax (max subtracted, a true division), the exact uint8 quantize and the
first-maximum argmax.  A CPU tensor goes to the twin, a CUDA tensor to the
kernel; ``LAUNCHES["fused_tail"]`` counts kernel launches.

By the input's dtype: bf16 runs both convs on the tensor cores
(``fused_tail_mma``, wgmma; the weights prepacked by ``pack_mma_weights``
into the steps ``mma_plan`` lays out), float32 on the CUDA cores
(``fused_tail_f32``: tensor cores would take float32 only as TF32).  The
bf16 kernel takes any c1 and c2 whose 4x4-tile plan fits a block's shared
memory (``mma_tile``), beyond every width the CUDA-core kernel's tiles
fit in bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cc_kernels import _launch, count_launch
from .tiling import quantize_u8

PATCH = 256
MAX_CLASSES = 16  # the kernel's per-pixel logit registers
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
_TWIN_CHUNK = 64  # patches per step of the twin, to bound its float32 memory


def _check_args(x_cat, w1, b1, w2, b2, wh, bh):
    if x_cat.dim() != 4 or tuple(x_cat.shape[1:3]) != (PATCH, PATCH):
        raise ValueError(f"fused_dec1_head: x_cat must be (N, {PATCH}, {PATCH}, c1), got {tuple(x_cat.shape)}")
    if x_cat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_dec1_head: x_cat must be bfloat16 or float32, got {x_cat.dtype}")
    c1 = x_cat.shape[3]
    c2 = w1.shape[3]
    ncls = wh.shape[3]
    shapes = {
        "w1": (tuple(w1.shape), (3, 3, c1, c2)), "b1": (tuple(b1.shape), (c2,)),
        "w2": (tuple(w2.shape), (3, 3, c2, c2)), "b2": (tuple(b2.shape), (c2,)),
        "wh": (tuple(wh.shape), (1, 1, c2, ncls)), "bh": (tuple(bh.shape), (ncls,)),
    }
    for name, (got, want) in shapes.items():
        if got != want:
            raise ValueError(f"fused_dec1_head: {name} has shape {got}, expected {want}")
    return c1, c2, ncls


def _conv_bias_relu(x, w_hwio, b):
    """3x3 SAME conv of NCHW float32 ``x`` with an HWIO kernel, then the
    float32 bias and the ReLU."""
    y = F.conv2d(x, w_hwio.permute(3, 2, 0, 1), None, padding=1)
    return torch.relu(y + b[:, None, None])


def fused_dec1_head_plain(x_cat, w1, b1, w2, b2, wh, bh) -> torch.Tensor:
    """B10 twin: the same chain in float32 on values in ``x_cat``'s dtype,
    rounded where the kernel rounds; TF32 off on the card."""
    _check_args(x_cat, w1, b1, w2, b2, wh, bh)
    dt = x_cat.dtype
    w1, w2, wh = (w.to(dt).float() for w in (w1, w2, wh))
    b1, b2, bh = (b.float() for b in (b1, b2, bh))
    out = []
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for x in x_cat.split(_TWIN_CHUNK):
            y = _conv_bias_relu(x.permute(0, 3, 1, 2).float(), w1, b1).to(dt).float()
            y = _conv_bias_relu(y, w2, b2).to(dt).float()
            logits = torch.einsum("nchw,ck->nhwk", y, wh[0, 0]) + bh
            e = torch.exp(logits - logits.amax(-1, keepdim=True))
            s = e[..., 0]
            for k in range(1, e.shape[-1]):  # the kernel's order
                s = s + e[..., k]
            probs = e / s[..., None]
            out.append(torch.argmax(quantize_u8(probs), dim=-1).to(torch.int32))
    if not out:
        return torch.empty((0, PATCH, PATCH), dtype=torch.int32, device=x_cat.device)
    return torch.cat(out)


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    pad = [0, 0] * t.dim()
    pad[2 * (t.dim() - 1 - dim) + 1] = size - t.shape[dim]
    return F.pad(t, pad)


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


def smem_bytes(c1: int, c2: int, itemsize: int = 4, tile: int = 16) -> int:
    """Dynamic shared memory of one block of the float32 kernel
    (csrc/fused_tail.cu ``fused_tail_f32``) for a ``tile`` x ``tile``
    output tile: the input tile with a 2-pixel halo (or the dec1_2 output,
    whichever is larger) and the dec1_1 tile with a 1-pixel halo, each
    pixel padded by one 32-bit word."""
    pad = 4 // itemsize
    a = max((tile + 4) ** 2 * (c1 + pad), tile * tile * (c2 + pad))
    return (a + (tile + 2) ** 2 * (c2 + pad)) * itemsize


def _k_chunk(cp: int) -> int:
    """The input channels of one weight step: the largest multiple of 16
    that divides ``cp`` and is at most 128."""
    return 16 * max(d for d in range(1, 9) if (cp // 16) % d == 0)


def mma_plan(c1: int, c2: int) -> dict:
    """The bf16 kernel's channel plan (csrc/fused_tail.cu ``Plan``): c1 and
    c2 padded to multiples of 16 (the MMA's k; the pad channels are zeros
    in shared memory and in the packed weights), output channels in
    n-groups of ``nc`` <= 64 (c2p a multiple of nc), ``kc1``/``kc2`` input
    channels per unit of K (one tap's k-chunk) and ``u1``/``u2`` units per
    weight step: a step holds at most max(kc1, kc2) channels, so dec1_2's
    steps span several taps where c2 < c1."""
    c1p, c2p = _ceil(c1, 16), _ceil(c2, 16)
    nc = min(c2p, 64)
    c2p = _ceil(c2p, nc)
    kc1, kc2 = _k_chunk(c1p), _k_chunk(c2p)
    ks = max(kc1, kc2)
    return {"c1p": c1p, "c2p": c2p, "nc": nc, "kc1": kc1, "kc2": kc2, "u1": ks // kc1, "u2": ks // kc2}


def mma_smem_bytes(plan: dict, tile: int = 16) -> int:
    """Dynamic shared memory of one block of the bf16 kernel, in bf16: the
    input tile with a 2-pixel halo, dec1_1's tile with a 1-pixel halo and
    dec1_2's tile, each pixel padded by 8 bf16 (16 bytes) so that an
    ldmatrix's 8 rows fall in distinct banks, and two weight stages (in
    wgmma's canonical layout, unpadded, from a 128-byte boundary)."""
    p1, p2 = plan["c1p"] + 8, plan["c2p"] + 8
    stage = plan["nc"] * max(plan["u1"] * plan["kc1"], plan["u2"] * plan["kc2"])
    return 2 * ((tile + 4) ** 2 * p1 + ((tile + 2) ** 2 + tile * tile) * p2 + 2 * stage) + 128


def mma_tile(plan: dict):
    """(tile, shared bytes) of the bf16 kernel: 16x16 output tiles, or 8x8
    or 4x4 where the larger exceed a block's shared memory; raises where
    none fits."""
    for tile in (16, 8, 4):
        smem = mma_smem_bytes(plan, tile)
        if smem <= SMEM_LIMIT:
            return tile, smem
    raise ValueError(f"fused_dec1_head: the channel plan {plan} needs {smem} bytes of shared memory (> {SMEM_LIMIT})")


def _canonical(m: torch.Tensor) -> torch.Tensor:
    """(n, k) -> wgmma's no-swizzle K-major layout, flat: core matrices of
    8 n x 8 k (128 contiguous bytes, n-major), core (k // 8, n // 8) at
    index (k // 8) * (n_total // 8) + n // 8."""
    n, k = m.shape
    return m.reshape(n // 8, 8, k // 8, 8).permute(2, 0, 1, 3).flatten()


def _steps(w: torch.Tensor, kc: int, u: int, nc: int) -> torch.Tensor:
    """(9, cp, c2p) -> one conv's weight steps, flat: per n-group, its
    (tap, k-chunk) units in tap-major order, u units a step, each step the
    (nc, units * kc) matrix (the units' channels side by side) in
    ``_canonical`` layout."""
    taps, cp, c2p = w.shape
    units = w.reshape(taps * (cp // kc), kc, c2p // nc, nc).permute(2, 0, 3, 1)  # (groups, units, nc, kc)
    return torch.cat([_canonical(step.permute(1, 0, 2).reshape(nc, -1)) for group in units for step in group.split(u)])


def pack_mma_weights(w1: torch.Tensor, w2: torch.Tensor, plan: dict) -> torch.Tensor:
    """HWIO ``w1`` (3, 3, c1, c2) and ``w2`` (3, 3, c2, c2) -> the bf16
    kernel's weight steps, flat: dec1_1's, then dec1_2's (``_steps``), zero
    where padded."""
    c1p, c2p, nc = plan["c1p"], plan["c2p"], plan["nc"]
    w1 = _pad_to(_pad_to(w1, 2, c1p), 3, c2p).reshape(9, c1p, c2p)
    w2 = _pad_to(_pad_to(w2, 2, c2p), 3, c2p).reshape(9, c2p, c2p)
    return torch.cat([_steps(w1, plan["kc1"], plan["u1"], nc), _steps(w2, plan["kc2"], plan["u2"], nc)])


def fused_dec1_head(x_cat, w1, b1, w2, b2, wh, bh) -> torch.Tensor:
    """B10: (N, 256, 256, c1) ``x_cat`` -> (N, 256, 256) int32 labels.
    bf16 runs the tensor-core kernel, float32 the CUDA-core kernel."""
    if x_cat.device.type == "cpu":
        return fused_dec1_head_plain(x_cat, w1, b1, w2, b2, wh, bh)
    if x_cat.device.type != "cuda":
        raise ValueError(f"fused_dec1_head: expected a CPU or CUDA tensor, got {x_cat.device}")
    c1, c2, ncls = _check_args(x_cat, w1, b1, w2, b2, wh, bh)
    if not x_cat.is_contiguous():
        raise ValueError("fused_dec1_head: expected a contiguous x_cat")
    if ncls > MAX_CLASSES:
        raise ValueError(f"fused_dec1_head: at most {MAX_CLASSES} classes, got {ncls}")
    n = x_cat.shape[0]
    dt, dev = x_cat.dtype, x_cat.device
    out = torch.empty((n, PATCH, PATCH), dtype=torch.int32, device=dev)
    bhk = bh.to(dev, torch.float32).contiguous()
    if dt == torch.bfloat16:
        plan = mma_plan(c1, c2)
        c2p = plan["c2p"]
        tile, smem = mma_tile(plan)
        if n == 0:
            return out
        wpk = pack_mma_weights(w1.to(dev, dt), w2.to(dev, dt), plan).contiguous()
        b1k, b2k = (_pad_to(b.to(dev, torch.float32), 0, c2p).contiguous() for b in (b1, b2))
        # head weights as float32 (ceil(ncls / 4) * 4, c2p) of bf16 values
        whk = _pad_to(_pad_to(wh.to(dev, dt).float(), 2, c2p), 3, _ceil(ncls, 4)).reshape(c2p, -1).t().contiguous()
        vec = int(c1 % 8 == 0 and x_cat.data_ptr() % 16 == 0)
        _launch(
            "ecseg_fused_tail_mma", dev, x_cat.data_ptr(), wpk.data_ptr(), b1k.data_ptr(), b2k.data_ptr(),
            whk.data_ptr(), bhk.data_ptr(), out.data_ptr(), n, c1, plan["c1p"], c2p, plan["nc"], plan["kc1"],
            plan["kc2"], plan["u1"], plan["u2"], ncls, vec, tile, smem,
        )
    else:
        if n > 65535:
            raise ValueError(f"fused_dec1_head: {n} float32 patches exceed the kernel grid's 65535 (call it on chunks)")
        # output channels padded to a multiple of 8 (the kernel's channel
        # group) with zero weights and biases: the pad channels stay 0
        c2p = _ceil(c2, 8)
        w1k = _pad_to(w1.to(dev, dt), 3, c2p).reshape(9, c1, c2p).contiguous()
        w2k = _pad_to(_pad_to(w2.to(dev, dt), 2, c2p), 3, c2p).reshape(9, c2p, c2p).contiguous()
        whk = _pad_to(wh.to(dev, dt), 2, c2p).reshape(c2p, ncls).contiguous()
        b1k, b2k = (_pad_to(b.to(dev, torch.float32), 0, c2p).contiguous() for b in (b1, b2))
        # 16x16 output tiles, or 8x8 where those exceed a block's shared memory
        tile = 16 if smem_bytes(c1, c2p, 4, 16) <= SMEM_LIMIT else 8
        smem = smem_bytes(c1, c2p, 4, tile)
        if smem > SMEM_LIMIT:
            raise ValueError(f"fused_dec1_head: c1={c1}, c2={c2} need {smem} bytes of shared memory (> {SMEM_LIMIT})")
        if n == 0:
            return out
        _launch(
            "ecseg_fused_tail", dev, x_cat.data_ptr(), w1k.data_ptr(), b1k.data_ptr(), w2k.data_ptr(),
            b2k.data_ptr(), whk.data_ptr(), bhk.data_ptr(), out.data_ptr(), n, c1, c2p, ncls, tile, smem,
        )
    count_launch("fused_tail")
    return out
