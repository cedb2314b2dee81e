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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cc_kernels import LAUNCHES, _launch
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


def smem_bytes(c1: int, c2: int, itemsize: int, tile: int = 16) -> int:
    """Dynamic shared memory of one block (csrc/fused_tail.cu) for a
    ``tile`` x ``tile`` output tile: the input tile with a 2-pixel halo (or
    the dec1_2 output, whichever is larger) and the dec1_1 tile with a
    1-pixel halo, each pixel padded by one 32-bit word."""
    pad = 4 // itemsize
    a = max((tile + 4) ** 2 * (c1 + pad), tile * tile * (c2 + pad))
    return (a + (tile + 2) ** 2 * (c2 + pad)) * itemsize


def fused_dec1_head(x_cat, w1, b1, w2, b2, wh, bh) -> torch.Tensor:
    """B10: (N, 256, 256, c1) ``x_cat`` -> (N, 256, 256) int32 labels."""
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
    if n > 65535:
        raise ValueError(f"fused_dec1_head: {n} patches exceed the kernel grid's 65535 (call it on chunks)")
    dt, dev = x_cat.dtype, x_cat.device
    # output channels padded to a multiple of 8 (the kernel's channel
    # group) with zero weights and biases: the pad channels stay 0
    c2p = -(-c2 // 8) * 8
    w1k = _pad_to(w1.to(dev, dt), 3, c2p).reshape(9, c1, c2p).contiguous()
    w2k = _pad_to(_pad_to(w2.to(dev, dt), 2, c2p), 3, c2p).reshape(9, c2p, c2p).contiguous()
    whk = _pad_to(wh.to(dev, dt), 2, c2p).reshape(c2p, ncls).contiguous()
    b1k, b2k = (_pad_to(b.to(dev, torch.float32), 0, c2p).contiguous() for b in (b1, b2))
    bhk = bh.to(dev, torch.float32).contiguous()
    # 16x16 output tiles, or 8x8 where those exceed a block's shared memory
    tile = 16 if smem_bytes(c1, c2p, x_cat.element_size(), 16) <= SMEM_LIMIT else 8
    smem = smem_bytes(c1, c2p, x_cat.element_size(), tile)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_dec1_head: c1={c1}, c2={c2} need {smem} bytes of shared memory (> {SMEM_LIMIT})")
    out = torch.empty((n, PATCH, PATCH), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    _launch(
        "ecseg_fused_tail", dev, x_cat.data_ptr(), int(dt == torch.bfloat16), w1k.data_ptr(), b1k.data_ptr(),
        w2k.data_ptr(), b2k.data_ptr(), whk.data_ptr(), bhk.data_ptr(), out.data_ptr(), n, c1, c2p, ncls, tile, smem,
    )
    LAUNCHES["fused_tail"] += 1
    return out
