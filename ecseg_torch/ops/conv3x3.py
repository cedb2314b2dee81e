"""The float32 3x3 convolution with bias and ReLU of the metaseg and NuSeT
U-Net forwards (``csrc/conv3x3_f32.cu``) and its plain PyTorch twin.

``conv3x3_relu(x, weight, bias, x2=None, relu=True)`` computes
``relu(conv2d(cat([x, x2], 1), weight, bias, padding 1))`` (without the
ReLU when ``relu`` is False) for NCHW-shaped float32 tensors:
``weight`` OIHW (cout, cin, 3, 3), ``bias`` (cout,), ``x2`` an optional
second half of the input channels (a decoder's upsampled half beside its
skip), read in place.  On the card the operands are channels-last
(``memory_format=torch.channels_last``: NHWC in memory) and so is the
result.

The kernel replaces cuDNN, not a TPU kernel: the JAX package leaves these
convs to XLA.  It sums every product in float32 FMAs in one fixed order:
over the input channels (``x``'s, then ``x2``'s), per channel the nine
taps row-major, then the bias, then the ReLU if any; no TF32, so it keeps the
float32 forward's parity with the JAX package's ``Precision.HIGHEST``.
The twin sums in the same order (unfused multiply and add).

Dispatch is by where the input lies: a CPU tensor goes to the twin, a CUDA
tensor to the kernel, which raises on what it does not take
(:func:`refusal` names the shapes; the dtype, device and layout are the
caller's to get right).  ``cc_kernels.LAUNCHES["conv3x3"]`` counts kernel
launches (never twin calls).  The weights are packed K-major for the
kernel once per weight tensor (:func:`packed_weights`), so a call launches
the kernel alone.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .cc_kernels import _launch, count_launch

BN_SMALL, BN_LARGE = 64, 128  # output channels of a block: cout <= 64, else
BK_VEC, BK_ELEM = 16, 1  # input channels a chunk (block_k)
PACKED_ATTR = "_conv3x3_packed"  # the weight tensor's attribute that holds its packed copy


def block_n(cout: int) -> int:
    return BN_SMALL if cout <= BN_SMALL else BN_LARGE


def block_k(ca: int, cb: int = 0) -> int:
    """Input channels a chunk: 16, copied 16 bytes at a time, when the
    channel counts are multiples of 4 and no chunk straddles the two
    halves; else 1, copied an element at a time."""
    if ca % 4 or cb % 4 or (cb and ca % BK_VEC):
        return BK_ELEM
    return BK_VEC


def refusal(x: torch.Tensor, weight: torch.Tensor, x2: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why the kernel does not take these shapes, or None when it does."""
    if weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        return f"kernel {tuple(weight.shape)} is not 3x3"
    if x.dim() != 4 or (x2 is not None and (x2.dim() != 4 or x2.shape[0] != x.shape[0] or x2.shape[2:] != x.shape[2:])):
        return f"inputs {tuple(x.shape)} and {None if x2 is None else tuple(x2.shape)} do not fit"
    ca, cb = x.shape[1], 0 if x2 is None else x2.shape[1]
    cout = weight.shape[0]
    if weight.shape[1] != ca + cb:
        return f"kernel {tuple(weight.shape)} takes {weight.shape[1]} input channels, not {ca + cb}"
    if cout % 4:
        return f"cout {cout} is not a multiple of 4"
    return None


def _check_args(x, weight, bias, x2) -> None:
    for t, what in ((x, "x"), (weight, "weight"), (bias, "bias"), (x2, "x2")):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"conv3x3_relu: {what} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"conv3x3_relu: {what} must be float32, got {t.dtype}")
    why = refusal(x, weight, x2)
    if why is not None:
        raise ValueError(f"conv3x3_relu: {why}")
    if bias is None or tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"conv3x3_relu: bias must be ({weight.shape[0]},), got {None if bias is None else tuple(bias.shape)}")


def check_layout(x: torch.Tensor, x2: Optional[torch.Tensor]) -> None:
    """The kernel reads NHWC memory: each operand channels-last."""
    for t, what in ((x, "x"), (x2, "x2")):
        if t is not None and not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"conv3x3_relu: {what} must be channels-last (NHWC in memory)")


def conv3x3_relu_plain(x, weight, bias, x2=None, relu: bool = True) -> torch.Tensor:
    """The twin: the kernel's sums in its order, one product at a time, in
    float32, then the bias and the ReLU on ``relu``; channels-last out."""
    _check_args(x, weight, bias, x2)
    xs = x if x2 is None else torch.cat([x, x2], dim=1)
    n, cin, h, w = xs.shape
    xp = F.pad(xs, (1, 1, 1, 1))
    acc = torch.zeros((n, weight.shape[0], h, w), dtype=torch.float32, device=x.device)
    for ci in range(cin):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            acc = acc + xp[:, ci : ci + 1, dy : dy + h, dx : dx + w] * weight[:, ci, dy, dx][None, :, None, None]
    y = acc + bias[None, :, None, None]
    return (torch.relu(y) if relu else y).contiguous(memory_format=torch.channels_last)


def pack_weights(weight: torch.Tensor, bn: int, bk: int) -> torch.Tensor:
    """OIHW (cout, cin, 3, 3) -> the kernel's weights, flat: per block of
    ``bn`` output channels, per chunk of ``bk`` input channels, per input
    channel, per tap (row-major), the block's ``bn`` output channels; zero
    where cin or cout is padded."""
    cout, cin = weight.shape[:2]
    cinp, coutp = -(-cin // bk) * bk, -(-cout // bn) * bn
    k = weight.permute(1, 2, 3, 0).reshape(cin, 9, cout)
    if (cinp, coutp) != (cin, cout):
        k = F.pad(k, (0, coutp - cout, 0, 0, 0, cinp - cin))
    # (chunk, ci, tap, block, co) -> (block, chunk, ci, tap, co): the one copy
    return k.reshape(cinp // bk, bk, 9, coutp // bn, bn).permute(3, 0, 1, 2, 4).flatten()


def packed_weights(weight: torch.Tensor, bn: int, bk: int) -> torch.Tensor:
    """:func:`pack_weights` once per weight tensor: the packed copy is kept
    on ``weight`` (``PACKED_ATTR``) beside the storage and version it was
    packed from, and packed again when either changes (``.to``,
    ``load_state_dict``, an optimizer step; a write through ``.data``
    bypasses the version and is not seen).  The kept source holds its
    storage alive, so a new storage never takes its address.
    ``copy.deepcopy`` of a parameter leaves the copy behind."""
    held = getattr(weight, PACKED_ATTR, None)
    key = (weight._version, bn, bk)
    if held is not None and held[0] == key and held[1].device == weight.device and held[1].data_ptr() == weight.data_ptr():
        return held[2]
    wpk = pack_weights(weight.detach(), bn, bk)
    setattr(weight, PACKED_ATTR, (key, weight.detach(), wpk))
    return wpk


def conv3x3_relu(x, weight, bias, x2=None, relu: bool = True) -> torch.Tensor:
    """``relu(conv2d(cat([x, x2], 1), weight, bias, padding=1))``, float32,
    the ReLU left out when ``relu`` is False; the kernel on the card
    (channels-last operands and result)."""
    if x.device.type == "cpu":
        return conv3x3_relu_plain(x, weight, bias, x2, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_relu: expected a CPU or CUDA tensor, got {x.device}")
    _check_args(x, weight, bias, x2)
    check_layout(x, x2)
    n, ca, h, w = x.shape
    cb = 0 if x2 is None else x2.shape[1]
    cout = weight.shape[0]
    out = torch.empty((n, cout, h, w), dtype=torch.float32, device=x.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    bn, bk = block_n(cout), block_k(ca, cb)
    wpk = packed_weights(weight, bn, bk)
    bp = bias.detach().contiguous()
    if cout % bn:
        bp = F.pad(bp, (0, bn - cout % bn))
    vec = int(bk != BK_ELEM and all(t.data_ptr() % 16 == 0 for t in (x, x2) if t is not None))
    _launch(
        "ecseg_conv3x3", x.device, x.data_ptr(), 0 if x2 is None else x2.data_ptr(), wpk.data_ptr(), bp.data_ptr(),
        out.data_ptr(), n, h, w, ca, cb, cout, bn, bk, vec, int(relu),
    )
    count_launch("conv3x3")
    return out
