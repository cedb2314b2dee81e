"""Conv-net layers with the TF semantics of ``ecseg_tpu/models/layers.py``,
in PyTorch's NCHW/OIHW layout.

- ``SameConv2d``: stride-1 'SAME' convolution with an odd kernel (symmetric
  padding k // 2).  ``forward_bias_after`` (both conv layers) is the bf16
  form: the kernel cast to the input's dtype, the conv without bias,
  rounded, then the bias added in the same dtype.
- ``TFConvTranspose2d``: tf conv2d_transpose(kernel 3, stride 2, 'SAME'),
  whose grad-of-conv padding is (0, 1); that equals the FULL torch
  ``conv_transpose2d`` (padding 0) truncated to stride x input, as pinned in
  tests/test_layers.py.  Its weight is (in, out, kh, kw), the JAX HWIO
  kernel permuted with no flip (JAX flips inside conv2d_transpose).
- ``max_pool_same``: 2x2/2 'SAME' max pool (``ceil_mode`` pads at the end,
  as TF does for odd sizes).
- ``glorot_uniform_``: TF's VarianceScaling(fan_avg, uniform) with HWIO fan
  counts, from an explicit generator.
- ``KernelRouted``: the route of a forward's ReLU'd 3x3 convs, and of its
  transpose convs at small batches (``transpose_on_kernel``), to the
  hand-written float32 kernel (``ops/conv3x3.conv3x3_relu``), the base of
  the metaseg and NuSeT U-Nets; ``kernel_conv_transpose3x3``: a
  ``TFConvTranspose2d`` on that kernel.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3
from ..runtime import fallbacks


def add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    """``y + bias`` in ``y``'s dtype, as the JAX package adds a conv's bias
    after the conv output is rounded to its dtype (``layers.py:47-48``);
    cuDNN's fused bias would add it before the rounding."""
    return y if bias is None else y + bias.to(y.dtype)[:, None, None]


def conv_same(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """Stride-1 'SAME' conv with an odd OIHW kernel, bias added after the
    rounding (``add_bias``)."""
    return add_bias(F.conv2d(x, weight, None, padding=weight.shape[-1] // 2), bias)


class SameConv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__(cin, cout, k, padding=k // 2)

    def forward_bias_after(self, x: torch.Tensor) -> torch.Tensor:
        return conv_same(x, self.weight.to(x.dtype), self.bias)


class TFConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 2):
        super().__init__(cin, cout, k, stride=stride)

    def _truncate(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        return y[..., : x.shape[-2] * s, : x.shape[-1] * s]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._truncate(x, super().forward(x))

    def forward_bias_after(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), None, self.stride)
        return add_bias(self._truncate(x, y), self.bias)


class _ParityHolders:
    """The holders of the parity flags across threads.  cuDNN's flags are
    process-wide: ``torch.backends.cudnn.flags`` saves them on entry and
    restores them on exit, so of two threads that overlap, the first to
    leave would restore the caller's flags (TF32 on) while the other still
    runs a float32 parity conv.  Here the first holder enters that context
    and the last one to leave exits it; a holder in between only counts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._ctx = None

    @contextlib.contextmanager
    def hold(self):
        with self._lock:
            if self._count == 0:
                ctx = torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
                ctx.__enter__()
                self._ctx = ctx
            self._count += 1
        try:
            yield
        finally:
            with self._lock:
                self._count -= 1
                if self._count == 0:
                    ctx, self._ctx = self._ctx, None
                    ctx.__exit__(None, None, None)


_PARITY = _ParityHolders()


def parity_flags():
    """cuDNN settings under which the float32 convs keep their parity with
    the JAX package's ``Precision.HIGHEST``: no TF32, deterministic
    algorithms, no autotuning.  Safe across threads: the flags hold while
    any thread is inside, and the caller's come back when the last one
    leaves."""
    return _PARITY.hold()


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def glorot_uniform_(layer: nn.Module, generator: torch.Generator) -> None:
    """Glorot-uniform weight (fan_in = kh*kw*in, fan_out = kh*kw*out, as the
    JAX initializer counts them on HWIO) and zero bias."""
    wt = layer.weight
    if isinstance(layer, nn.ConvTranspose2d):
        cin, cout, kh, kw = wt.shape
    else:
        cout, cin, kh, kw = wt.shape
    limit = math.sqrt(6.0 / (kh * kw * cin + kh * kw * cout))
    with torch.no_grad():
        u = torch.rand(wt.shape, generator=generator, dtype=torch.float32)
        wt.copy_(u * (2 * limit) - limit)
        layer.bias.zero_()


# A routed forward's transpose convs of at most this many images run on the
# kernel.  On an H100 (cuDNN at TF32 off, deterministic), summed over a
# U-Net's four, the kernel's 4x products beat cuDNN's algorithm choice 6x
# for NuSeT's one image and 1.1 to 5.5x for both metaseg widths at 3 to 16
# patches, trail it by at most 0.5 ms at 1 and 2, are even at 32, and lose
# to its dgrad GEMM at metaseg's 64- and 100-patch calls at the wide (XL)
# widths (the whole forward 281 against 296 ms at 100).
ZERO_SPREAD_MAX_IMAGES = 16


def transpose_on_kernel(x: torch.Tensor) -> bool:
    """Whether a routed forward's transpose conv of ``x`` (N, C, H, W) runs
    on the kernel (:func:`kernel_conv_transpose3x3`), from its batch."""
    return x.shape[0] <= ZERO_SPREAD_MAX_IMAGES


class KernelRouted(nn.Module):
    """A U-Net whose float32 forward on the card may run its ReLU'd 3x3
    convs, and its transpose convs at small batches, on the hand-written
    kernel ``conv3x3.conv3x3_relu``.  The subclass holds its layers in
    ``self.layers`` and runs one of them without the ReLU, its own way, in
    ``self._conv(name, x)``."""

    def _kernel_route(self, x, dtype: torch.dtype) -> bool:
        """Whether a forward in ``dtype`` sends its convs to the kernel: a
        float32 forward of float32 weights on the card that builds no
        autograd graph.  The CPU, autograd's forward and every other dtype
        keep their cuDNN / ``F.conv2d`` path."""
        params = list(self.parameters())
        if not (x.is_cuda and dtype == torch.float32 and all(p.dtype == torch.float32 for p in params)):
            return False
        return not torch.is_grad_enabled() or not (x.requires_grad or any(p.requires_grad for p in params))

    def _conv_relu(self, name: str, x: torch.Tensor, x2: Optional[torch.Tensor] = None, route: bool = False) -> torch.Tensor:
        """``relu(layer(cat([x, x2], 1)))``.  On ``route``, a 3x3
        ``SameConv2d`` whose shapes the kernel takes runs on it, its
        operands and result channels-last, ``x2`` (a decoder's upsampled
        half beside its skip ``x``) read in place, the bias added after the
        float32 sum; a refused shape is counted in ``runtime/fallbacks`` as
        ``conv3x3_cudnn``.  Otherwise ``self._conv`` on the concat."""
        layer = self.layers[name]
        if route and isinstance(layer, SameConv2d) and layer.kernel_size == (3, 3):
            if conv3x3.refusal(x, layer.weight, x2) is None:
                cl = torch.channels_last
                return conv3x3.conv3x3_relu(
                    x.contiguous(memory_format=cl), layer.weight, layer.bias,
                    None if x2 is None else x2.contiguous(memory_format=cl),
                )
            fallbacks.record(fallbacks.CONV3X3_CUDNN)
        if x2 is not None:
            x = torch.cat([x, x2], dim=1)
        return torch.relu(self._conv(name, x))

    def _conv_transpose(self, name: str, x: torch.Tensor, relu: bool, route: bool = False) -> torch.Tensor:
        """A transpose conv, then its ReLU on ``relu``: on the kernel
        (:func:`kernel_conv_transpose3x3`) on ``route`` when
        :func:`transpose_on_kernel` picks it for ``x`` and the kernel takes
        the shapes, else ``self._conv``."""
        if route and transpose_on_kernel(x):
            y = kernel_conv_transpose3x3(self.layers[name], x, relu)
            if y is not None:
                return y
        y = self._conv(name, x)
        return torch.relu(y) if relu else y


def _transpose_as_conv(layer: TFConvTranspose2d) -> torch.Tensor:
    """The 3x3 conv weights that compute ``layer`` on its input spread over
    the zero plane (:func:`kernel_conv_transpose3x3`): the kernel flipped,
    its (in, out) axes swapped to OIHW.  Kept on the layer beside the
    version and storage they were made from."""
    wt = layer.weight
    key = (wt._version, wt.data_ptr())
    held = getattr(layer, "_conv3x3_weights", None)
    if held is not None and held[0] == key:
        return held[1]
    k = wt.detach().permute(1, 0, 2, 3).flip(2, 3).contiguous()
    layer._conv3x3_weights = (key, k, wt)  # the source keeps its storage from being reused
    return k


def kernel_conv_transpose3x3(layer: nn.Module, x: torch.Tensor, relu: bool) -> Optional[torch.Tensor]:
    """``layer.forward_bias_after(x)``, then its ReLU on ``relu``, on
    ``conv3x3.conv3x3_relu``: TF's 3x3 stride-2 'SAME' transpose conv of an
    (h, w) plane is the 3x3 'SAME' conv, with the kernel flipped and its
    axes swapped, of the 2h x 2w zero plane that holds ``x`` at its odd rows
    and columns (the zeros add exact zeros to the float32 sums; 4x the
    products of the transpose conv).  Channels-last in and out.  None when
    ``layer`` is not a 3x3 stride-2 ``TFConvTranspose2d`` with a bias or
    the kernel refuses the shapes (counted as ``conv3x3_cudnn``)."""
    if not (isinstance(layer, TFConvTranspose2d) and layer.kernel_size == (3, 3) and layer.stride == (2, 2) and layer.bias is not None):
        return None
    k = _transpose_as_conv(layer)
    n, c, h, w = x.shape
    if conv3x3.refusal(x.new_empty((n, c, 2 * h, 2 * w), device="meta"), k) is not None:
        fallbacks.record(fallbacks.CONV3X3_CUDNN)
        return None
    return conv3x3.conv3x3_relu(zero_spread(x), k, layer.bias, relu=relu)


def zero_spread(x: torch.Tensor) -> torch.Tensor:
    """The (n, c, 2h, 2w) channels-last zero plane that holds ``x`` (n, c,
    h, w) at its odd rows and columns: the input of a 3x3 stride-2 'SAME'
    transpose conv run as a 3x3 conv (:func:`kernel_conv_transpose3x3`)."""
    n, c, h, w = x.shape
    up = x.new_zeros((n, 2 * h, 2 * w, c)).permute(0, 3, 1, 2)
    up[:, :, 1::2, 1::2] = x
    return up
