"""Kernel B11, the 3x3 stride-2 'SAME' transpose conv with bias and ReLU
(``csrc/convt.cu``), and its plain PyTorch twin; replaces
``ecseg_tpu/ops/convt_pallas.py`` ``conv2d_transpose_packed``.

``conv2d_transpose_packed(x, kernel, bias=None, relu=True)`` computes
``relu(conv2d_transpose(x, kernel, bias, stride 2, SAME))`` in ``x``'s
dtype (bf16 or float32) with float32 sums and a float32 bias, NHWC input
(N, h, w, cin), HWIO kernel (3, 3, cin, cout), output (N, 2h, 2w, cout).
Like the JAX function it always applies the ReLU (``relu=False`` raises).
The kernel takes any h, w and cin and ``cout % 4 == 0`` (the JAX
function needs ``w % 8 == 0`` and ``cout % 64 == 0``).  By the input's
dtype, bf16 runs on the tensor cores (``convt_mma``: per output parity an
implicit GEMM over the four input windows on wgmma, weights prepacked by
``pack_mma_weights``), float32 on the CUDA cores (``convt_quad``).  Like
the JAX function, no model calls it: the U-Net's transpose convs stay on
cuDNN.  A CPU tensor goes to the twin, a CUDA tensor to the kernel;
``LAUNCHES["convt"]`` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cc_kernels import _launch, count_launch


def _check_args(x, kernel, bias, relu):
    if not relu:
        raise NotImplementedError("the decoder always applies ReLU")
    if x.dim() != 4 or kernel.dim() != 4 or tuple(kernel.shape[:2]) != (3, 3) or kernel.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d_transpose_packed: x {tuple(x.shape)} and kernel {tuple(kernel.shape)} do not fit")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv2d_transpose_packed: x must be bfloat16 or float32, got {x.dtype}")
    if bias is not None and tuple(bias.shape) != (kernel.shape[3],):
        raise ValueError(f"conv2d_transpose_packed: bias {tuple(bias.shape)} != ({kernel.shape[3]},)")


def conv2d_transpose_packed_plain(x, kernel, bias=None, relu: bool = True) -> torch.Tensor:
    """B11 twin: ``conv_transpose2d`` in float32 of the values in ``x``'s
    dtype, cut to TF's 'SAME' size (the full output's first 2h x 2w, as
    ``layers.TFConvTranspose2d``), plus the float32 bias, ReLU, one rounding;
    TF32 off on the card."""
    _check_args(x, kernel, bias, relu)
    dt = x.dtype
    n, h, w, _ = x.shape
    k = kernel.to(dt).float().permute(2, 3, 0, 1)  # (cin, cout, kh, kw)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).float(), k, None, stride=2)[..., : 2 * h, : 2 * w]
    if bias is not None:
        y = y + bias.float()[:, None, None]
    return torch.relu(y).to(dt).permute(0, 2, 3, 1).contiguous()


# the bf16 kernel's blocking (csrc/convt.cu): output channels per block and
# input channels per chunk
N_BLOCK, K_CHUNK = 64, 32


def pack_mma_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, cin, cout) -> the bf16 kernel's weights, flat: per block
    of 64 output channels, per 32-channel chunk of cin, per tap, the
    (64, 32) matrix (output channel, input channel) in wgmma's no-swizzle
    K-major layout (core matrices of 8 x 8, 128 contiguous bytes each, core
    (k // 8, n // 8) at index (k // 8) * 8 + n // 8), zero where cin or
    cout is padded."""
    _, _, cin, cout = kernel.shape
    cinp, coutp = -(-cin // K_CHUNK) * K_CHUNK, -(-cout // N_BLOCK) * N_BLOCK
    k = F.pad(kernel, (0, coutp - cout, 0, cinp - cin))
    k = k.reshape(9, cinp // K_CHUNK, K_CHUNK // 8, 8, coutp // N_BLOCK, N_BLOCK // 8, 8)
    # (tap, chunk, k8, kr, block, n8, nr) -> (block, chunk, tap, k8, n8, nr, kr)
    return k.permute(4, 1, 0, 2, 5, 6, 3).flatten()


def conv2d_transpose_packed(x, kernel, bias=None, relu: bool = True) -> torch.Tensor:
    """B11: (N, h, w, cin) -> (N, 2h, 2w, cout) in ``x``'s dtype; bf16 on
    the tensor cores, float32 on the CUDA cores."""
    if x.device.type == "cpu":
        return conv2d_transpose_packed_plain(x, kernel, bias, relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_transpose_packed: expected a CPU or CUDA tensor, got {x.device}")
    _check_args(x, kernel, bias, relu)
    if not x.is_contiguous():
        raise ValueError("conv2d_transpose_packed: expected a contiguous x")
    n, h, w, cin = x.shape
    cout = kernel.shape[3]
    if cout % 4:
        raise ValueError(f"conv2d_transpose_packed: cout must be a multiple of 4, got {cout}")
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    k = kernel.to(x.device, x.dtype)
    b = bias.to(x.device, torch.float32) if bias is not None else torch.zeros(cout, device=x.device)
    if x.dtype == torch.bfloat16:
        wpk = pack_mma_weights(k).contiguous()
        bp = F.pad(b, (0, -(-cout // N_BLOCK) * N_BLOCK - cout)).contiguous()
        vec = int(cin % 8 == 0 and x.data_ptr() % 16 == 0)
        _launch(
            "ecseg_convt_mma", x.device, x.data_ptr(), wpk.data_ptr(), bp.data_ptr(), out.data_ptr(),
            n, h, w, cin, cout, -(-cin // K_CHUNK), vec,
        )
    else:
        k, b = k.contiguous(), b.contiguous()
        _launch("ecseg_convt", x.device, x.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, cin, cout)
    count_launch("convt")
    return out
