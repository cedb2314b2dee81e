"""skimage-compatible resize / rescale on scipy.ndimage (host), plus the
device resize of the NuSeT cleanup pass (twin of ``ecseg_tpu/ops/resize.py``).

The reference uses ``skimage.transform.rescale``/``resize``
(reference src/utils.py:135-136,156-157; src/interseg.py:46,154).  skimage
implements these on ``scipy.ndimage.zoom(grid_mode=True)`` with an optional
gaussian anti-aliasing prefilter; we reproduce that directly (skimage itself
is not a dependency):

- mode names are numpy.pad-style and map onto scipy.ndimage modes
  ('reflect' -> 'mirror', 'symmetric' -> 'reflect', 'edge' -> 'nearest');
- ``preserve_range=False`` first converts integer images to float via
  img_as_float (divide by dtype max);
- anti-aliasing sigma per axis: ``max(0, (downscale_factor - 1) / 2)``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage as ndi

_NDI_MODE = {
    "reflect": "mirror",
    "symmetric": "reflect",
    "edge": "nearest",
    "constant": "constant",
    "wrap": "grid-wrap",
}


def img_as_float(image: np.ndarray) -> np.ndarray:
    if np.issubdtype(image.dtype, np.floating):
        return image
    info = np.iinfo(image.dtype)
    if info.min < 0:
        raise NotImplementedError("signed integer images not supported")
    return image.astype(np.float64) / info.max


def resize(
    image: np.ndarray,
    output_shape: Sequence[int],
    order: int = 1,
    mode: str = "reflect",
    cval: float = 0.0,
    clip: bool = True,
    preserve_range: bool = False,
    anti_aliasing: Optional[bool] = None,
    anti_aliasing_sigma=None,
) -> np.ndarray:
    image = np.asarray(image)
    output_shape = tuple(output_shape)
    # Trailing (e.g. channel) axes not covered by output_shape keep their size.
    if len(output_shape) < image.ndim:
        output_shape = output_shape + image.shape[len(output_shape) :]

    input_shape = image.shape
    factors = np.divide(input_shape, output_shape)

    if anti_aliasing is None:
        anti_aliasing = (
            not image.dtype == bool
            and not (np.issubdtype(image.dtype, np.integer) and order == 0)
            and any(x < y for x, y in zip(output_shape, input_shape))
        )

    if not preserve_range:
        image = img_as_float(image)
    else:
        image = image.astype(np.float64)

    ndi_mode = _NDI_MODE.get(mode, mode)
    if anti_aliasing:
        if anti_aliasing_sigma is None:
            anti_aliasing_sigma = np.maximum(0, (factors - 1) / 2)
        filtered = ndi.gaussian_filter(
            image, anti_aliasing_sigma, cval=cval, mode=ndi_mode
        )
    else:
        filtered = image

    zoom_factors = [1 / f for f in factors]
    out = ndi.zoom(
        filtered, zoom_factors, order=order, mode=ndi_mode, cval=cval, grid_mode=True
    )
    if clip:
        out = np.clip(out, image.min(), image.max())
    return out


def rescale(
    image: np.ndarray,
    scale: float,
    order: int = 1,
    mode: str = "reflect",
    cval: float = 0.0,
    clip: bool = True,
    preserve_range: bool = False,
    anti_aliasing: Optional[bool] = None,
) -> np.ndarray:
    """skimage.transform.rescale for 2-D images (reference src/utils.py:136,157)."""
    image = np.asarray(image)
    output_shape = tuple(
        int(d) for d in np.maximum(np.round(np.multiply(image.shape[:2], scale)), 1)
    )
    return resize(
        image,
        output_shape,
        order=order,
        mode=mode,
        cval=cval,
        clip=clip,
        preserve_range=preserve_range,
        anti_aliasing=anti_aliasing,
    )


def _zoom_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) order-1 interpolation operator reproducing
    ``ndi.zoom(..., order=1, mode='mirror', grid_mode=True)`` exactly:
    half-pixel sample centers, linear weights, mirror boundary
    (index -1 -> 1, n -> n-2)."""
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(coords).astype(np.int64)
    frac = coords - lo

    def mirror(i):
        i = np.where(i < 0, -i, i)
        if n_in > 1:
            i = np.where(i >= n_in, 2 * (n_in - 1) - i, i)
        else:
            i = np.zeros_like(i)
        return i

    W = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    np.add.at(W, (rows, mirror(lo)), 1.0 - frac)
    np.add.at(W, (rows, mirror(lo + 1)), frac)
    return W


def _mirror_index(i: np.ndarray, n: int) -> np.ndarray:
    """ndi's 'mirror' extension of indices ``i`` into ``range(n)``
    (d c b | a b c d | c b a, repeated for any reach)."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def _gaussian_matrix(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """(n, n) operator of ``ndi.gaussian_filter1d(x, sigma, mode='mirror')``
    along one axis: scipy's kernel (radius ``int(truncate * sigma + 0.5)``,
    weights normalized to sum 1) on mirrored indices.  The identity where
    scipy skips the axis (sigma <= 1e-15)."""
    if sigma <= 1e-15:
        return np.eye(n)
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    phi = phi / phi.sum()
    G = np.zeros((n, n), np.float64)
    rows = np.arange(n)
    for k, wk in zip(x, phi):
        np.add.at(G, (rows, _mirror_index(rows + k, n)), wk)
    return G


@functools.lru_cache(maxsize=8)
def _rescale_operators(shape: Tuple[int, int], scale: float, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 (out, in) operators of :func:`rescale`'s anti-aliased
    order-1 resize along each axis, on ``device``: the zoom after the
    gaussian prefilter, ``_zoom_matrix(n_in, n_out) @ _gaussian_matrix``."""
    out_shape = tuple(int(d) for d in np.maximum(np.round(np.multiply(shape, scale)), 1))
    ops = []
    for n_in, n_out in zip(shape, out_shape):
        sigma = max(0.0, (n_in / n_out - 1) / 2)
        ops.append(torch.from_numpy(_zoom_matrix(n_in, n_out) @ _gaussian_matrix(n_in, sigma)).to(device))
    return ops[0], ops[1]


def rescale_device(image: torch.Tensor, scale: float) -> torch.Tensor:
    """:func:`rescale` of a 2-D uint8 image with ``anti_aliasing=True``, on
    the image's device in float64: ``img_as_float``, the gaussian prefilter
    (sigma ``(in / out - 1) / 2`` per axis, truncate 4.0, 'mirror'),
    ``ndi.zoom(order=1, grid_mode=True, mode='mirror')`` and the clip to
    the input's range.  The prefilter and the zoom are linear, so each axis
    is one operator and the resize is ``Ay @ x @ Ax^T``; it differs from
    scipy's sequential passes only in the order of the float64 sums.  A
    scale above 1 (no prefilter) is left to the host."""
    if scale > 1:
        raise ValueError("rescale_device downscales; a scale above 1 runs on the host")
    if image.dtype != torch.uint8:
        raise TypeError(f"rescale_device takes a uint8 image, not {image.dtype}")
    x = image.double() / 255.0
    ay, ax = _rescale_operators(tuple(image.shape), float(scale), str(image.device))
    out = (ay @ x) @ ax.T
    return torch.minimum(torch.maximum(out, x.min()), x.max())


def resize_linear_matmul(image: torch.Tensor, output_shape: Tuple[int, int]) -> torch.Tensor:
    """Device twin of :func:`resize` (order 1, mode 'reflect' -> ndi
    'mirror', no anti-aliasing) as two float32 matmuls with exact zoom
    operators: ``Wy @ image @ Wx^T``.  The JAX package pins
    ``Precision.HIGHEST`` here (``resize.py:160-177``): reduced-precision
    weights move the result ~1e-3 and flip pixels at the cleanup pass's
    exact binarize cutoff.  On the card that is TF32, so this raises when
    PyTorch's TF32 matmuls are on."""
    if image.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("resize_linear_matmul needs full float32 matmuls: torch.backends.cuda.matmul.allow_tf32 is set")
    h_in, w_in = image.shape
    h_out, w_out = output_shape
    wy = torch.from_numpy(_zoom_matrix(h_in, h_out).astype(np.float32)).to(image.device)
    wx = torch.from_numpy(_zoom_matrix(w_in, w_out).astype(np.float32)).to(image.device)
    return (wy @ image.float()) @ wx.T
