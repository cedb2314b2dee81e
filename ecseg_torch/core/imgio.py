"""Image I/O without OpenCV: a baseline TIFF reader/writer, a PNG writer and
the reference's channel-order and rounding semantics
(twin of ``ecseg_tpu/core/imgio.py``).

- :func:`imread_rgb` gives what ``skimage.io.imread`` gives the reference
  (native dtype, RGB order; reference src/utils.py:110).  Uncompressed
  strip TIFFs (uint8/uint16, gray, RGB or RGBA, either byte order) are
  decoded here; any other file (compressed, tiled, palette, ...) is handed to
  OpenCV, imported only then, with a clear error naming the file when it is
  not installed.
- :func:`save_label_png` writes the metaseg palette PNG with ``zlib``; the
  contract is pixel-level (the decoded colours), as in the JAX package.
- :func:`save_gray_inverted` writes the ``dapi/`` image as an uncompressed
  TIFF (the JAX package's default encoding too).
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from typing import List

import numpy as np

# --------------------------------------------------------------------------
# TIFF
# --------------------------------------------------------------------------

_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q"}  # BYTE, SHORT, LONG, LONG8


def _tiff_tags(buf: bytes, bo: str, ifd: int) -> dict:
    (n,) = struct.unpack_from(bo + "H", buf, ifd)
    tags = {}
    for k in range(n):
        tag, typ, count = struct.unpack_from(bo + "HHI", buf, ifd + 2 + 12 * k)
        fmt = _TIFF_TYPES.get(typ)
        if fmt is None:
            continue  # ASCII / RATIONAL tags carry nothing the decoder needs
        size = struct.calcsize(fmt) * count
        off = ifd + 2 + 12 * k + 8
        if size > 4:
            (off,) = struct.unpack_from(bo + "I", buf, off)
        tags[tag] = struct.unpack_from(bo + fmt * count, buf, off)
    return tags


def _decode_tiff(buf: bytes):
    """Decoded array of a baseline uncompressed strip TIFF, or ``None``
    when the file needs a full decoder."""
    if buf[:4] == b"II*\x00":
        bo = "<"
    elif buf[:4] == b"MM\x00*":
        bo = ">"
    else:
        return None
    (ifd,) = struct.unpack_from(bo + "I", buf, 4)
    t = _tiff_tags(buf, bo, ifd)
    w, h = t[256][0], t[257][0]
    spp = t.get(277, (1,))[0]
    bps = set(t.get(258, (1,)))
    photometric = t.get(262, (None,))[0]
    plain = (
        t.get(259, (1,))[0] == 1  # no compression
        and t.get(284, (1,))[0] == 1  # chunky samples
        and t.get(317, (1,))[0] == 1  # no predictor
        and set(t.get(339, (1,))) == {1}  # unsigned integers
        and len(bps) == 1
        and bps <= {8, 16}
        and (spp, photometric) in ((1, 1), (3, 2), (4, 2))
        and 273 in t
        and 279 in t
        and 322 not in t  # not tiled
    )
    if not plain:
        return None
    dtype = np.dtype(np.uint8 if bps == {8} else bo + "u2")
    data = b"".join(
        buf[o : o + c] for o, c in zip(t[273], t[279])
    )[: h * w * spp * dtype.itemsize]
    img = np.frombuffer(data, dtype).astype(dtype.newbyteorder("="))
    return img.reshape((h, w) if spp == 1 else (h, w, spp))


def _imread_cv2(path: str, why: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: {why}; reading it needs OpenCV (cv2), which is not "
            "installed (this package decodes uncompressed strip TIFFs itself)"
        ) from e
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"could not read image: {path}")
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]  # BGR -> RGB
    elif img.ndim == 3 and img.shape[2] == 4:
        img = img[..., [2, 1, 0, 3]]  # BGRA -> RGBA
    return np.ascontiguousarray(img)


def imread_rgb(path: str) -> np.ndarray:
    """Read an image preserving dtype, RGB channel order (skimage semantics)."""
    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as f:
        buf = f.read()
    img = _decode_tiff(buf)
    if img is None:
        return _imread_cv2(path, "not an uncompressed strip TIFF")
    return img


def write_tiff(path: str, img: np.ndarray) -> None:
    """Baseline little-endian uncompressed TIFF, one strip: uint8/uint16,
    gray (H, W) or RGB (H, W, 3)."""
    img = np.ascontiguousarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_tiff takes uint8/uint16, got {img.dtype}")
    if img.ndim == 2:
        spp, photometric = 1, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        spp, photometric = 3, 2
    else:
        raise ValueError(f"write_tiff takes (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    bits = 8 * img.dtype.itemsize
    data = img.astype(img.dtype.newbyteorder("<")).tobytes()
    n_tags = 10
    extra = 8 + 2 + 12 * n_tags + 4  # first byte after the IFD
    bps_off = extra
    if spp > 2:  # the BitsPerSample array no longer fits in the entry
        extra += 2 * spp
    data_off = extra
    entries = [
        (256, 4, 1, w),
        (257, 4, 1, h),
        (258, 3, spp, bits if spp <= 2 else bps_off),
        (259, 3, 1, 1),
        (262, 3, 1, photometric),
        (273, 4, 1, data_off),
        (277, 3, 1, spp),
        (278, 4, 1, h),
        (279, 4, 1, len(data)),
        (284, 3, 1, 1),
    ]
    out = [b"II", struct.pack("<HI", 42, 8), struct.pack("<H", n_tags)]
    for tag, typ, count, value in entries:
        inline = typ == 3 and count == 1
        val = struct.pack("<HH", value, 0) if inline else struct.pack("<I", value)
        out.append(struct.pack("<HHI", tag, typ, count) + val)
    out.append(struct.pack("<I", 0))  # no next IFD
    if spp > 2:
        out.append(struct.pack("<" + "H" * spp, *([bits] * spp)))
    out.append(data)
    with open(path, "wb") as f:
        f.write(b"".join(out))


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png_indexed(path: str, index: np.ndarray, palette: np.ndarray) -> None:
    """8-bit palette PNG of an (H, W) uint8 index map; ``palette`` is
    (K, 3) uint8 RGB.  Decoders expand it to the palette colours."""
    h, w = index.shape
    rows = np.zeros((h, w + 1), np.uint8)  # filter byte 0 (None) per row
    rows[:, 1:] = index
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
        + _png_chunk(b"PLTE", np.ascontiguousarray(palette, np.uint8).tobytes())
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


# --------------------------------------------------------------------------
# reference semantics
# --------------------------------------------------------------------------


def u16_to_u8(img: np.ndarray) -> np.ndarray:
    """uint16 -> uint8 with OpenCV ``convertScaleAbs(alpha=255/65535)``
    semantics: round-half-to-even then saturate
    (reference src/image_tools.py:98-101)."""
    if img.dtype == np.uint16:
        scaled = img.astype(np.float64) * (255.0 / 65535.0)
        img = np.clip(np.rint(scaled), 0, 255).astype(np.uint8)
    return img


def get_imgs(inpath: str) -> List[str]:
    """Discover inputs: ``*.tif`` then ``*.npy`` (reference src/utils.py:105-107)."""
    return glob.glob(os.path.join(inpath, "*.tif")) + glob.glob(
        os.path.join(inpath, "*.npy")
    )


# metaseg label-map palette: ListedColormap(['#386cb0','#ffff99','#7fc97f',
# '#f0027f']) applied with vmin=0, vmax=4 (reference src/metaseg.py:47,52).
METASEG_PALETTE_RGB = np.array(
    [
        [0x38, 0x6C, 0xB0],  # 0 background  (#386cb0)
        [0xFF, 0xFF, 0x99],  # 1 nuclei      (#ffff99)
        [0x7F, 0xC9, 0x7F],  # 2 chromosome  (#7fc97f)
        [0xF0, 0x02, 0x7F],  # 3 ecDNA       (#f0027f)
    ],
    dtype=np.uint8,
)


def save_label_png(path: str, labels: np.ndarray) -> None:
    """The colour-mapped label PNG the reference writes with
    ``plt.imsave(..., cmap=ListedColormap(...), vmin=0, vmax=4)``
    (reference src/metaseg.py:47-52); pixel-level contract."""
    idx = np.clip(labels.astype(np.int64), 0, 3).astype(np.uint8)
    write_png_indexed(path, idx, METASEG_PALETTE_RGB)


def save_gray_inverted(path: str, img: np.ndarray) -> None:
    """Write ``255 - img`` as a grayscale TIFF (reference src/utils.py:112,
    src/image_tools.py:143-144), creating the directory."""
    if not path.lower().endswith((".tif", ".tiff")):
        raise IOError(f"failed to write {path}: only .tif outputs are supported")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    write_tiff(path, 255 - np.asarray(img, dtype=np.uint8))
