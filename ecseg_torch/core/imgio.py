"""Image I/O without OpenCV: a baseline TIFF reader/writer, a PNG writer and
the reference's channel-order and rounding semantics
(twin of ``ecseg_tpu/core/imgio.py``).

- :func:`imread_rgb` gives what ``skimage.io.imread`` gives the reference
  (native dtype, RGB order; reference src/utils.py:110).  Strip TIFFs of
  uint8/uint16 samples, gray, RGB or RGBA, chunky, in either byte order,
  uncompressed, LZW (the reference's default; ``csrc/tiff_lzw.cpp``, built
  at first use) or deflate (``zlib``), with or without the horizontal
  predictor, are decoded here; any other file (tiled, planar, float,
  JPEG, PackBits, palette, ...) is handed to OpenCV, imported only then,
  with an error naming the file and what it holds when it is not
  installed.
- :func:`save_label_png` writes the metaseg palette PNG with ``zlib``; the
  contract is pixel-level (the decoded colours), as in the JAX package.
- :func:`save_gray_inverted` writes metaseg's ``dapi/`` image as an
  uncompressed TIFF (the JAX package writes it through ``cv2.imwrite``,
  LZW) and meta_overlay's ``red/`` and ``green/`` images as 8-bit
  grayscale PNGs (``zlib``); the contract is the decoded pixels, not the
  file bytes.
- :func:`imwrite` writes stat_fish's TIFFs uncompressed (the JAX
  package's default) or, under ``ECSEG_TIF_LZW=1``, LZW with the bytes
  ``cv2.imwrite`` writes (:func:`write_tiff_lzw`; the encoder is in
  ``csrc/tiff_lzw.cpp``).
"""

from __future__ import annotations

import ctypes
import functools
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


_COMPRESSIONS = {1: "none", 5: "LZW", 8: "deflate", 32946: "deflate"}


def _tiff_header(buf: bytes):
    """(byte order, tags of the first IFD), or None for a file that is not
    a TIFF."""
    if buf[:4] == b"II*\x00":
        bo = "<"
    elif buf[:4] == b"MM\x00*":
        bo = ">"
    else:
        return None
    (ifd,) = struct.unpack_from(bo + "I", buf, 4)
    return bo, _tiff_tags(buf, bo, ifd)


def _unsupported(t: dict):
    """Why the decoder here does not take a TIFF with tags ``t``, or None."""
    comp = t.get(259, (1,))[0]
    bps = set(t.get(258, (1,)))
    checks = (
        (comp in _COMPRESSIONS, "a compression not decoded here"),
        (t.get(284, (1,))[0] == 1, "planar samples (tag 284)"),
        (t.get(317, (1,))[0] in (1, 2), f"predictor {t.get(317, (1,))[0]} (tag 317)"),
        (set(t.get(339, (1,))) == {1}, "samples that are not unsigned integers (tag 339)"),
        (len(bps) == 1 and bps <= {8, 16}, f"{sorted(bps)} bits per sample (tag 258)"),
        ((t.get(277, (1,))[0], t.get(262, (None,))[0]) in ((1, 1), (3, 2), (4, 2)), "a photometric layout other than gray, RGB or RGBA"),
        (273 in t and 279 in t and 322 not in t, "tiles, not strips"),
    )
    for ok, why in checks:
        if not ok:
            return f"a TIFF with {why}; its compression (tag 259) is {comp}"
    return None


@functools.lru_cache(maxsize=1)
def _lzw_decoder():
    """``ecseg_lzw_decode_strips`` of csrc/tiff_lzw.cpp (built at first use)."""
    from .._build import host_library

    fn = host_library("tiff_lzw.cpp").ecseg_lzw_decode_strips
    p64 = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, p64, p64, ctypes.c_void_p, p64, p64]
    fn.restype = ctypes.c_int
    return fn


def _lzw_strips(buf: bytes, spans, sizes) -> bytes:
    """The LZW strips at ``spans`` (offset, length) of ``buf``, decoded to
    ``sizes`` bytes each."""
    src = np.array(spans, np.int64).reshape(-1, 2)
    src_off, src_len = np.ascontiguousarray(src[:, 0]), np.ascontiguousarray(src[:, 1])
    dst_len = np.array(sizes, np.int64)
    dst_off = np.concatenate([[0], np.cumsum(dst_len)[:-1]]).astype(np.int64)
    out = np.empty(int(dst_len.sum()), np.uint8)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    rc = _lzw_decoder()(buf, len(sizes), ptr(src_off), ptr(src_len), out.ctypes.data, ptr(dst_off), ptr(dst_len))
    if rc:
        raise ValueError(f"LZW strip {rc - 1} is malformed or decodes to fewer than {sizes[rc - 1]} bytes")
    return out.tobytes()


def _decode_tiff(buf: bytes):
    """Decoded array of a strip TIFF the decoder here takes (see the module
    docstring), or ``None`` when the file needs a full decoder."""
    head = _tiff_header(buf)
    if head is None or _unsupported(head[1]):
        return None
    bo, t = head
    w, h = t[256][0], t[257][0]
    spp = t[277][0] if 277 in t else 1
    dtype = np.dtype(np.uint8 if t[258][0] == 8 else bo + "u2")
    row = w * spp * dtype.itemsize
    rps = max(1, min(t.get(278, (h,))[0], h))
    spans = [(o, c) for o, c in zip(t[273], t[279])][: -(-h // rps)]
    if any(o + c > len(buf) for o, c in spans):
        raise ValueError("a TIFF strip runs past the end of the file")
    sizes = [row * min(rps, h - k * rps) for k in range(len(spans))]
    comp = t.get(259, (1,))[0]
    if comp == 1:
        data = b"".join(buf[o : o + min(c, n)] for (o, c), n in zip(spans, sizes))
    elif comp == 5:
        data = _lzw_strips(buf, spans, sizes)
    else:
        data = b"".join(zlib.decompress(buf[o : o + c])[:n] for (o, c), n in zip(spans, sizes))
    if len(data) < h * row:
        raise ValueError(f"the TIFF's strips hold {len(data)} bytes, not the {h * row} of a {h}x{w}x{spp} image")
    img = np.frombuffer(data[: h * row], dtype).astype(dtype.newbyteorder("=")).reshape(h, w, spp)
    if t.get(317, (1,))[0] == 2:  # horizontal differencing, per row and sample
        img = np.cumsum(img, axis=1, dtype=img.dtype)
    return img[..., 0] if spp == 1 else img


def _imread_cv2(path: str, why: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: {why}; reading it needs OpenCV (cv2), which is not "
            "installed (this package decodes uncompressed, LZW and deflate "
            "strip TIFFs itself)"
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
    try:
        img = _decode_tiff(buf)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    if img is None:
        head = _tiff_header(buf)
        return _imread_cv2(path, "not a TIFF" if head is None else _unsupported(head[1]))
    return img


def imread_bgr8(path: str) -> np.ndarray:
    """What ``cv2.imread(path)`` (IMREAD_COLOR) gives stat_fish (reference
    src/stat_fish.py:207): 8-bit, three channels, BGR.  Gray becomes three
    equal channels and alpha is dropped.  16-bit samples become 8-bit as
    OpenCV's TIFF reader makes them, which differs by layout: a gray
    sample's high byte (``x >> 8``), a colour sample rounded to nearest
    (``rint(x / 257)``); both pinned against cv2 in
    tests/test_torch_stat_fish.py.  A ``.npy`` input is returned as
    stored, as the JAX package loads it."""
    if path.endswith(".npy"):
        return np.load(path)
    img = imread_rgb(path)
    if img.dtype == np.uint16:
        if img.ndim == 2:
            img = (img >> 8).astype(np.uint8)
        else:
            img = np.rint(img / 257.0).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def tif_lzw() -> bool:
    """``ECSEG_TIF_LZW``, parsed as the JAX package parses it
    (``ecseg_tpu/core/imgio.py:57-59``)."""
    return os.environ.get("ECSEG_TIF_LZW", "0").strip().lower() in ("1", "true", "yes", "on")


def imwrite(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite`` of an (H, W) or BGR (H, W, 3) uint8/uint16 array to a
    TIFF that holds RGB, as OpenCV writes it: uncompressed (the JAX
    package's ``imgio.imwrite`` default, whose contract is the decoded
    pixels), or, under ``ECSEG_TIF_LZW=1`` with a ``.tif``/``.tiff`` path,
    LZW as cv2's default encoding (:func:`write_tiff_lzw`).  A failed write
    raises."""
    img = np.asarray(img)
    rgb = img[..., ::-1] if img.ndim == 3 else img
    if tif_lzw() and path.lower().endswith((".tif", ".tiff")):
        write_tiff_lzw(path, rgb)
    else:
        write_tiff(path, rgb)


def _layout(img: np.ndarray):
    """(samples per pixel, photometric) of a uint8/uint16 gray or RGB image."""
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"a TIFF is written from uint8/uint16, got {img.dtype}")
    if img.ndim == 2:
        return 1, 1
    if img.ndim == 3 and img.shape[2] == 3:
        return 3, 2
    raise ValueError(f"a TIFF is written from (H, W) or (H, W, 3), got {img.shape}")


@functools.lru_cache(maxsize=1)
def _lzw_encoder():
    """``ecseg_lzw_encode_strips`` of csrc/tiff_lzw.cpp (built at first use)."""
    from .._build import host_library

    fn = host_library("tiff_lzw.cpp").ecseg_lzw_encode_strips
    p64 = ctypes.POINTER(ctypes.c_int64)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, p64, p64, ctypes.c_void_p, p64, p64]
    fn.restype = None
    return fn


LZW_STRIP_BYTES = 1 << 13  # OpenCV's strip size target: rows per strip = max(1, 8192 // row bytes)


def write_tiff_lzw(path: str, img: np.ndarray) -> None:
    """A little-endian strip TIFF of a uint8/uint16 gray (H, W) or RGB
    (H, W, 3) image, LZW (``csrc/tiff_lzw.cpp``) with the horizontal
    predictor, laid out as OpenCV's libtiff writes ``cv2.imwrite``'s default
    TIFF: its rows per strip, the strips from byte 8, the IFD after them on
    an even offset (tags 256-279, 284, 317, 339; each type as libtiff
    picks it), then the values that do not fit an entry (bits per sample,
    strip byte counts, strip offsets, sample formats).  The file's bytes
    equal cv2's (tests/test_torch_tiff.py)."""
    img = np.ascontiguousarray(img)
    spp, photometric = _layout(img)
    h, w = img.shape[:2]
    diff = img.copy()
    diff[:, 1:] -= img[:, :-1]  # wraps, as the predictor's differences do
    raw = np.ascontiguousarray(diff.astype(img.dtype.newbyteorder("<")))
    row = w * spp * img.dtype.itemsize
    rps = max(1, min(h, LZW_STRIP_BYTES // row))
    starts = np.arange(0, h, rps, dtype=np.int64)
    src_len = np.minimum(rps, h - starts) * row
    src_off = starts * row
    cap = 2 * src_len + 64
    dst_off = np.concatenate([[0], np.cumsum(cap)[:-1]]).astype(np.int64)
    dst = np.empty(int(cap.sum()), np.uint8)
    dst_len = np.zeros(len(starts), np.int64)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    _lzw_encoder()(raw.ctypes.data, len(starts), ptr(src_off), ptr(src_len), dst.ctypes.data, ptr(dst_off), ptr(dst_len))
    strips = [dst[o : o + n].tobytes() for o, n in zip(dst_off, dst_len)]
    offsets = np.concatenate([[8], 8 + np.cumsum(dst_len)[:-1]]).astype(np.int64)
    ifd = 8 + int(dst_len.sum())
    ifd += ifd % 2
    n_tags = 12
    extra = ifd + 2 + 12 * n_tags + 4  # the first byte after the IFD
    short = lambda v: 3 if v <= 0xFFFF else 4
    pack = lambda typ, vals: struct.pack("<" + ("H" if typ == 3 else "I") * len(vals), *vals)
    # libtiff writes several strips' byte counts as SHORT when an LZW strip
    # of rps rows could not pass 65535 bytes at 10x its raw size
    counts_type = 3 if len(starts) > 1 and rps * row < 0xFFFF // 10 else 4
    values = {  # tag -> (type, values); SHORT (3) or LONG (4)
        256: (short(w), [w]), 257: (short(h), [h]), 258: (3, [8 * img.dtype.itemsize] * spp), 259: (3, [5]),
        262: (3, [photometric]), 273: (4, offsets.tolist()), 277: (3, [spp]), 278: (short(rps), [rps]),
        279: (counts_type, dst_len.tolist()), 284: (3, [1]), 317: (3, [2]), 339: (3, [1] * spp),
    }
    fields, tail = {}, []
    for tag in (258, 279, 273, 339):  # libtiff's order for values past the entry
        data = pack(*values[tag])
        if len(data) > 4:
            fields[tag] = struct.pack("<I", extra)
            tail.append(data)
            extra += len(data)
    out = [b"II", struct.pack("<HI", 42, ifd), *strips, b"\0" * (ifd - 8 - int(dst_len.sum())), struct.pack("<H", n_tags)]
    for tag in sorted(values):
        typ, vals = values[tag]
        field = fields.get(tag) or pack(typ, vals).ljust(4, b"\0")
        out.append(struct.pack("<HHI", tag, typ, len(vals)) + field)
    out.append(struct.pack("<I", 0))  # no next IFD
    with open(path, "wb") as f:
        f.write(b"".join(out + tail))


def write_tiff(path: str, img: np.ndarray) -> None:
    """Baseline little-endian uncompressed TIFF, one strip: uint8/uint16,
    gray (H, W) or RGB (H, W, 3)."""
    img = np.ascontiguousarray(img)
    spp, photometric = _layout(img)
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


def write_png_gray(path: str, img: np.ndarray) -> None:
    """8-bit grayscale PNG (colour type 0) of an (H, W) uint8 image."""
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)  # filter byte 0 (None) per row
    rows[:, 1:] = img
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
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
    """Write ``255 - img`` as a grayscale TIFF or, for a ``.png`` path, PNG
    (reference src/utils.py:112, src/image_tools.py:143-144), creating the
    directory."""
    lower = path.lower()
    if lower.endswith((".tif", ".tiff")):
        write = write_tiff
    elif lower.endswith(".png"):
        write = write_png_gray
    else:
        raise IOError(f"failed to write {path}: only .tif and .png outputs are supported")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    write(path, 255 - np.asarray(img, dtype=np.uint8))
