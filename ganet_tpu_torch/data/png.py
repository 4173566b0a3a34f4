"""PNG reading and writing with the standard library's zlib and numpy.

The counterpart of `ganet_tpu/data/kitti_io.py`, which uses Pillow; the
port's machines need not have Pillow.  KITTI stores disparity as a 16-bit
gray PNG whose value is disparity * 256, 0 meaning no ground truth.

Reads non-interlaced files of these kinds: 8-bit RGB, 8-bit RGBA (alpha is
dropped), 8-bit gray and 16-bit gray (big-endian samples), with any of the
five row filters.  An interlaced, palette, gray-with-alpha, 16-bit colour or
sub-byte file raises `ValueError`, never a wrong image.

Filters None, Sub and Up depend on the row above or on the pixel to the
left only linearly, so such rows are undone one row a step in whole-row
operations (Sub as a running sum along the row).  Average and Paeth are
sequential along a row.  A file with any such row is reconstructed as one
wavefront: the image is skewed, row y moved right by y, so that pixel
(y, x) lies in column y + x, and column t depends only on columns t - 1
(its left and upper neighbours) and t - 2 (its upper left).  H + W - 1
vectorised steps over all rows at once, whatever filter each row uses.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (colour type, bit depth) -> samples a pixel.
_KINDS = {(2, 8): 3, (6, 8): 4, (0, 8): 1, (0, 16): 1}


def png_size(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG file, from its header alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def read_png(path: str) -> np.ndarray:
    """The samples of a PNG file: uint8 (H, W, 3) or (H, W, 4) for RGB and
    RGBA, uint8 (H, W) for 8-bit gray, uint16 (H, W) for 16-bit gray."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if colour == 3:
        raise ValueError(f"{path}: palette PNG is not supported")
    channels = _KINDS.get((colour, depth))
    if channels is None:
        raise ValueError(
            f"{path}: unsupported PNG (colour type {colour}, {depth}-bit); this reader takes"
            " 8-bit RGB, RGBA or gray and 16-bit gray"
        )
    bpp = channels * depth // 8  # bytes a pixel
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = width * bpp
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG data")
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    filters = rows[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    pixels = _unfilter(rows[:, 1:].reshape(height, width, bpp), filters)
    if depth == 16:
        out = (pixels[..., 0].astype(np.uint16) << 8) | pixels[..., 1]
        return out
    return pixels[..., 0] if channels == 1 else pixels


def _unfilter(filt: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the row filters of (H, W, bpp) filtered bytes (see the module
    docstring)."""
    if filters.max(initial=0) <= 2:
        return _unfilter_rows(filt, filters)
    return _unfilter_wavefront(filt, filters)


def _unfilter_rows(filt: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo filters None (0), Sub (1) and Up (2), one row a step.  uint8
    sums wrap mod 256, as the filters' own sums do."""
    out = np.empty_like(filt)
    prev = np.zeros_like(filt[0])
    for y, f in enumerate(filters):
        if f == 1:
            out[y] = np.cumsum(filt[y], axis=0, dtype=np.uint8)
        elif f == 2:
            out[y] = filt[y] + prev
        else:
            out[y] = filt[y]
        prev = out[y]
    return out


def _unfilter_wavefront(filt: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo any of the five filters, one anti-diagonal of pixels a step."""
    H, W, bpp = filt.shape
    skew = np.zeros((H, W + H, bpp), np.int16)  # reconstructed, row y at columns y .. y + W - 1
    fs = np.zeros((H, W + H, bpp), np.int16)
    ys = np.arange(H)
    cols = ys[:, None] + np.arange(W)[None, :]
    fs[ys[:, None], cols] = filt
    ft = filters.astype(np.int16)[:, None]
    for t in range(W + H - 1):
        lo, hi = max(0, t - W + 1), min(H - 1, t)
        y = slice(lo, hi + 1)
        a = skew[y, t - 1] if t >= 1 else np.zeros((hi - lo + 1, bpp), np.int16)
        if lo == 0:  # row 0 has no row above
            up = slice(0, hi)
            b = np.concatenate([np.zeros((1, bpp), np.int16), skew[up, t - 1]]) if t >= 1 else a * 0
            c = np.concatenate([np.zeros((1, bpp), np.int16), skew[up, t - 2]]) if t >= 2 else a * 0
        else:
            up = slice(lo - 1, hi)
            b = skew[up, t - 1]
            c = skew[up, t - 2]
        f = ft[y]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        skew[y, t] = (fs[y, t] + pred) & 0xFF
    return skew[ys[:, None], cols].astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (
        struct.pack(">I", len(body)) + kind + body
        + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    )


def _filter_rows(raw: np.ndarray, bpp: int, row_filters) -> np.ndarray:
    """The filtered rows of (H, stride) raw bytes, each led by its filter
    type: row y takes `row_filters[y % len(row_filters)]`.  Each filter
    predicts from the raw bytes, so every row is filtered at once."""
    kinds = np.asarray(row_filters, np.uint8)
    if kinds.size == 0 or kinds.max() > 4:
        raise ValueError(f"row filters must be PNG filter types 0-4, got {tuple(row_filters)}")
    f = kinds[np.arange(raw.shape[0]) % kinds.size]
    x = raw.astype(np.int16)
    a = np.zeros_like(x)  # the byte a pixel to the left
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)  # the byte above
    b[1:] = x[:-1]
    c = np.zeros_like(x)  # above and to the left
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    fc = f[:, None]
    pred = np.select([fc == 1, fc == 2, fc == 3, fc == 4], [a, b, (a + b) >> 1, paeth], 0)
    body = ((x - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([f[:, None], body], axis=1)


def write_png(path: str, image: np.ndarray, row_filters=(2,)) -> None:
    """Write uint8 (H, W, 3), (H, W, 4) or (H, W), or uint16 (H, W), as a
    non-interlaced PNG, row y with the filter `row_filters[y %
    len(row_filters)]` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); by
    default every row with Up."""
    image = np.asarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        colour, depth, bpp = 0, 16, 2
        raw = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
    elif image.dtype == np.uint8 and image.ndim in (2, 3):
        channels = 1 if image.ndim == 2 else image.shape[2]
        colour = {1: 0, 3: 2, 4: 6}.get(channels)
        if colour is None:
            raise ValueError(f"cannot write a PNG of shape {image.shape}")
        depth, bpp = 8, channels
        raw = np.ascontiguousarray(image).reshape(image.shape[0], -1)
    else:
        raise ValueError(f"cannot write a PNG of {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    rows = _filter_rows(raw, bpp, row_filters)
    header = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", header))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_image(path: str) -> np.ndarray:
    """An image as float32 (H, W, 3) in [0, 255], as Pillow's
    `convert("RGB")` gives it: alpha dropped, gray repeated over the three
    channels, 16-bit gray clipped to 255."""
    img = read_png(path)
    if img.ndim == 2:
        img = np.repeat(np.minimum(img, 255)[..., None], 3, axis=2)
    return img[..., :3].astype(np.float32)


def read_disparity_png(path: str) -> np.ndarray:
    """A KITTI disparity PNG (gray, value = disparity * 256) as float32
    (H, W) in pixels; 0 (no ground truth) stays 0."""
    arr = read_png(path)
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected single-channel disparity PNG")
    return arr.astype(np.float32) / 256.0


def write_disparity_png(path: str, disparity: np.ndarray) -> None:
    """A disparity map (H, W) as a KITTI-submission uint16 PNG: disparity *
    256, clipped to [0, 65535] and truncated, as the JAX package writes it."""
    arr = np.clip(np.asarray(disparity, dtype=np.float32) * 256.0, 0, 65535)
    write_png(path, arr.astype(np.uint16))
