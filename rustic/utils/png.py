"""PNG encode/decode on the standard library's zlib.

Covers what scene textures and rendered frames use: 8- and 16-bit
grayscale, gray+alpha, RGB, RGBA and 8-bit palette images, all five
scanline filters, no interlacing. Other images (interlaced PNGs, JPEG)
go through Pillow, an optional dependency.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class UnsupportedPNG(ValueError):
    """A valid PNG this codec does not decode (Pillow does)."""


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def encode_png(image: np.ndarray) -> bytes:
    """[H, W], [H, W, 1|2|3|4] uint8 -> PNG bytes (filter 0 on every row)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1
    )
    return (
        _SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> [h, stride] uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum over pixels, per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential in x
            cur_b = bytearray(stride)
            up = prev.tolist()
            src = line.tolist()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_b[i] = (src[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8).astype(np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 (C = 1, 2, 3 or 4; a palette image
    becomes RGB or RGBA). 16-bit samples keep their high byte."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    palette = alpha = None
    header = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    if (
        interlace
        or color_type not in _CHANNELS
        or depth not in (8, 16)
        or (color_type == 3 and depth != 8)
    ):
        raise UnsupportedPNG(
            f"PNG (depth {depth}, color type {color_type}, interlace "
            f"{interlace}) needs Pillow (pip install pillow)"
        )
    channels = _CHANNELS[color_type]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    img = rows.reshape(h, w, channels * depth // 8)
    if depth == 16:
        img = img[..., 0::2]  # big-endian: high bytes
    if color_type == 3:
        idx = img[..., 0]
        rgb = palette[idx]
        if alpha is None:
            return rgb
        a = np.full(len(palette), 255, np.uint8)
        a[: len(alpha)] = alpha
        return np.concatenate([rgb, a[idx][..., None]], axis=-1)
    return np.ascontiguousarray(img)


def to_rgba_float(img: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8 -> float32 [H, W, 4] in [0, 1] (gray expands to
    RGB, a missing alpha is 1), as Pillow's convert("RGBA") does."""
    c = img.shape[-1]
    if c in (1, 2):
        rgb = np.repeat(img[..., :1], 3, axis=-1)
        a = img[..., 1:2] if c == 2 else None
    else:
        rgb = img[..., :3]
        a = img[..., 3:4] if c == 4 else None
    if a is None:
        a = np.full(img.shape[:-1] + (1,), 255, np.uint8)
    return np.concatenate([rgb, a], axis=-1).astype(np.float32) / 255.0


def read_image_rgba(data: bytes) -> np.ndarray:
    """Encoded image bytes -> float32 [H, W, 4] in [0, 1]. PNG is decoded
    here; other formats (JPEG) need Pillow."""
    if data[:8] == _SIGNATURE:
        try:
            return to_rgba_float(decode_png(data))
        except UnsupportedPNG:
            pass
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding this image (JPEG, or an interlaced or low-bit PNG) "
            "needs Pillow: pip install pillow"
        ) from e
    import io

    pil = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(pil, np.float32) / 255.0
