"""Minimal dependency-free PNG writer (zlib + struct).

Replaces the reference's use of ``libfive::Heightmap::savePNG``
(reference/benchmark/render_2d_table.cpp:63) for benchmark artifacts.
Supports 8-bit grayscale, RGB and RGBA.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write ``img`` as PNG (:func:`encode_png`)."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray) -> bytes:
    """``img`` as the bytes of a PNG file.

    (H, W) uint8/bool -> grayscale; (H, W, 3) uint8 -> RGB; (H, W, 4)
    uint8 -> RGBA.  Row 0 is the TOP of the image (PNG convention); render
    code that uses y-up should flip before saving.
    """
    img = np.asarray(img)
    if img.dtype == bool:
        img = img.astype(np.uint8) * 255
    elif img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        color_type = 0
        raw = img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 4:
        color_type = 6
        raw = img
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        raw = img
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = raw.shape[:2]
    # filter byte 0 per scanline
    lines = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw.reshape(h, -1)], axis=1)
    data = zlib.compress(lines.tobytes(), 6)
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                       0, 0, 0))
    out += _chunk(b"IDAT", data)
    out += _chunk(b"IEND", b"")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode what :func:`encode_png` makes (8-bit grayscale, RGB or RGBA,
    filter 0 on every row): (H, W) or (H, W, channels) uint8."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    w = h = ch = None
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack_from(">IIBB", body)
            assert depth == 8 and ctype in (0, 2, 6)
            ch = {0: 1, 2: 3, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    raw = zlib.decompress(idat)
    arr = np.frombuffer(raw, np.uint8).reshape(h, w * ch + 1)
    assert np.all(arr[:, 0] == 0), "only filter 0 supported"
    img = arr[:, 1:].reshape(h, w, ch)
    return (img[:, :, 0] if ch == 1 else img).copy()


def read_png_gray(path: str) -> np.ndarray:
    """Tiny grayscale PNG reader (only what write_png produces), for tests."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    assert img.ndim == 2
    return img
