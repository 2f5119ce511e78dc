"""Minimal PNG reader/writer (numpy + zlib) for 8-bit images.

Covers what the dataset contract and the artifact writers use:
non-interlaced, bit depth 8, gray / gray+alpha / RGB / RGBA, any of the
five scanline filters on read.  The writer emits filter 0 (None) rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (bit depth 8 only).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, image) -> None:
    """Write a (H, W) gray or (H, W, C) C ∈ {1, 2, 3, 4} uint8 image."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png expects uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:        # Sub: running sum along each channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:        # Up
            cur = (line + prev) & 255
        elif ftype in (3, 4):   # Average / Paeth: sequential along the row
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    pred = _paeth(left, up, upleft)
                left = (cur[x:x + bpp] + pred) & 255
                cur[x:x + bpp] = left
                upleft = up
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG as (H, W) or (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = hdr
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"color type {color_type}, interlace {interlace})")
    c = _CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img
