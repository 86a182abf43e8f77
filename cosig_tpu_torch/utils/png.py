"""Minimal dependency-free PNG writer/reader (RGB/RGBA, 8-bit).

Replaces the reference's ``Texture2D.EncodeToPNG`` + ``File.WriteAllBytes``
(RayTracer.cs:504-509). Framebuffers in this framework store row 0 at the
*bottom* (Unity texture convention); PNG stores rows top-down, so writers
flip — the same flip the reference's GIF encoder performs
(GifGenerator.cs:360-368).

The port's copy of :mod:`cosig_tpu.utils.png` (the same bytes).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp a float image in [0,1] to uint8 (matches ARGB32 quantization)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray, flip_vertical: bool = True) -> None:
    """Write an [H, W, 3|4] image (float in [0,1] or uint8) as PNG."""
    arr = to_uint8(img)
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    if flip_vertical:
        arr = arr[::-1]
    h, w, c = arr.shape
    color_type = {3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    data = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str, flip_vertical: bool = True) -> np.ndarray:
    """Read an 8-bit RGB/RGBA/grayscale PNG into [H, W, C] uint8 (no
    interlace support). Used by the compare tool to load reference images."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        tag = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", data
            )
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNGs supported")
        elif tag == b"IDAT":
            idat += data
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], dtype=np.uint8).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for i in range(channels, stride):
                line[i] = (line[i] + line[i - channels]) & 0xFF
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            for i in range(stride):
                left = int(line[i - channels]) if i >= channels else 0
                line[i] = (line[i] + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - channels]) if i >= channels else 0
                b = int(prev[i])
                c = int(prev[i - channels]) if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        out[y] = line
        prev = line
    img = out.reshape(h, w, channels)
    if flip_vertical:
        img = img[::-1]
    return img
