"""Animated-GIF89a export: turntable frame generation + parallel encoder.

Parity reference: ``Assets/Services/GifGenerator.cs``:

* turntable: 36 frames at 10-degree Z-rotation increments of the camera
  rotation override (:40-72);
* GIF89a writer: header/logical screen (:191-199), Netscape infinite-loop
  extension (:204-214), global 256-color palette = 6x6x6 cube + 40 grays
  (:220-249), per-frame graphic-control + image descriptor + 255-byte
  sub-blocks (:258-292);
* GIF-variant LZW with 9->12-bit growing codes (:411-501);
* quantization to the 6x6x6 cube and vertical flip (:346-369);
* per-frame compression parallelism: the reference's Task.Run +
  Parallel.For becomes concurrent.futures (SURVEY.md section 2, item 3).

The port's copy of :mod:`cosig_tpu.utils.gif`. :func:`lzw_compress` runs
the C++ encoder of :mod:`cosig_tpu_torch.native` where it builds and
loads, else :func:`lzw_compress_py`, the specification of the format;
both give the same bytes. The C++ call releases the interpreter lock, so
``save_gif``'s thread pool encodes frames in parallel with it.
"""

from __future__ import annotations

import concurrent.futures
import struct
from typing import Callable, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Palette: 6x6x6 color cube + 40 grays (GifGenerator.cs:220-249)


def color_table() -> bytes:
    table = bytearray()
    for r in range(6):
        for g in range(6):
            for b in range(6):
                table += bytes((r * 51, g * 51, b * 51))
    for i in range(40):
        gray = int(i * 6.5) & 0xFF
        table += bytes((gray, gray, gray))
    return bytes(table)


def quantize(img: np.ndarray, flip_vertical: bool = True) -> np.ndarray:
    """Float [H,W,3] in [0,1] -> palette indices [H,W] uint8 via the 6^3
    cube (GifGenerator.cs:346-369). Row 0 is bottom in our framebuffers;
    GIF stores top-down, so flip by default."""
    q = np.clip((img[..., :3] * 5.99).astype(np.int32), 0, 5)
    idx = (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)
    return idx[::-1] if flip_vertical else idx


# ---------------------------------------------------------------------------
# LZW (GIF variant): 9-bit start, grow to 12, 4096-entry cap
# (GifGenerator.cs:411-501)


def lzw_compress_py(data: bytes, min_code_size: int = 8) -> bytes:
    clear_code = 1 << min_code_size
    end_code = clear_code + 1
    next_code = end_code + 1
    code_size = min_code_size + 1

    table = {bytes([i]): i for i in range(clear_code)}
    out = bytearray()
    bit_buffer = 0
    bit_count = 0

    def write(code: int, size: int):
        nonlocal bit_buffer, bit_count
        bit_buffer |= code << bit_count
        bit_count += size
        while bit_count >= 8:
            out.append(bit_buffer & 0xFF)
            bit_buffer >>= 8
            bit_count -= 8

    write(clear_code, code_size)
    if not data:
        write(end_code, code_size)
        if bit_count:
            out.append(bit_buffer & 0xFF)
        return bytes(out)

    current = bytes([data[0]])
    for byte in data[1:]:
        nxt = current + bytes([byte])
        if nxt in table:
            current = nxt
        else:
            write(table[current], code_size)
            if next_code < 4096:
                table[nxt] = next_code
                if next_code == (1 << code_size):
                    code_size += 1
                next_code += 1
            current = bytes([byte])
    write(table[current], code_size)
    write(end_code, code_size)
    if bit_count:
        out.append(bit_buffer & 0xFF)
    return bytes(out)


def lzw_compress(data: bytes, min_code_size: int = 8, use_native: str = "auto") -> bytes:
    """LZW-compress palette indices. ``use_native`` as in
    :func:`cosig_tpu_torch.accel.bvh.build_bvh`: ``"auto"`` runs the C++
    encoder and falls back to :func:`lzw_compress_py`, ``"native"``
    raises if the library is unavailable, ``"python"`` runs the Python
    encoder."""
    from cosig_tpu_torch.native import gif_native, loader

    return loader.dispatch(use_native, lambda: gif_native.compress(data, min_code_size),
                           lambda: lzw_compress_py(data, min_code_size))


# ---------------------------------------------------------------------------
# Container


def _header(w: int, h: int) -> bytes:
    return (
        b"GIF89a"
        + struct.pack("<HH", w, h)
        + bytes((0xF7, 0x00, 0x00))  # GCT flag + 256 colors, bg 0, 1:1
        + color_table()
    )


def _loop_ext() -> bytes:
    return (
        bytes((0x21, 0xFF, 0x0B))
        + b"NETSCAPE2.0"
        + bytes((0x03, 0x01))
        + struct.pack("<H", 0)
        + b"\x00"
    )


def _frame_blocks(w: int, h: int, compressed: bytes, delay_cs: int) -> bytes:
    out = bytearray()
    # Graphic Control Extension
    out += bytes((0x21, 0xF9, 0x04, 0x00))
    out += struct.pack("<H", delay_cs)
    out += bytes((0x00, 0x00))
    # Image Descriptor
    out += b"\x2C" + struct.pack("<HHHH", 0, 0, w, h) + b"\x00"
    # LZW data in <=255-byte sub-blocks
    out.append(8)  # min code size
    for off in range(0, len(compressed), 255):
        chunk = compressed[off : off + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0x00)
    return bytes(out)


def save_gif(
    frames: Sequence[np.ndarray],
    path: str,
    delay_cs: int = 15,
    progress: Optional[Callable[[float], None]] = None,
    max_workers: Optional[int] = None,
) -> None:
    """Encode float [H,W,3] frames into an infinitely-looping GIF.

    Quantization + LZW run per-frame in a thread pool (the reference's
    Parallel.For, GifGenerator.cs:117-130)."""
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]

    def encode(frame: np.ndarray) -> bytes:
        return lzw_compress(quantize(np.asarray(frame)).tobytes())

    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = [pool.submit(encode, f) for f in frames]
        compressed = []
        for i, fut in enumerate(futures):
            compressed.append(fut.result())
            if progress:
                progress((i + 1) / len(frames) * 0.9)

    with open(path, "wb") as f:
        f.write(_header(w, h))
        f.write(_loop_ext())
        for comp in compressed:
            f.write(_frame_blocks(w, h, comp, delay_cs))
        f.write(b"\x3B")
    if progress:
        progress(1.0)


# ---------------------------------------------------------------------------
# Turntable (GifGenerator.cs:40-72)


def turntable_frames(
    renderer,
    scene,
    base_settings,
    steps: int = 36,
    progress: Optional[Callable[[float], None]] = None,
) -> List[np.ndarray]:
    """Render ``steps`` frames rotating the camera Z override by
    360/steps degrees each (10 degrees at the default 36)."""
    rot = base_settings.camera_rotation_override or (0.0, 0.0, 0.0)
    frames = []
    for i in range(steps):
        angle = i * (360.0 / steps)
        settings = base_settings.replace(
            camera_rotation_override=(rot[0], rot[1], angle)
        )
        frames.append(renderer.render(scene, settings))
        if progress:
            progress((i + 1) / steps)
    return frames


def decode_gif_frame_count(path: str) -> int:
    """Minimal validity check used by tests: count image descriptors."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:6] == b"GIF89a"
    count = 0
    pos = 13 + 768  # header + GCT
    while pos < len(blob):
        b = blob[pos]
        if b == 0x2C:  # image descriptor
            count += 1
            pos += 10
            pos += 1  # min code size
            while blob[pos] != 0:
                pos += 1 + blob[pos]
            pos += 1
        elif b == 0x21:  # extension
            pos += 2
            while blob[pos] != 0:
                pos += 1 + blob[pos]
            pos += 1
        elif b == 0x3B:
            break
        else:
            raise ValueError(f"bad GIF block 0x{b:02x} at {pos}")
    return count
