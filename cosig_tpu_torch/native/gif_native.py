"""ctypes binding of the C++ GIF LZW encoder (``src/gif_lzw.cc``)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from cosig_tpu_torch.native import loader


@functools.lru_cache(maxsize=1)
def _fn():
    fn = loader.load().cosig_lzw_compress
    fn.restype = ctypes.c_int
    # data, n, min_code_size, out, cap
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                   np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"), ctypes.c_int64]
    return fn


def compress(data: bytes, min_code_size: int = 8) -> bytes:
    """LZW-compress palette indices, byte for byte as
    :func:`cosig_tpu_torch.utils.gif.lzw_compress_py`. Raises
    :class:`loader.NativeError` if the library is unavailable."""
    data = bytes(data)
    # At most one code of <= 12 bits per input byte, plus clear and end codes.
    cap = len(data) * 2 + 64
    out = np.empty((cap,), np.uint8)
    n = _fn()(data, len(data), min_code_size, out, cap)
    if n < 0:
        raise loader.NativeError(f"cosig_lzw_compress needed more than {cap} bytes")
    return out[:n].tobytes()
