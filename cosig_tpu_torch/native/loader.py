"""Build and load the native host library (``src/bvh.cc``, ``src/gif_lzw.cc``).

The library is compiled at first use by calling the C++ compiler
directly::

    g++ -O3 -fPIC -std=c++17 -shared -o libcosig_native_<hash>.so src/*.cc

into ``cosig_tpu_torch/build/native/``. The hash covers the sources, the
compiler's name and the flags, so an edited source builds anew and an
unchanged one is reused. The flags leave out ``-march=native``,
``-ffast-math`` and ``-ffp-contract=fast``: the BVH's pivots and bounds
must round as the Python builder's float32 numpy arithmetic does, so that
the two give the same nodes bit for bit.

Several processes may build at once (the test suite runs in several
workers): each compiles into a temporary file of its own and moves it into
place with ``os.replace``, so a reader finds either no library or a whole
one. Within a process a lock makes one thread build and the others wait.

:func:`load` returns the loaded library or raises :class:`NativeError`;
a failure is kept, logged once, and raised again on every later call, so
a missing compiler is not retried at every scene. :func:`loaded` says
whether the library is loaded in this process; :func:`dispatch` is the
``use_native`` choice of the builders that have a native version.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading

log = logging.getLogger("cosig_tpu_torch.native")

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "native")
SOURCES = ("bvh.cc", "gif_lzw.cc")
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: Exception | None = None


class NativeError(RuntimeError):
    """The compiler is missing, refused the sources, or the library does not load."""


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libcosig_native_{source_hash()}.so")


def build(force: bool = False) -> str:
    """Compile the library if it is not there (or ``force``) -> its path.
    Raises :class:`NativeError` if the compiler is missing or fails."""
    out = library_path()
    if os.path.exists(out) and not force:
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise NativeError(f"{CXX} not found on PATH; the native library cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".build-", suffix=".so")
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, *(os.path.join(SRC_DIR, s) for s in SOURCES)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise NativeError(f"{CXX} took more than {BUILD_TIMEOUT_S} s") from e
        if res.returncode != 0:
            raise NativeError(f"{CXX} failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built at first use; raises :class:`NativeError`
    (the first failure, kept for the life of the process)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            try:
                _lib = ctypes.CDLL(build())
            except OSError as e:
                _error = NativeError(f"cannot load the native library: {e}")
            except NativeError as e:
                _error = e
            if _error is not None:
                log.warning("native host library unavailable, using the Python builders: %s",
                            _error)
        if _lib is None:
            raise _error
        return _lib


def loaded() -> bool:
    """Whether the native library is loaded in this process."""
    return _lib is not None


MODES = ("auto", "native", "python")


def dispatch(use_native: str, native, python):
    """``native()`` or ``python()`` by ``use_native``: ``"auto"`` runs
    ``native`` and falls back to ``python`` on :class:`NativeError` (which
    :func:`load` has logged once); ``"native"`` lets the error raise;
    ``"python"`` runs ``python``."""
    if use_native not in MODES:
        raise ValueError(f"use_native must be one of {MODES}, got {use_native!r}")
    if use_native != "python":
        try:
            return native()
        except NativeError:
            if use_native == "native":
                raise
    return python()
