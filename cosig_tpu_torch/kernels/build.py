"""Build the CUDA sources into a shared library at first use.

``nvcc`` compiles ``cosig_tpu_torch/csrc/wavefront.cu`` (with its headers)
for Hopper into ``cosig_tpu_torch/build/libcosig_wavefront_<hash>.so``, a
plain C library that :mod:`cosig_tpu_torch.kernels.wavefront` binds with
ctypes. The hash covers the sources and the flags, so an edited source
builds anew and an unchanged one is reused.

Flags: ``--fmad=false`` keeps every multiply and add separately rounded,
and the build never passes ``--use_fast_math``, so division and sqrt stay
IEEE — the kernels then agree bit for bit with their plain PyTorch
versions and with the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("rng.cuh", "traverse.cuh", "bounce.cuh", "wavefront.cu")
MAIN_SOURCE = "wavefront.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()


class BuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.isfile(cand) and os.access(cand, os.X_OK):
                return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libcosig_wavefront_{source_hash()}.so")


def nvcc_command(nvcc: str, out: str, verbose: bool = False) -> list:
    cmd = [nvcc, *NVCC_FLAGS, "-o", out, os.path.join(CSRC_DIR, MAIN_SOURCE)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]  # registers, spills and shared memory per kernel
    return cmd


def build(force: bool = False, verbose: bool = False) -> tuple:
    """Compile if needed -> (library path, seconds spent compiling, nvcc's
    stderr). ``force`` rebuilds even when the library exists; ``verbose``
    asks ptxas for each kernel's resource use (printed to stderr)."""
    with _lock:
        out = library_path()
        if os.path.exists(out) and not force:
            return out, 0.0, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            nvcc_command(find_nvcc(), tmp, verbose), capture_output=True, text=True
        )
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise BuildError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return out, dt, proc.stderr
