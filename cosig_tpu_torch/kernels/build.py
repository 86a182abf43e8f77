"""Build the CUDA sources into a shared library at first use.

``nvcc`` compiles each kernel source of ``cosig_tpu_torch/csrc``
(``wavefront.cu``: the primary, compaction and bounce kernels;
``forms.cu``: the wavefront's fission builds, trace and shade kernels
and shadow-set builds; ``mx.cu``: the primary and bounce builds with the
tensor-core pair test and its probe; ``mx_forms.cu``: the fission and
shadow-set builds with the tensor-core pair test; ``megakernel.cu``: the megakernel
in both forms of the pair test and the debug kernel; with their headers) for Hopper, one ``nvcc`` per source, all started at once, and
links the objects into
``cosig_tpu_torch/build/libcosig_kernels_<hash>.so``, a plain C library
that :mod:`cosig_tpu_torch.kernels.binding` binds with ctypes. The hash
covers the sources and the flags, so an edited source builds anew and an
unchanged one is reused.

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
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("rng.cuh", "traverse.cuh", "mx_layout.h", "walk_layout.h", "mx_pair.cuh",
           "traverse_tile.cuh", "bounce.cuh", "camera.cuh", "wavefront.cuh", "forms.cuh",
           "wavefront.cu", "forms.cu", "mx.cu", "mx_forms.cu", "megakernel.cu")
# One nvcc each, then one link.
KERNEL_SOURCES = ("wavefront.cu", "forms.cu", "mx.cu", "mx_forms.cu", "megakernel.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
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
    return os.path.join(BUILD_DIR, f"libcosig_kernels_{source_hash()}.so")


def nvcc_command(nvcc: str, source: str, obj: str, verbose: bool = False) -> list:
    """Compile one kernel source to an object file."""
    cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, source)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]  # registers, spills and shared memory per kernel
    return cmd


def link_command(nvcc: str, objs: list, out: str) -> list:
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", out, *objs]


def _compile(cmds: list, parallel: bool) -> list:
    """Run the compiles -> [(returncode, stderr)]: all started at once, or
    one after another."""
    if not parallel:
        return [(r.returncode, r.stderr)
                for r in (subprocess.run(c, capture_output=True, text=True) for c in cmds)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    results = []
    for p in procs:  # wait for every compile, also after a failure
        _, err = p.communicate()
        results.append((p.returncode, err))
    return results


def build(force: bool = False, verbose: bool = False, parallel: bool = True) -> tuple:
    """Compile if needed -> (library path, seconds spent compiling, nvcc's
    stderr). ``force`` rebuilds even when the library exists; ``verbose``
    asks ptxas for each kernel's resource use; ``parallel=False`` runs the
    compiles one after another (to time against the parallel build)."""
    with _lock:
        out = library_path()
        if os.path.exists(out) and not force:
            return out, 0.0, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{src}.o") for src in KERNEL_SOURCES]
            results = _compile([nvcc_command(nvcc, src, obj, verbose)
                                for src, obj in zip(KERNEL_SOURCES, objs)], parallel)
            for (rc, err), src in zip(results, KERNEL_SOURCES):
                if rc != 0:
                    raise BuildError(f"nvcc failed on {src} ({rc}):\n{err[-4000:]}")
            lib = os.path.join(tmp, "lib.so")
            link = subprocess.run(link_command(nvcc, objs, lib), capture_output=True, text=True)
            if link.returncode != 0:
                raise BuildError(f"nvcc link failed ({link.returncode}):\n{link.stderr[-4000:]}")
            os.replace(lib, out)
        return out, time.perf_counter() - t0, "".join(err for _, err in results) + link.stderr
