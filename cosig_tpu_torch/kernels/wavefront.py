"""Wrappers of the two wavefront kernels, and their launch counters.

``primary`` and ``bounce`` take the tensors of one render stage. On a CUDA
tensor they launch the hand-written kernel (``csrc/wavefront.cu``) on the
current stream, without synchronising, and raise if the launch is
refused; on a CPU tensor they run the plain PyTorch version
(:mod:`cosig_tpu_torch.ops.trace_wavefront`). There is no fallback from a
CUDA tensor to the plain version.

``primary_launches`` / ``bounce_launches`` count kernel launches (plain
runs on the CPU are not counted); :func:`reset_counts` sets both to 0.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import GEOM_COMPS, ClusterSet
from cosig_tpu_torch.kernels import build as kbuild
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import camera, trace_wavefront
from cosig_tpu_torch.ops.kernel_core import STATE_ROWS, UNIFORMS_LEN

F32 = np.float32

MAX_MATS = 64  # csrc/bounce.cuh
MAX_LIGHTS = 16

# Flag bits of csrc/bounce.cuh (StaticConfig toggles).
_FLAGS = (
    ("enable_ambient", 1),
    ("enable_diffuse", 2),
    ("enable_specular", 4),
    ("enable_refraction", 8),
    ("is_orthographic", 16),
    ("enable_soft_shadows", 32),
    ("enable_glossy", 64),
    ("enable_motion_blur", 128),
    ("multi_light", 256),
)

primary_launches = 0
bounce_launches = 0


def reset_counts() -> None:
    global primary_launches, bounce_launches
    primary_launches = 0
    bounce_launches = 0


class Frame(ctypes.Structure):
    """Mirror of ``struct Frame`` in csrc/bounce.cuh (all fields 4 bytes)."""

    _fields_ = [
        ("u", ctypes.c_float * UNIFORMS_LEN),
        ("flags", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("band", ctypes.c_int),
        ("aa", ctypes.c_int),
        ("grid_w", ctypes.c_int),
        ("grid_h", ctypes.c_int),
        ("aspect", ctypes.c_float),
        ("n_rays", ctypes.c_int),
        ("n_mats", ctypes.c_int),
        ("n_lights", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("is_last", ctypes.c_int),
        ("mats", ctypes.c_float * (MAX_MATS * 8)),
        ("lights", ctypes.c_float * (MAX_LIGHTS * 8)),
    ]


def config_flags(cfg: StaticConfig) -> int:
    return sum(bit for name, bit in _FLAGS if getattr(cfg, name))


def make_frame(cfg: StaticConfig, uniforms: np.ndarray, mats: np.ndarray,
               lights: np.ndarray, band: int, depth: int, is_last: bool) -> Frame:
    if mats.shape[0] > MAX_MATS or lights.shape[0] > MAX_LIGHTS:
        raise ValueError(
            f"the kernels take at most {MAX_MATS} materials and {MAX_LIGHTS} lights; "
            f"got {mats.shape[0]} and {lights.shape[0]}"
        )
    if uniforms.shape != (UNIFORMS_LEN,):
        raise ValueError(f"uniforms must be [{UNIFORMS_LEN}], got {uniforms.shape}")
    aa = max(1, cfg.aa_samples)
    grid_w, grid_h = camera.aa_grid(aa)
    f = Frame()
    f.u[:] = [float(x) for x in np.asarray(uniforms, F32)]
    f.flags = config_flags(cfg)
    f.width, f.height, f.band = cfg.width, cfg.height, band
    f.aa, f.grid_w, f.grid_h = aa, grid_w, grid_h
    f.aspect = float(F32(cfg.width / cfg.height))
    f.n_rays = trace_wavefront.num_rays(cfg, band)
    f.n_mats, f.n_lights = mats.shape[0], lights.shape[0]
    f.depth, f.is_last = depth, int(is_last)
    m = np.zeros(MAX_MATS * 8, F32)
    m[: mats.size] = np.asarray(mats, F32).ravel()
    f.mats[:] = [float(x) for x in m]
    li = np.zeros(MAX_LIGHTS * 8, F32)
    li[: lights.size] = np.asarray(lights, F32).ravel()
    f.lights[:] = [float(x) for x in li]
    return f


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    path, _, _ = kbuild.build()
    lib = ctypes.CDLL(path)
    argtypes = [
        ctypes.POINTER(Frame), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    for name in ("cosig_primary_launch", "cosig_bounce_launch"):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cosig_frame_bytes.argtypes = []
    lib.cosig_frame_bytes.restype = ctypes.c_int
    if lib.cosig_frame_bytes() != ctypes.sizeof(Frame):
        raise RuntimeError(
            f"Frame layout mismatch: C {lib.cosig_frame_bytes()} bytes, "
            f"Python {ctypes.sizeof(Frame)}"
        )
    return lib


def _check_cset(cset: ClusterSet, dev: torch.device) -> None:
    for name in ("geom", "aabb_t"):
        t = getattr(cset, name)
        if t.device != dev:
            raise ValueError(f"cset.{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"cset.{name} must be contiguous float32")
    if cset.geom.dim() != 3 or cset.geom.shape[2] != GEOM_COMPS:
        raise ValueError(f"cset.geom must be [C, K, {GEOM_COMPS}], got {tuple(cset.geom.shape)}")
    if cset.aabb_t.dim() != 2 or cset.aabb_t.shape[0] != 8 \
            or cset.aabb_t.shape[1] < cset.geom.shape[0]:
        raise ValueError(f"cset.aabb_t must be [8, >= C], got {tuple(cset.aabb_t.shape)}")


def _launch(name: str, frame: Frame, cset: ClusterSet, state: torch.Tensor) -> None:
    fn = getattr(library(), name)
    dev = state.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            ctypes.byref(frame),
            ctypes.c_void_p(cset.geom.data_ptr()),
            ctypes.c_void_p(cset.aabb_t.data_ptr()),
            cset.num_clusters, cset.k, int(cset.aabb_t.shape[1]),
            ctypes.c_void_p(state.data_ptr()),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def primary(cset: ClusterSet, uniforms: np.ndarray, mats: np.ndarray,
            lights: np.ndarray, cfg: StaticConfig, band: int) -> torch.Tensor:
    """Primary stage -> state f32 [16, N] on the cluster set's device."""
    global primary_launches
    dev = cset.device
    if dev.type == "cpu":
        return trace_wavefront.primary_stage(cset, uniforms, mats, lights, cfg, band)
    if dev.type != "cuda":
        raise ValueError(f"no primary kernel for device {dev}")
    _check_cset(cset, dev)
    frame = make_frame(cfg, uniforms, mats, lights, band, 0, cfg.max_depth == 1)
    state = torch.empty((STATE_ROWS, frame.n_rays), dtype=torch.float32, device=dev)
    _launch("cosig_primary_launch", frame, cset, state)
    primary_launches += 1
    return state


def bounce(state: torch.Tensor, cset: ClusterSet, uniforms: np.ndarray,
           mats: np.ndarray, lights: np.ndarray, cfg: StaticConfig, depth: int) -> None:
    """One bounce stage at ``depth`` (1 .. max_depth-1) on ``state`` in place."""
    global bounce_launches
    dev = state.device
    if dev.type == "cpu":
        trace_wavefront.bounce_stage(state, cset, uniforms, mats, lights, cfg, depth)
        return
    if dev.type != "cuda":
        raise ValueError(f"no bounce kernel for device {dev}")
    _check_cset(cset, dev)
    if not 1 <= depth < cfg.max_depth:
        raise ValueError(f"bounce depth {depth} outside 1..{cfg.max_depth - 1}")
    per_row = cfg.width * max(1, cfg.aa_samples)
    if (state.dtype != torch.float32 or not state.is_contiguous() or state.dim() != 2
            or state.shape[0] != STATE_ROWS or state.shape[1] % per_row != 0):
        raise ValueError(
            f"state must be contiguous float32 [{STATE_ROWS}, band * {per_row}], "
            f"got {state.dtype} {tuple(state.shape)}"
        )
    frame = make_frame(cfg, uniforms, mats, lights, state.shape[1] // per_row, depth,
                       depth == cfg.max_depth - 1)
    _launch("cosig_bounce_launch", frame, cset, state)
    bounce_launches += 1
