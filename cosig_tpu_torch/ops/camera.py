"""Camera rays (counterpart of :mod:`cosig_tpu.ops.camera` and of the
ray generation inlined in the JAX package's primary-stage kernel and
megakernel, ``trace_wavefront.py:346-390``, ``trace_pallas.py:210-252``).

:func:`primary_rays` is the plain version of ``csrc/camera.cuh``; the
wavefront's primary stage and the megakernel share it, as their kernels
share the device function, so both make the same rays.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from cosig_tpu_torch.ops import rng
from cosig_tpu_torch.ops.kernel_core import (
    U_CAM,
    U_DIST,
    U_ORTHO,
    U_PLANE_H,
    U_SHUTTER,
    _div,
    _rsqrt3,
    _ruv,
)

F32 = np.float32


def aa_grid(sample_count: int) -> Tuple[int, int]:
    """gridW = ceil(sqrt(n)), gridH = ceil(n / gridW) (compute:285-287)."""
    n = max(1, sample_count)
    grid_w = math.ceil(math.sqrt(n))
    grid_h = math.ceil(n / grid_w)
    return grid_w, grid_h


def primary_rays(cfg, u, px, py, s):
    """Camera rays of AA sample ``s`` through pixels (px, py) -> object-space
    origin and unit direction planes (ox, oy, oz, dx, dy, dz).

    ``u`` is the uniforms vector as Python floats; ``px``/``py``/``s`` are
    float32 planes (py global, s the integer sample index): stratified
    cell plus hash22 jitter, the perspective or orthographic ray, then the
    motion-blur origin jitter (compute:291-340)."""
    width, height = cfg.width, cfg.height
    aa = max(1, cfg.aa_samples)
    grid_w, grid_h = aa_grid(aa)
    cam = u[U_CAM:U_CAM + 12]
    dist = u[U_DIST]
    aspect = float(F32(width / height))
    plane_h = u[U_PLANE_H]
    plane_w = float(F32(plane_h) * F32(aspect))
    ortho_h = u[U_ORTHO]
    ortho_w = float(F32(ortho_h) * F32(aspect))

    # AA offsets (compute:300-310): stratified cell + hash22 jitter.
    if aa == 1:
        off_x = torch.full_like(px, 0.5)
        off_y = torch.full_like(px, 0.5)
    else:
        s_i = s.to(torch.int64)
        gx = (s_i % grid_w).to(torch.float32)
        gy = (s_i // grid_w).to(torch.float32)
        jx, jy = rng.hash22(px + s * 13.0, py + s * 7.0)
        off_x = _div(gx + jx, float(grid_w))
        off_y = _div(gy + jy, float(grid_h))

    zeros = torch.zeros_like(px)
    if cfg.is_orthographic:
        uu = (_div(px + off_x, float(width)) - 0.5) * 2.0 * ortho_w
        vv = (_div(py + off_y, float(height)) - 0.5) * 2.0 * ortho_h
        ocx, ocy, ocz = uu, vv, torch.full_like(px, dist)
        dcx, dcy, dcz = zeros, zeros, torch.full_like(px, -1.0)
    else:
        uu = (_div(px + off_x, float(width)) - 0.5) * plane_w
        vv = (_div(py + off_y, float(height)) - 0.5) * plane_h
        ocx, ocy, ocz = zeros, zeros, torch.full_like(px, dist)
        dcx, dcy, dcz = _rsqrt3(uu - ocx, vv - ocy, -ocz)

    ox = cam[0] * ocx + cam[1] * ocy + cam[2] * ocz + cam[3]
    oy = cam[4] * ocx + cam[5] * ocy + cam[6] * ocz + cam[7]
    oz = cam[8] * ocx + cam[9] * ocy + cam[10] * ocz + cam[11]
    dx = cam[0] * dcx + cam[1] * dcy + cam[2] * dcz
    dy = cam[4] * dcx + cam[5] * dcy + cam[6] * dcz
    dz = cam[8] * dcx + cam[9] * dcy + cam[10] * dcz
    dx, dy, dz = _rsqrt3(dx, dy, dz)

    if cfg.enable_motion_blur:
        rx, ry, rz = _ruv(px + s, py, s)
        scale = float(F32(0.2) * F32(u[U_SHUTTER]))
        ox = ox + (rx - 0.5) * scale
        oy = oy + (ry - 0.5) * scale
        oz = oz + (rz - 0.5) * scale
    return ox, oy, oz, dx, dy, dz
