"""Camera rays (counterpart of :mod:`cosig_tpu.ops.camera` and of the
ray generation inlined in the JAX package's primary-stage kernel and
megakernel, ``trace_wavefront.py:346-390``, ``trace_pallas.py:210-252``).

:func:`primary_rays` is the plain version of ``csrc/camera.cuh``; the
wavefront's primary stage and the megakernel share it, as their kernels
share the device function, so both make the same rays.
:func:`sample_offsets` and :func:`generate_rays` are the oracle path's
(``camera.py:36-132``): [N, 3] origins and directions, the camera in
object space by the inverse camera matrix.

Pixel convention: ``px`` is the column (0..W-1), ``py`` the row with 0 at
the bottom (Unity texture convention; the PNG writer flips on save).
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
    _rsqrt3,
)
from cosig_tpu_torch.ops.intersect import _div, normalize

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
        rx, ry, rz = rng.random_unit_vector_planes(px + s, py, s)
        scale = float(F32(0.2) * F32(u[U_SHUTTER]))
        ox = ox + (rx - 0.5) * scale
        oy = oy + (ry - 0.5) * scale
        oz = oz + (rz - 0.5) * scale
    return ox, oy, oz, dx, dy, dz


def sample_offsets(px, py, sample_idx: int, sample_count: int):
    """Sub-pixel offset of AA sample ``sample_idx`` (compute:300-310): the
    pixel centre for one sample, else the stratified grid cell plus hash22
    jitter keyed on (x + 13 i, y + 7 i)."""
    if sample_count <= 1:
        half = torch.full_like(px, 0.5)
        return half, half
    grid_w, grid_h = aa_grid(sample_count)
    gy, gx = divmod(sample_idx, grid_w)
    jx, jy = rng.hash22(px + float(F32(sample_idx * 13.0)), py + float(F32(sample_idx * 7.0)))
    return _div(float(gx) + jx, float(grid_w)), _div(float(gy) + jy, float(grid_h))


def generate_rays(px, py, ox, oy, width: int, height: int, cam_to_obj, cam_distance,
                  fov_deg, ortho_size, is_orthographic: bool):
    """Camera rays through pixels (px + ox, py + oy) -> (origin [N, 3],
    unit direction [N, 3]) in object space (compute:291-340).

    The camera sits at (0, 0, distance) looking down -Z at a projection
    plane of height ``2 distance tan(fov / 2)`` through z = 0, or, for the
    orthographic camera, half-height ``ortho_size`` with rays along -Z.
    The frame's scalars are float32 on the host; tan is the correctly
    rounded float32 value, as the kernels' uniforms take it."""
    aspect = F32(width) / F32(height)
    zeros = torch.zeros_like(px)
    if is_orthographic:
        half_h = F32(ortho_size)
        half_w = half_h * aspect
        u = (_div(px + ox, float(width)) - 0.5) * 2.0 * float(half_w)
        v = (_div(py + oy, float(height)) - 0.5) * 2.0 * float(half_h)
        ocx, ocy, ocz = u, v, torch.full_like(u, float(cam_distance))
        zero = u * 0.0
        dcx, dcy, dcz = zero, zero, zero - 1.0
    else:
        half = F32(np.deg2rad(F32(fov_deg))) * F32(0.5)
        half_h = F32(cam_distance) * F32(np.tan(np.float64(half)))
        plane_h = F32(2.0) * half_h
        plane_w = plane_h * aspect
        u = (_div(px + ox, float(width)) - 0.5) * float(plane_w)
        v = (_div(py + oy, float(height)) - 0.5) * float(plane_h)
        ocx, ocy, ocz = zeros, zeros, torch.full_like(u, float(cam_distance))
        d_cam = normalize(torch.stack([u - ocx, v - ocy, zeros - ocz], dim=-1))
        dcx, dcy, dcz = d_cam[:, 0], d_cam[:, 1], d_cam[:, 2]

    m = [[float(x) for x in row] for row in np.asarray(cam_to_obj, F32)]
    origin = torch.stack(
        [m[i][0] * ocx + m[i][1] * ocy + m[i][2] * ocz + m[i][3] for i in range(3)], dim=-1)
    direction = normalize(torch.stack(
        [m[i][0] * dcx + m[i][1] * dcy + m[i][2] * dcz for i in range(3)], dim=-1))
    return origin, direction
