"""Camera rays of the reference: a frozen copy of the oracle part of the
port's ``ops/camera.py`` (``sample_offsets``, ``generate_rays``), which
the benchmark does not import.

Pixel convention: ``px`` is the column (0..W-1), ``py`` the row with 0 at
the bottom (Unity texture convention; the PNG writer flips on save).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from benchmark.reference import rng
from benchmark.reference.intersect import _div, normalize

F32 = np.float32


def aa_grid(sample_count: int) -> Tuple[int, int]:
    """gridW = ceil(sqrt(n)), gridH = ceil(n / gridW) (compute:285-287)."""
    n = max(1, sample_count)
    grid_w = math.ceil(math.sqrt(n))
    grid_h = math.ceil(n / grid_w)
    return grid_w, grid_h


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
