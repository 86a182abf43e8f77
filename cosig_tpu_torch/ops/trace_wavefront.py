"""Wavefront render: one primary stage, then one bounce stage per depth.

Counterpart of :func:`cosig_tpu.ops.trace_wavefront.render_wavefront`
(``trace_wavefront.py:756-1172``) in its shipped dispatch form
(self-skip: the state stays in pixel order and dead rays do no work):

1. the **primary stage** (``:317-434``) makes a camera ray for every
   (pixel, AA sample), writes the 16-row ray state and runs bounce 0;
2. ``max_depth - 1`` **bounce stages** (``:994-1012``) each run one bounce
   in place on every live ray;
3. **finalize** (``:1136-1172``) averages the AA samples into the image and
   sums the ray count.

Rays are enumerated in plain order, ``id = (py_local * W + px) * aa + s``
with N = band * W * aa and no tile padding. The RNG seeds (px, py, s) are
the JAX package's, so images agree; finalize is the exact inverse of the
enumeration.

The stage functions here are the plain PyTorch versions of the two CUDA
kernels (``csrc/wavefront.cu``); :mod:`cosig_tpu_torch.kernels.wavefront`
dispatches between them by the device the state lives on.
"""

from __future__ import annotations

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import ClusterSet
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import camera, kernel_core, rng
from cosig_tpu_torch.ops.kernel_core import (
    ROW_ALIVE,
    ROW_COUNT,
    ROW_ID,
    STATE_ROWS,
    U_CAM,
    U_DIST,
    U_ORTHO,
    U_PLANE_H,
    U_ROW_OFF,
    U_SHUTTER,
    _div,
    _rsqrt3,
    _ruv,
)

F32 = np.float32


def num_rays(cfg: StaticConfig, band: int) -> int:
    """Rays in a band of ``band`` rows; ray ids must stay f32-exact."""
    n = band * cfg.width * max(1, cfg.aa_samples)
    if n >= 2 ** 24:
        raise ValueError(
            f"{n} rays exceed f32-exact ray ids; render in row bands (rows/row_offset)"
        )
    return n


def _seed_planes(rid: torch.Tensor, cfg: StaticConfig, row_offset: float):
    """(px, py, s) RNG seed planes from integer ray ids (inverse of the
    enumeration); py is global (band offset added)."""
    aa = max(1, cfg.aa_samples)
    s_i = rid % aa
    p_i = rid // aa
    px = (p_i % cfg.width).to(torch.float32)
    py = (p_i // cfg.width).to(torch.float32) + row_offset
    return px, py, s_i.to(torch.float32)


def primary_stage(cset: ClusterSet, uniforms: np.ndarray, mats: np.ndarray,
                  lights: np.ndarray, cfg: StaticConfig, band: int) -> torch.Tensor:
    """Plain version of the primary kernel -> state f32 [16, N] on the
    cluster set's device (trace_wavefront.py:317-434)."""
    dev = cset.device
    n = num_rays(cfg, band)
    width, height = cfg.width, cfg.height
    aa = max(1, cfg.aa_samples)
    grid_w, grid_h = camera.aa_grid(aa)
    u = [float(x) for x in uniforms]
    row_off = u[U_ROW_OFF]

    rid = torch.arange(n, device=dev, dtype=torch.int64)
    s_i = rid % aa
    px, py, s = _seed_planes(rid, cfg, row_off)
    in_image = py < float(height)

    cam = u[U_CAM:U_CAM + 12]
    dist = u[U_DIST]
    plane_h = u[U_PLANE_H]
    aspect = float(F32(width / height))
    plane_w = float(F32(plane_h) * F32(aspect))
    ortho_h = u[U_ORTHO]
    ortho_w = float(F32(ortho_h) * F32(aspect))

    # AA offsets (compute:300-310): stratified cell + hash22 jitter.
    if aa == 1:
        off_x = torch.full_like(px, 0.5)
        off_y = torch.full_like(px, 0.5)
    else:
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

    state = torch.zeros((STATE_ROWS, n), dtype=torch.float32, device=dev)
    state[0], state[1], state[2] = ox, oy, oz
    state[3], state[4], state[5] = dx, dy, dz
    state[6:9] = 1.0
    state[ROW_ALIVE] = in_image.to(torch.float32)
    state[ROW_ID] = rid.to(torch.float32)
    kernel_core.bounce_core(cfg, uniforms, mats, lights, cset, state,
                            px, py, s, depth=0, is_last=cfg.max_depth == 1)
    return state


def bounce_stage(state: torch.Tensor, cset: ClusterSet, uniforms: np.ndarray,
                 mats: np.ndarray, lights: np.ndarray, cfg: StaticConfig,
                 depth: int) -> None:
    """Plain version of the bounce kernel: one bounce at ``depth`` on
    ``state`` in place (trace_wavefront.py:466-507)."""
    if cfg.enable_soft_shadows or cfg.enable_glossy:
        rid = state[ROW_ID].to(torch.int64)
        px, py, s = _seed_planes(rid, cfg, float(uniforms[U_ROW_OFF]))
    else:
        px = py = s = None  # unread without the stochastic effects
    kernel_core.bounce_core(cfg, uniforms, mats, lights, cset, state,
                            px, py, s, depth=depth,
                            is_last=depth == cfg.max_depth - 1)


def finalize(state: torch.Tensor, cfg: StaticConfig, band: int):
    """AA mean and untile -> (image [band, W, 3], rays traced).

    The samples of a pixel are consecutive ids; they are summed in sample
    order and divided by aa. The ray count is summed in int64 (a float32
    sum drops integers above 2^24)."""
    aa = max(1, cfg.aa_samples)
    colors = state[9:12].reshape(3, band, cfg.width, aa)
    acc = colors[..., 0]
    for k in range(1, aa):
        acc = acc + colors[..., k]
    if aa > 1:
        acc = _div(acc, float(aa))
    img = acc.permute(1, 2, 0).contiguous()
    rays = int(state[ROW_COUNT].to(torch.int64).sum())
    return img, rays


def trace_state(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                cfg: StaticConfig, rows: int | None = None, row_offset: int = 0,
                device=None, plain: bool = False) -> torch.Tensor:
    """Run the primary stage and the ``max_depth - 1`` bounce stages ->
    the final ray state f32 [16, N] (arguments as in :func:`render_wavefront`)."""
    from cosig_tpu_torch.kernels import wavefront as kw

    dev = cset.device if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if cset.device != dev:
        raise ValueError(f"cluster set lives on {cset.device}, not {dev}")
    band = cfg.height if rows is None else int(rows)
    uniforms = np.array(uniforms, F32)
    uniforms[U_ROW_OFF] = F32(row_offset)
    lights = np.ascontiguousarray(lights, F32)
    mats = cset.mats.detach().cpu().numpy()

    primary, bounce = (primary_stage, bounce_stage) if plain else (kw.primary, kw.bounce)
    state = primary(cset, uniforms, mats, lights, cfg, band)
    for depth in range(1, cfg.max_depth):
        bounce(state, cset, uniforms, mats, lights, cfg, depth)
    return state


def render_wavefront(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                     cfg: StaticConfig, rows: int | None = None,
                     row_offset: int = 0, device=None, plain: bool = False):
    """Render -> ``(img [rows, W, 3] f32 on device, rays traced)``.

    ``uniforms``/``lights`` come from :func:`kernel_core.build_uniforms` /
    :func:`kernel_core.build_lights`. ``rows``/``row_offset`` restrict the
    render to a band of global rows (projection and RNG seeds stay
    global). ``device`` must be where ``cset`` lives (default: there).
    ``plain=True`` runs the plain PyTorch stages on any device instead of
    dispatching by device (the kernels' reference on the card)."""
    state = trace_state(cset, uniforms, lights, cfg, rows, row_offset, device, plain)
    return finalize(state, cfg, state.shape[1] // (cfg.width * max(1, cfg.aa_samples)))
