"""The reference's Whitted tracer: plain PyTorch operations on a list of
pixels, a frozen copy of the port's oracle path (``ops/trace_xla.py``),
which the benchmark does not import.

The upstream per-pixel recursive shader (``BVHRayTracing.compute:273-511``)
becomes batched operations over the pixels: the recursion is a loop over
bounce depth carrying (origin, direction, attenuation, colour, alive). A
pixel's result depends on its coordinates alone, so any sample of a
frame's pixels is traced exactly as in the whole frame. The closest hit
is the brute-force scan (:func:`benchmark.reference.intersect.closest_hit_brute`),
which breaks equal-t ties by soup order as the port's kernels do.

The float type follows the scene's tensors: camera rays and the hash RNG
are float32 (they are keyed on pixel coordinates), everything after them
is in the scene's type, float32 for the reference and bfloat16 for its
lower-precision control. ``count``, where given, sees every live ray and
every shadow ray cast, for the roofline's work count
(:mod:`benchmark.reference.bvh`).

Divisions and roots go through ``intersect._div`` and ``intersect._sqrt``
so the result is IEEE on the CPU and the card.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from benchmark.reference.frame import FrameParams, SceneArrays, StaticConfig
from benchmark.reference import camera, rng
from benchmark.reference.intersect import Hit, _div, _dot, _sqrt, closest_hit_brute, normalize
from benchmark.reference.shade import OFFSET, fetch_material, lambert_blinn_phong, secondary_ray

F32 = np.float32

DEFAULT_PIXEL_TILE = 8192


def _f(x) -> float:
    return float(F32(x))


def trace_sample(scene: SceneArrays, params: FrameParams, cfg: StaticConfig, px, py,
                 sample_idx: int, closest_hit: Callable[..., Hit], count=None):
    """Trace AA sample ``sample_idx`` of pixels (px, py) [N] -> (colour
    [N, 3], rays [N]): per pixel the colour and the live rays (primary or
    secondary rays alive at each bounce, plus the shadow rays cast).
    ``count(o, d, t_max)``, where given, is called with the live rays of
    each bounce (``t_max`` None: a closest hit) and the shadow rays cast
    (``t_max`` the distance to the light: any hit before it)."""
    n = px.shape[0]
    dev = px.device
    dt = scene.tri_v0.dtype
    ox, oy = camera.sample_offsets(px, py, sample_idx, cfg.aa_samples)
    o, d = camera.generate_rays(px, py, ox, oy, cfg.width, cfg.height, params.cam_to_obj,
                                params.cam_distance, params.fov_deg, params.ortho_size,
                                cfg.is_orthographic)
    if cfg.enable_motion_blur:
        # World-origin shake (compute:342-349); the uncentred
        # RandomUnitVector - 0.5 quirk.
        shake = (rng.random_unit_vector(px + float(sample_idx), py,
                                        torch.full_like(px, float(sample_idx))) - 0.5)
        o = o + shake * _f(0.2) * float(params.shutter_speed)
    o, d = o.to(dt), d.to(dt)

    color = torch.zeros((n, 3), dtype=dt, device=dev)
    atten = torch.ones((n, 3), dtype=dt, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rays = torch.zeros(n, dtype=torch.float32, device=dev)
    num_lights = int(params.light_pos.shape[0]) if cfg.multi_light else 1
    background = torch.as_tensor(params.background, device=dev).to(dt)
    light_pos = torch.as_tensor(params.light_pos, device=dev).to(dt)
    light_rgb = torch.as_tensor(params.light_rgb, device=dev).to(dt)
    white = torch.ones(3, dtype=dt, device=dev)
    intensity = float(params.light_intensity)

    for depth in range(cfg.max_depth):
        if depth > 0 and not bool(alive.any()):
            break
        rays = rays + alive.to(torch.float32)
        if count is not None:
            count(o[alive], d[alive], None)
        h = closest_hit(scene, o, d)

        # A miss adds the attenuated background once, then the ray dies
        # (compute:364-368).
        miss = alive & ~h.hit
        color = color + torch.where(miss[:, None], atten * background, 0.0)
        alive = alive & h.hit

        mat = fetch_material(scene, h.material)
        local = torch.zeros((n, 3), dtype=dt, device=dev)
        if cfg.enable_ambient:
            local = local + mat.color * mat.ambient[:, None]

        view_dir = -d  # d is a unit vector
        depth_f = float(depth)
        for li in range(num_lights):
            lpos = light_pos[li]
            if cfg.enable_soft_shadows:
                # Jittered light position (compute:383-388).
                jitter = rng.random_unit_vector(
                    px + _f(sample_idx * 9.0),
                    py + _f(sample_idx * 4.0) + depth_f,
                    torch.full_like(px, float(sample_idx)),
                ) * float(params.light_size)
                lpos = lpos + jitter.to(dt)

            to_light = lpos - h.position
            dist_to_light = _sqrt(_dot(to_light, to_light))
            light_dir = normalize(to_light)
            n_dot_l = torch.maximum(torch.zeros_like(dist_to_light), _dot(h.normal, light_dir))

            if cfg.enable_diffuse:
                cast = alive & (n_dot_l > 0.0)
                rays = rays + cast.to(torch.float32)
                s_o = h.position + h.normal * OFFSET
                if count is not None:
                    count(s_o[cast], light_dir[cast], dist_to_light[cast])
                sh = closest_hit(scene, s_o, light_dir)
                lit = ~sh.hit | (sh.t > dist_to_light)
            else:
                lit = torch.ones(n, dtype=torch.bool, device=dev)

            rgb = light_rgb[li] if cfg.multi_light else white
            local = local + lambert_blinn_phong(mat, h.normal, light_dir, view_dir, n_dot_l, lit,
                                                rgb, cfg.enable_diffuse, cfg.enable_specular)

        color = color + torch.where(alive[:, None], atten * local * intensity, 0.0)

        sec = secondary_ray(mat, h.position, h.normal, d, cfg.enable_refraction)
        next_dir = sec.next_dir
        if cfg.enable_glossy:
            # Perturb the continuation (compute:459-470).
            jitter = rng.random_unit_vector(
                px + _f(sample_idx * 55.0) + depth_f,
                py + _f(sample_idx * 22.0),
                torch.full_like(px, 13.0) * depth_f,
            ) * float(params.surface_roughness)
            next_dir = normalize(next_dir + jitter.to(dt))

        cont = alive & sec.continue_ray
        atten = torch.where(cont[:, None], atten * sec.atten_mult, atten)
        o = torch.where(cont[:, None], sec.next_origin, o)
        d = torch.where(cont[:, None], normalize(next_dir), d)
        # Exact-zero attenuation contributes nothing downstream; kill it.
        max_at = torch.maximum(torch.maximum(atten[:, 0], atten[:, 1]), atten[:, 2])
        alive = cont & (max_at > 0.0)
    return color, rays


def trace_pixels(scene: SceneArrays, params: FrameParams, cfg: StaticConfig, px, py,
                 closest_hit: Callable[..., Hit] = closest_hit_brute, count=None):
    """The mean of ``cfg.aa_samples`` traced samples per pixel -> (colour
    [N, 3], rays [N] summed over the samples)."""
    accum, rays = trace_sample(scene, params, cfg, px, py, 0, closest_hit, count)
    for i in range(1, cfg.aa_samples):
        c, r = trace_sample(scene, params, cfg, px, py, i, closest_hit, count)
        accum = accum + c
        rays = rays + r
    return _div(accum, float(cfg.aa_samples)), rays


def render_image(scene: SceneArrays, params: FrameParams, cfg: StaticConfig,
                 closest_hit: Callable[..., Hit] = closest_hit_brute,
                 pixel_tile: int = DEFAULT_PIXEL_TILE, row_offset: int = 0,
                 rows: int | None = None, with_rays: bool = False):
    """Render global rows [row_offset, row_offset + rows) -> image [rows,
    W, 3] f32 on the scene's device (row 0 at the bottom), and with
    ``with_rays`` the live-ray count (an int, summed exactly).

    The projection plane and the RNG seeds always use the global
    ``cfg.width`` x ``cfg.height``; only the rendered band is restricted.
    Pixels go through in tiles of ``pixel_tile``; a pixel's result does not
    depend on its tile."""
    if cfg.debug_mode != 0:
        raise ValueError("the reference renders no debug view")
    dev = scene.tri_v0.device
    w, h = cfg.width, (cfg.height if rows is None else int(rows))
    n = w * h
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    px = xs.reshape(-1)
    py = ys.reshape(-1) + float(row_offset)
    out, rays = [], 0
    for lo in range(0, n, pixel_tile):
        c, r = trace_pixels(scene, params, cfg, px[lo:lo + pixel_tile], py[lo:lo + pixel_tile], closest_hit)
        out.append(c)
        rays += int(r.to(torch.int64).sum())
    img = torch.cat(out).reshape(h, w, 3)
    return (img, rays) if with_rays else img
