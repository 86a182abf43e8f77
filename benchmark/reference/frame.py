"""Host-side frame description: static shape knobs and per-frame floats.

A frozen copy of the port's ``models/soa.py``, which the benchmark does
not import: :class:`StaticConfig` carries the same fields, :class:`FrameParams`
holds numpy float32 values, and the builders keep the reference's
override precedence (settings beat scene-file values; fallbacks fov 50,
distance 30, 256x256, background (0.2, 0.2, 0.2)).

:class:`SceneArrays` is the triangle soup and the material tables as
tensors on one device, which :mod:`benchmark.reference.trace` reads, in
float32 or, for the lower-precision control, bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.scene import SceneData
from benchmark.reference.settings import RenderSettings
from benchmark.reference import transforms as tf
from benchmark.reference.tessellate import TriangleSoA, extract_triangles

F32 = np.float32


@dataclass(frozen=True)
class SceneArrays:
    """Geometry and materials, object space, as tensors on one device."""

    tri_v0: torch.Tensor  # [T, 3] f32
    tri_v1: torch.Tensor  # [T, 3]
    tri_v2: torch.Tensor  # [T, 3]
    tri_n0: torch.Tensor  # [T, 3]
    tri_n1: torch.Tensor  # [T, 3]
    tri_n2: torch.Tensor  # [T, 3]
    tri_mat: torch.Tensor  # [T] int64
    mat_color: torch.Tensor  # [M, 3] f32
    mat_coeff: torch.Tensor  # [M, 5] f32: ambient, diffuse, specular, refraction, ior

    @property
    def num_triangles(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def num_materials(self) -> int:
        return int(self.mat_color.shape[0])


@dataclass(frozen=True)
class StaticConfig:
    """Knobs that change shapes or control flow (same fields as the JAX
    package's ``StaticConfig``)."""

    width: int
    height: int
    max_depth: int = 2
    aa_samples: int = 1
    enable_ambient: bool = True
    enable_diffuse: bool = True
    enable_specular: bool = True
    enable_refraction: bool = True
    is_orthographic: bool = False
    enable_soft_shadows: bool = False
    enable_glossy: bool = False
    enable_motion_blur: bool = False
    multi_light: bool = False
    debug_mode: int = 0


@dataclass(frozen=True)
class FrameParams:
    """Per-frame dynamic parameters, numpy float32."""

    cam_to_obj: np.ndarray  # [4, 4] camera-space -> object-space ray transform
    cam_distance: np.float32
    fov_deg: np.float32
    ortho_size: np.float32  # distance * tan(fov/2) (RayTracer.cs:187)
    background: np.ndarray  # [3]
    light_pos: np.ndarray  # [L, 3] (L = 1 in faithful mode)
    light_rgb: np.ndarray  # [L, 3] (all ones in faithful mode)
    light_intensity: np.float32
    light_size: np.float32  # soft shadows
    surface_roughness: np.float32  # glossy
    shutter_speed: np.float32  # motion blur


def materials_host(scene: SceneData) -> Tuple[np.ndarray, np.ndarray]:
    """Material tables (color [M,3], coeff [M,5]); white-diffuse fallback
    when the scene has none (RayTracer.cs:455-474)."""
    if scene.materials:
        mat_color = np.array([m.color for m in scene.materials], dtype=F32)
        mat_coeff = np.array(
            [[m.ambient, m.diffuse, m.specular, m.refraction, m.ior] for m in scene.materials],
            dtype=F32,
        )
    else:
        mat_color = np.array([[1.0, 1.0, 1.0]], dtype=F32)
        mat_coeff = np.array([[0.1, 0.7, 0.0, 0.0, 1.0]], dtype=F32)
    return mat_color, mat_coeff


def compile_scene(scene: SceneData, tris: Optional[TriangleSoA] = None,
                  device="cpu", dtype=torch.float32) -> SceneArrays:
    """Tessellate (unless ``tris`` is given) and put the soup and the
    material tables on ``device``, the floats in ``dtype`` (rounded from
    float32)."""
    if tris is None:
        tris = extract_triangles(scene)
    mat_color, mat_coeff = materials_host(scene)

    def put(a, kind=dtype):
        return torch.as_tensor(np.asarray(a, F32), device=device).to(kind)

    return SceneArrays(
        tri_v0=put(tris.v0), tri_v1=put(tris.v1), tri_v2=put(tris.v2),
        tri_n0=put(tris.n0), tri_n1=put(tris.n1), tri_n2=put(tris.n2),
        tri_mat=put(tris.material, torch.int64),
        mat_color=put(mat_color), mat_coeff=put(mat_coeff),
    )


def resolve_resolution(scene: SceneData, settings: RenderSettings) -> Tuple[int, int]:
    """Settings override > scene image > 256x256 (RayTracer.cs:221-222)."""
    if settings.resolution_override is not None:
        return int(settings.resolution_override[0]), int(settings.resolution_override[1])
    if scene.image is not None:
        return max(1, scene.image.horizontal), max(1, scene.image.vertical)
    return 256, 256


def camera_to_object_matrix(scene: SceneData, settings: RenderSettings) -> np.ndarray:
    """Camera space -> object space: the inverse of the scene's camera
    transform, or of the UI pos/rot override TRS (RayTracer.cs:224-267)."""
    using_overrides = (
        settings.camera_position_override is not None
        or settings.camera_rotation_override is not None
    )
    if using_overrides:
        pos = settings.camera_position_override or (0.0, 0.0, 0.0)
        rot = settings.camera_rotation_override or (0.0, 0.0, 0.0)
        return tf.inverse(tf.trs_euler(pos, rot))
    m_scene = tf.identity()
    if (
        scene.camera is not None
        and 0 <= scene.camera.transformation_index < len(scene.transformations)
    ):
        m_scene = tf.build_composite(
            scene.transformations[scene.camera.transformation_index]
        )
    return tf.inverse(m_scene)


def light_positions(scene: SceneData, multi_light: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Light position(s) in object space. Faithful mode: lights[0] only,
    color forced white (RayTracer.cs:165-176); multi-light: all lights
    with their RGB."""
    def pos_of(light):
        if 0 <= light.transformation_index < len(scene.transformations):
            m = tf.build_composite(scene.transformations[light.transformation_index])
            return m[:3, 3]
        return np.zeros(3, dtype=F32)

    if not scene.lights:
        return np.zeros((1, 3), dtype=F32), np.ones((1, 3), dtype=F32)
    if multi_light:
        pos = np.stack([pos_of(l) for l in scene.lights]).astype(F32)
        rgb = np.array([l.rgb for l in scene.lights], dtype=F32)
        return pos, rgb
    return pos_of(scene.lights[0]).reshape(1, 3).astype(F32), np.ones((1, 3), dtype=F32)


def frame_params(scene: SceneData, settings: RenderSettings) -> FrameParams:
    """Per-frame dynamic parameters with the reference's precedence."""
    fov = (
        settings.camera_fov_override
        if settings.camera_fov_override is not None
        else (scene.camera.vertical_fov_deg if scene.camera is not None else 50.0)
    )
    distance = scene.camera.distance if scene.camera is not None else 30.0
    bg = (
        settings.background_color_override
        if settings.background_color_override is not None
        else (scene.image.background if scene.image is not None else (0.2, 0.2, 0.2))
    )
    lp, lrgb = light_positions(scene, settings.multi_light)
    # float32 throughout, as the JAX package computes it.
    ortho_size = F32(distance) * np.tan(np.deg2rad(F32(fov)) * F32(0.5))

    return FrameParams(
        cam_to_obj=np.asarray(camera_to_object_matrix(scene, settings), F32),
        cam_distance=F32(distance),
        fov_deg=F32(fov),
        ortho_size=F32(ortho_size),
        background=np.asarray(bg, dtype=F32),
        light_pos=np.asarray(lp, F32),
        light_rgb=np.asarray(lrgb, F32),
        light_intensity=F32(settings.light_intensity_scale),
        light_size=F32(settings.light_size),
        surface_roughness=F32(settings.surface_roughness),
        shutter_speed=F32(settings.shutter_speed),
    )


def static_config(scene: SceneData, settings: RenderSettings) -> StaticConfig:
    width, height = resolve_resolution(scene, settings)
    return StaticConfig(
        width=width,
        height=height,
        max_depth=settings.max_depth,
        aa_samples=max(1, settings.aa_samples),
        enable_ambient=settings.enable_ambient,
        enable_diffuse=settings.enable_diffuse,
        enable_specular=settings.enable_specular,
        enable_refraction=settings.enable_refraction,
        is_orthographic=settings.is_orthographic,
        enable_soft_shadows=settings.enable_soft_shadows,
        enable_glossy=settings.enable_glossy,
        enable_motion_blur=settings.enable_motion_blur,
        multi_light=settings.multi_light,
        debug_mode=settings.debug_mode,
    )
