"""Procedural benchmark scenes matching the BASELINE.json configs.

BASELINE.json "configs" (paraphrased):

1. single diffuse sphere + ground triangle pair, 1 light, 256x256, depth 1
2. COSIG-style box walls + 3 spheres, 2 lights, 512x512, depth 1
3. mirror-sphere scene, specular reflections, depth 3, 512x512
4. glass-sphere scene, refraction, depth 6, 1024x1024, 4x AA
5. large mesh (10k+ tris) with acceleration, full reflect+refract, 2048x2048

``large_mesh_aa4`` is config 5 at the upstream UI's AA 4 (its AA control
cycles 1, 2, 4, 8): 2^24 camera rays, past one wavefront band.
``glass_sphere_drt`` is config 4 with the upstream's three distributed
ray tracing effects on at the first non-zero entry of each of the UI's
menus (SceneBuilder.cs:62,69,481; models/preset.py): soft shadows of
light size 5, glossy reflection of roughness 0.05 and motion blur of
shutter speed 0.5. The JAX package has neither entry; the rest are its
configs unchanged.

These are built programmatically (not copied from the reference's scene
assets) via the same SceneData model the parser produces, so every config
exercises the full compilation pipeline.

The port's copy of :mod:`cosig_tpu.scene.generate`.
"""

from __future__ import annotations

import math

import numpy as np

from cosig_tpu_torch.models.scene import (
    BoxDescription,
    CameraSettings,
    CompositeTransformation,
    ImageSettings,
    LightSource,
    MaterialDescription,
    SceneData,
    SphereDescription,
    TransformElement,
    Triangle,
    TrianglesMesh,
)
from cosig_tpu_torch.models.preset import BLUR_SPEEDS, GLOSSY_ROUGHNESS, SHADOW_SIZES
from cosig_tpu_torch.models.settings import RenderSettings

T = TransformElement


def _base(width: int, height: int, bg=(0.15, 0.18, 0.22)) -> SceneData:
    s = SceneData(image=ImageSettings(width, height, bg))
    s.transformations.append(CompositeTransformation())  # 0: identity
    # 1: camera — pulled back and tilted down slightly.
    s.transformations.append(
        CompositeTransformation([T.translation((0, 2, -26)), T.rotation_x(-12)])
    )
    s.camera = CameraSettings(transformation_index=1, distance=30.0, vertical_fov_deg=35.0)
    return s


def _ground(s: SceneData, mat: int, size: float = 60.0, z: float = -6.0) -> None:
    s.triangle_meshes.append(
        TrianglesMesh(
            transformation_index=0,
            triangles=[
                Triangle(mat, (-size, -size, z), (size, -size, z), (size, size, z)),
                Triangle(mat, (size, size, z), (-size, size, z), (-size, -size, z)),
            ],
        )
    )


def _add_light(s: SceneData, pos, rgb=(1.0, 1.0, 1.0)) -> None:
    s.transformations.append(CompositeTransformation([T.translation(pos)]))
    s.lights.append(
        LightSource(transformation_index=len(s.transformations) - 1, rgb=rgb)
    )


def _add_sphere(s: SceneData, pos, scale, mat: int) -> None:
    s.transformations.append(
        CompositeTransformation([T.translation(pos), T.scale((scale,) * 3)])
    )
    s.spheres.append(
        SphereDescription(
            transformation_index=len(s.transformations) - 1, material_index=mat
        )
    )


def config1_diffuse_sphere():
    """Single diffuse sphere + ground pair, 1 light, 256x256, depth 1."""
    s = _base(256, 256)
    s.materials.append(MaterialDescription((0.9, 0.9, 0.9), 0.1, 0.7, 0, 0, 1))  # ground
    s.materials.append(MaterialDescription((0.9, 0.3, 0.2), 0.1, 0.8, 0, 0, 1))  # sphere
    _ground(s, 0)
    _add_sphere(s, (0, 0, -2), 4.0, 1)
    _add_light(s, (15, -20, 30))
    return s, RenderSettings(max_depth=1)


def config2_cosig_walls():
    """Box walls + 3 spheres, 2 lights, 512x512, depth 1, hard shadows."""
    s = _base(512, 512)
    s.materials.append(MaterialDescription((0.8, 0.8, 0.8), 0.1, 0.7, 0, 0, 1))  # floor
    s.materials.append(MaterialDescription((0.8, 0.2, 0.2), 0.1, 0.7, 0, 0, 1))  # left
    s.materials.append(MaterialDescription((0.2, 0.8, 0.2), 0.1, 0.7, 0, 0, 1))  # right
    s.materials.append(MaterialDescription((0.3, 0.4, 0.9), 0.1, 0.7, 0, 0, 1))
    s.materials.append(MaterialDescription((0.9, 0.8, 0.3), 0.1, 0.7, 0, 0, 1))
    s.materials.append(MaterialDescription((0.9, 0.4, 0.8), 0.1, 0.7, 0, 0, 1))
    _ground(s, 0)
    # Walls as flattened boxes.
    for pos, scale, mat in [
        ((-16, 0, 4), (1, 32, 20), 1),
        ((16, 0, 4), (1, 32, 20), 2),
        ((0, 16, 4), (32, 1, 20), 0),
    ]:
        s.transformations.append(
            CompositeTransformation([T.translation(pos), T.scale(scale)])
        )
        s.boxes.append(BoxDescription(len(s.transformations) - 1, mat))
    _add_sphere(s, (-7, 0, -2), 3.5, 3)
    _add_sphere(s, (0, 5, -3), 3.0, 4)
    _add_sphere(s, (7, -2, -2.5), 3.2, 5)
    _add_light(s, (10, -18, 25))
    _add_light(s, (-12, -10, 18), rgb=(0.6, 0.6, 1.0))
    return s, RenderSettings(max_depth=1, multi_light=True)


def config3_mirror_sphere():
    """Mirror sphere, specular reflections, depth 3, 512x512."""
    s = _base(512, 512)
    s.materials.append(MaterialDescription((0.7, 0.7, 0.75), 0.1, 0.6, 0, 0, 1))  # checker-ish floor
    s.materials.append(MaterialDescription((1.0, 1.0, 1.0), 0.02, 0.1, 0.9, 0, 1))  # mirror
    s.materials.append(MaterialDescription((0.9, 0.3, 0.2), 0.1, 0.7, 0, 0, 1))
    s.materials.append(MaterialDescription((0.2, 0.5, 0.9), 0.1, 0.7, 0.2, 0, 1))
    _ground(s, 0)
    _add_sphere(s, (0, 0, -1), 4.5, 1)
    _add_sphere(s, (-9, -4, -3.5), 2.2, 2)
    _add_sphere(s, (9, 2, -3), 2.8, 3)
    _add_light(s, (12, -22, 28))
    return s, RenderSettings(max_depth=3)


def config4_glass_sphere():
    """Glass sphere, refraction, depth 6, 1024x1024, 4x AA."""
    s = _base(1024, 1024)
    s.materials.append(MaterialDescription((0.75, 0.75, 0.8), 0.1, 0.65, 0, 0, 1))
    s.materials.append(MaterialDescription((1.0, 1.0, 1.0), 0.0, 0.05, 0.1, 0.9, 1.5))  # glass
    s.materials.append(MaterialDescription((0.9, 0.6, 0.2), 0.1, 0.7, 0, 0, 1))
    s.materials.append(MaterialDescription((0.3, 0.8, 0.4), 0.1, 0.7, 0, 0, 1))
    _ground(s, 0)
    _add_sphere(s, (0, 0, -1.5), 4.0, 1)
    _add_sphere(s, (-8, 6, -3), 2.5, 2)
    _add_sphere(s, (8, 5, -3.5), 2.2, 3)
    _add_light(s, (14, -20, 26))
    return s, RenderSettings(max_depth=6, aa_samples=4)


def _torus_knot_mesh(mat: int, p: int = 2, q: int = 3, segs: int = 400, sides: int = 14,
                     radius: float = 6.0, tube: float = 1.6):
    """Procedural (p,q) torus-knot tube: segs*sides*2 triangles (10k+)."""
    ts = np.linspace(0, 2 * np.pi, segs, endpoint=False)

    def center(t):
        r = radius * (2 + np.cos(q * t)) / 3.0
        return np.stack(
            [r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t) * 2.5], axis=-1
        )

    c = center(ts)
    c_next = center(ts + 2 * np.pi / segs)
    tangent = c_next - c
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    # Frame via arbitrary up.
    up = np.array([0.0, 0.0, 1.0])
    n1 = np.cross(tangent, up)
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 = np.cross(tangent, n1)

    phis = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    ring = (
        c[:, None, :]
        + tube * (np.cos(phis)[None, :, None] * n1[:, None, :]
                  + np.sin(phis)[None, :, None] * n2[:, None, :])
    )  # [segs, sides, 3]

    tris = []
    for i in range(segs):
        i2 = (i + 1) % segs
        for j in range(sides):
            j2 = (j + 1) % sides
            a = tuple(ring[i, j])
            b = tuple(ring[i2, j])
            cc = tuple(ring[i, j2])
            d = tuple(ring[i2, j2])
            tris.append(Triangle(mat, a, b, cc))
            tris.append(Triangle(mat, cc, b, d))
    return tris


def config5_large_mesh(resolution: int = 2048):
    """10k+ triangle mesh, full reflect+refract, 2048x2048."""
    s = _base(resolution, resolution)
    s.camera = CameraSettings(transformation_index=1, distance=34.0, vertical_fov_deg=40.0)
    s.materials.append(MaterialDescription((0.75, 0.75, 0.8), 0.1, 0.6, 0.1, 0, 1))
    s.materials.append(MaterialDescription((0.85, 0.5, 0.15), 0.1, 0.6, 0.3, 0, 1))  # knot
    s.materials.append(MaterialDescription((1.0, 1.0, 1.0), 0.0, 0.05, 0.1, 0.85, 1.5))
    _ground(s, 0)
    mesh = TrianglesMesh(transformation_index=0, triangles=_torus_knot_mesh(1))
    s.triangle_meshes.append(mesh)  # 400*14*2 = 11200 tris
    _add_sphere(s, (0, -8, -2), 3.0, 2)
    _add_light(s, (16, -22, 30))
    return s, RenderSettings(max_depth=4)


def config5_large_mesh_aa4():
    """Config 5 at AA 4: 2048x2048 x 4 samples = 2^24 camera rays."""
    s, settings = config5_large_mesh()
    return s, settings.replace(aa_samples=4)


def config4_glass_sphere_drt():
    """Config 4 with soft shadows, glossy reflection and motion blur at the
    upstream UI's first non-zero menu entries (ShadowMode 1, BlurMode 1)."""
    s, settings = config4_glass_sphere()
    return s, settings.replace(enable_soft_shadows=True, light_size=SHADOW_SIZES[1],
                               enable_glossy=True, surface_roughness=GLOSSY_ROUGHNESS,
                               enable_motion_blur=True, shutter_speed=BLUR_SPEEDS[1])


CONFIGS = {
    "diffuse_sphere": config1_diffuse_sphere,
    "cosig_walls": config2_cosig_walls,
    "mirror_sphere": config3_mirror_sphere,
    "glass_sphere": config4_glass_sphere,
    "large_mesh": config5_large_mesh,
    "large_mesh_aa4": config5_large_mesh_aa4,
    "glass_sphere_drt": config4_glass_sphere_drt,
}
