"""Blinn-Phong shading and the secondary-ray policy of the reference: a
frozen copy of the port's ``ops/shade.py``, which the benchmark does not
import. The upstream shader is ``BVHRayTracing.compute:360-473``, with its
quirks:

* only the shadow-tested diffuse branch holds the specular highlight
  (``_EnableSpecular`` gates the highlight but not recursive reflection);
* refraction wins over reflection when both apply;
* total internal reflection falls back to reflection about the flipped
  normal with ``matColor * kSpecular`` attenuation, even when kSpecular
  is 0 (the ray stays alive with zero attenuation);
* the highlight is white, exponent 32 (``torch.pow``, as the JAX package's
  ``jnp.power``; the kernels square five times instead);
* shadow bias ``normal * 1e-2``; secondary origins offset by ``1e-2``.

Rays are [N] and vectors [N, 3].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.intersect import _dot, _sqrt, normalize, reflect

OFFSET = float(np.float32(1e-2))  # Epsilon * 100
SPECULAR_EXP = 32.0

# Material of a miss (compute:371-376): ambient, diffuse, specular,
# refraction, ior; colour white.
_MISS_COEFF = (0.1, 0.7, 0.0, 0.0, 1.0)


class Material(NamedTuple):
    color: torch.Tensor  # [N, 3]
    ambient: torch.Tensor  # [N]
    diffuse: torch.Tensor
    specular: torch.Tensor
    refraction: torch.Tensor
    ior: torch.Tensor


def fetch_material(scene, mat_idx) -> Material:
    """Gather the materials of ``mat_idx`` [N]; -1 (a miss) gives the
    shader's defaults."""
    invalid = mat_idx < 0
    safe = mat_idx.clamp(0, scene.num_materials - 1)
    color = torch.where(invalid[:, None], 1.0, scene.mat_color[safe])
    defaults = torch.tensor(_MISS_COEFF, dtype=scene.mat_coeff.dtype, device=mat_idx.device)
    coeff = torch.where(invalid[:, None], defaults, scene.mat_coeff[safe])
    return Material(color=color, ambient=coeff[:, 0], diffuse=coeff[:, 1],
                    specular=coeff[:, 2], refraction=coeff[:, 3], ior=coeff[:, 4])


def lambert_blinn_phong(mat: Material, normal, light_dir, view_dir, n_dot_l, lit, light_rgb,
                        enable_diffuse: bool, enable_specular: bool):
    """The shadow-tested diffuse and highlight term (compute:393-416).
    ``lit`` holds the shadow test; this adds the n.l > 0 gate.
    ``light_rgb`` [3] is white unless multi-light."""
    if not enable_diffuse:
        return torch.zeros_like(mat.color)
    contrib = mat.color * mat.diffuse[:, None] * n_dot_l[:, None]
    if enable_specular:
        half = normalize(light_dir + view_dir)
        zeros = torch.zeros_like(n_dot_l)
        spec = torch.pow(torch.maximum(_dot(normal, half), zeros), SPECULAR_EXP)
        contrib = contrib + (mat.specular * spec)[:, None]  # white * kS * spec
    gate = (lit & (n_dot_l > 0.0))[:, None]
    return torch.where(gate, contrib * light_rgb, 0.0)


class Secondary(NamedTuple):
    next_origin: torch.Tensor  # [N, 3]
    next_dir: torch.Tensor  # [N, 3]
    atten_mult: torch.Tensor  # [N, 3]
    continue_ray: torch.Tensor  # [N] bool


def secondary_ray(mat: Material, position, normal, ray_dir, enable_refraction: bool) -> Secondary:
    """The reflection or refraction continuation (compute:420-455).
    ``ray_dir`` is a unit vector."""
    should_reflect = mat.specular > 0.0
    should_refract = (mat.refraction > 0.0) & enable_refraction

    i = ray_dir
    cos_in = _dot(i, normal)
    exiting = cos_in > 0.0
    n = torch.where(exiting[:, None], -normal, normal)
    eta = torch.where(exiting, mat.ior, torch.reciprocal(mat.ior))
    cos = _dot(-i, n)
    k = 1.0 - eta * eta * (1.0 - cos * cos)
    tir = k < 0.0
    root = _sqrt(torch.maximum(k, torch.zeros_like(k)))
    refr_dir = eta[:, None] * i + (eta * cos - root)[:, None] * n
    refl_flipped = reflect(i, n)  # the TIR branch reflects about the flipped normal
    refl_plain = reflect(i, normal)  # a plain mirror about hit.normal

    ks_mult = mat.color * mat.specular[:, None]
    kr_mult = mat.color * mat.refraction[:, None]

    use_refract = should_refract[:, None]
    tir3 = tir[:, None]
    next_dir = torch.where(use_refract, torch.where(tir3, refl_flipped, refr_dir), refl_plain)
    atten_mult = torch.where(use_refract, torch.where(tir3, ks_mult, kr_mult), ks_mult)
    start = torch.where(
        use_refract,
        torch.where(tir3, position + n * OFFSET, position + refr_dir * OFFSET),
        position + normal * OFFSET,
    )
    return Secondary(next_origin=start, next_dir=next_dir, atten_mult=atten_mult,
                     continue_ray=should_reflect | should_refract)
