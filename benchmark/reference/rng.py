"""Deterministic hash RNG on float32 tensors: a frozen copy of the port's
``ops/rng.py`` (upstream ``BVHRayTracing.compute:108-131``), which the
benchmark does not import.

The hash is plain float32 arithmetic on the pixel and sample indices, so
it is ported exactly: the same operations in the same order give the same
bits as the JAX package and as ``csrc/rng.cuh``. Only the sine and cosine
of :func:`random_unit_vector` may differ in the last bit.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.intersect import _sqrt


def _f(x) -> float:
    """A Python float holding the float32 value of ``x`` (exact in f32 ops)."""
    return float(np.float32(x))


TWO_PI = _f(6.2831853)


def _frac(x: torch.Tensor) -> torch.Tensor:
    """HLSL frac: x - floor(x) (frac(-0.1) = 0.9)."""
    return x - torch.floor(x)


def hash22(px: torch.Tensor, py: torch.Tensor):
    """compute:108-113 -> (h0, h1), each the shape of ``px``."""
    p3x = _frac(px * _f(0.1031))
    p3y = _frac(py * _f(0.1030))
    p3z = _frac(px * _f(0.0973))
    c = _f(33.33)
    d = p3x * (p3y + c) + p3y * (p3z + c) + p3z * (p3x + c)
    p3x = p3x + d
    p3y = p3y + d
    p3z = p3z + d
    return _frac((p3x + p3y) * p3z), _frac((p3x + p3z) * p3y)


def hash33(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor):
    """compute:116-121 -> (h0, h1, h2)."""
    x = _frac(px * _f(0.1031))
    y = _frac(py * _f(0.1030))
    z = _frac(pz * _f(0.0973))
    c = _f(33.33)
    d = x * (y + c) + y * (x + c) + z * (z + c)
    x = x + d
    y = y + d
    z = z + d
    return _frac((x + y) * z), _frac((x + x) * y), _frac((y + x) * x)


def random_unit_vector_planes(sx, sy, sz):
    """compute:124-131 — a point on the unit sphere from a 3D seed, as three
    planes (x, y, z) the shape of the seeds."""
    h0, _, h2 = hash33(sx, sy, sz)
    z = h2 * 2.0 - 1.0
    a = h0 * TWO_PI
    r = _sqrt(torch.maximum(torch.zeros_like(z), 1.0 - z * z))
    return r * torch.cos(a), r * torch.sin(a), z


def random_unit_vector(sx, sy, sz):
    """:func:`random_unit_vector_planes` stacked -> [*seed_shape, 3]."""
    return torch.stack(random_unit_vector_planes(sx, sy, sz), dim=-1)
