"""Ray-triangle intersection in plain PyTorch: the reference's closest hit.

A frozen copy of the port's oracle module (``ops/intersect.py``), which
the benchmark does not import: the brute-force (rays x triangles) test in
blocks of 256 triangles with a running minimum, and the slab test. The
float type follows the rays: float32 in the reference, bfloat16 in its
lower-precision control.

For a ray (o, d) with moment w = o x d, the signed edge volume of edge
P->Q is V(P,Q) = d . (P x Q) + w . (Q - P), linear in (d, w). The ray
pierces the triangle iff V(B,C), V(C,A), V(A,B) share a sign; u =
V(C,A)/S, v = V(A,B)/S, S = d . n and t = (n.A - n.o) / S — the
reference's Möller-Trumbore test and epsilons
(BVHRayTracing.compute:153-179). The manual-xyz cross products fix the
canonical component order everywhere.

Vectors are [..., 3] tensors with the component axis last. Every sum over
components is written out as ``(x + y) + z`` and every division and root
is IEEE on every device: PyTorch's CUDA ``tensor / python_scalar``
multiplies by the reciprocal, so :func:`_div` divides by a tensor, and
PyTorch's vectorized float32 sqrt on an AVX-512 CPU is not always
correctly rounded, so :func:`_sqrt` takes the root in float64 and rounds
once. The port's kernels round alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32 = np.float32

EPSILON = float(F32(1e-4))  # compute:102
INF = float(F32(3.402823466e38))  # compute:101 (HLSL float max, used as "infinity")


def inf_of(dtype) -> float:
    """The type's largest finite value: INF in float32 (the same number),
    the bfloat16 maximum in the control."""
    return float(torch.finfo(dtype).max)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """IEEE ``a / b`` for a Python scalar ``b`` on any device."""
    return torch.div(a, torch.full_like(a, b))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt in ``x``'s float type on any device."""
    return torch.sqrt(x.double()).to(x.dtype)


class Hit(NamedTuple):
    """Closest-hit record for a batch of rays (SoA HitRecord, compute:22-29)."""

    hit: torch.Tensor  # [N] bool
    t: torch.Tensor  # [N] f32 (INF when miss)
    position: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3] interpolated, normalized
    material: torch.Tensor  # [N] int64 (-1 when miss)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def normalize(v):
    """1/sqrt, then multiply (not rsqrt), as every path normalizes."""
    return v * torch.reciprocal(_sqrt(_dot(v, v))).unsqueeze(-1)


def reflect(i, n):
    """HLSL reflect: i - 2*dot(i,n)*n."""
    return i - (2.0 * _dot(i, n)).unsqueeze(-1) * n


def _cross(p, q):
    return (
        p[..., 1] * q[..., 2] - p[..., 2] * q[..., 1],
        p[..., 2] * q[..., 0] - p[..., 0] * q[..., 2],
        p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0],
    )


def ray_triangle(o, d, a, b, c):
    """The pair test on broadcast shapes: o, d [..., 1, 3] against
    triangles a, b, c [..., B, 3] -> (valid, t, u, v), each [..., B]; t is
    INF where invalid. The operation order is ``moller_trumbore``'s
    (``intersect.py:117-167``)."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    # Ray moment w = o x d (canonical component order).
    wx, wy, wz = _cross(o, d)
    n_x, n_y, n_z = _cross(b - a, c - a)
    n_dot_a = n_x * a[..., 0] + n_y * a[..., 1] + n_z * a[..., 2]

    def vol(p, q):
        # V(P,Q) = d . (P x Q) + w . (Q - P)
        vd = _cross(p, q)
        return (dx * vd[0] + dy * vd[1] + dz * vd[2]
                + wx * (q[..., 0] - p[..., 0])
                + wy * (q[..., 1] - p[..., 1])
                + wz * (q[..., 2] - p[..., 2]))

    va = vol(b, c)
    vb = vol(c, a)
    vc = vol(a, b)
    s = dx * n_x + dy * n_y + dz * n_z
    n_dot_o = ox * n_x + oy * n_y + oz * n_z
    inv_s = torch.reciprocal(s)
    t = (n_dot_a - n_dot_o) * inv_s
    u = vb * inv_s
    v = vc * inv_s
    valid = (
        (torch.abs(s) >= EPSILON)
        & (va * s >= 0.0)
        & (vb * s >= 0.0)
        & (vc * s >= 0.0)
        & (t > EPSILON)
    )
    return valid, torch.where(valid, t, inf_of(t.dtype)), u, v


def moller_trumbore(o, d, v0, v1, v2):
    """Batched ray-triangle test over a (rays x triangles) grid: o, d
    [N, 3]; v0, v1, v2 [B, 3] -> (valid, t, u, v), each [N, B]."""
    return ray_triangle(o[:, None, :], d[:, None, :], v0[None], v1[None], v2[None])


def intersect_aabb(o, d_inv, box_min, box_max):
    """Slab test: distance to entry, or INF when missed (compute:199-216).
    Min and max propagate NaN."""
    t0 = (box_min - o) * d_inv
    t1 = (box_max - o) * d_inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    dst_a = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    dst_b = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
    return torch.where((dst_a > dst_b) | (dst_b < 0.0), inf_of(dst_a.dtype), dst_a)


def _hit_record(o, d, best_t, best_idx, best_u, best_v, n0, n1, n2, mat) -> Hit:
    """Winner attributes of a closest-hit scan (``intersect.py:242-254``):
    interpolated unit normal, (0, 1, 0) and material -1 on a miss, hit
    position o + t d (zero on a miss)."""
    hit = best_idx >= 0
    safe = best_idx.clamp_min(0)
    w = 1.0 - best_u - best_v
    normal = normalize(w[:, None] * n0[safe] + best_u[:, None] * n1[safe]
                       + best_v[:, None] * n2[safe])
    up = torch.tensor([0.0, 1.0, 0.0], dtype=o.dtype, device=o.device)
    normal = torch.where(hit[:, None], normal, up)
    material = torch.where(hit, mat[safe].to(torch.int64), -1)
    position = o + best_t[:, None] * d
    position = torch.where(hit[:, None], position, 0.0)
    return Hit(hit=hit, t=best_t, position=position, normal=normal, material=material)


def closest_hit_brute(scene, o, d, chunk: int = 256) -> Hit:
    """Closest hit of rays [N, 3] against every triangle of ``scene``
    (:class:`benchmark.reference.frame.SceneArrays`), in blocks of
    ``chunk`` triangles with a running minimum. Within a block the first
    of equal t wins and a later block must be strictly nearer, so the
    winner is the first triangle of least t in soup order."""
    n_rays = o.shape[0]
    T = scene.num_triangles
    if T == 0:
        return _miss(n_rays, o.device, o.dtype)
    best_t = torch.full((n_rays,), inf_of(o.dtype), dtype=o.dtype, device=o.device)
    best_idx = torch.full((n_rays,), -1, dtype=torch.int64, device=o.device)
    best_u = torch.zeros(n_rays, dtype=o.dtype, device=o.device)
    best_v = torch.zeros(n_rays, dtype=o.dtype, device=o.device)
    rows = torch.arange(n_rays, device=o.device)
    for base in range(0, T, chunk):
        sl = slice(base, base + chunk)
        _, t, u, v = moller_trumbore(o, d, scene.tri_v0[sl], scene.tri_v1[sl], scene.tri_v2[sl])
        j = torch.argmin(t, dim=1)
        t_blk = t[rows, j]
        better = t_blk < best_t
        best_t = torch.where(better, t_blk, best_t)
        best_idx = torch.where(better, base + j, best_idx)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
    return _hit_record(o, d, best_t, best_idx, best_u, best_v,
                       scene.tri_n0, scene.tri_n1, scene.tri_n2, scene.tri_mat)


def _miss(n_rays: int, device, dtype=torch.float32) -> Hit:
    return Hit(
        hit=torch.zeros(n_rays, dtype=torch.bool, device=device),
        t=torch.full((n_rays,), inf_of(dtype), dtype=dtype, device=device),
        position=torch.zeros((n_rays, 3), dtype=dtype, device=device),
        normal=torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device).expand(n_rays, 3).clone(),
        material=torch.full((n_rays,), -1, dtype=torch.int64, device=device),
    )
