"""Analytic (non-tessellated) sphere and box instances.

Counterpart of :mod:`cosig_tpu.ops.analytic`. The host table
(``_instance_tables`` and ``pack_prims_host``, ``analytic.py:62-110``) is
numpy. With ``RenderSettings.analytic_primitives`` the mesh is clustered
without its spheres and boxes, and every kernel traversal
(``kernel_core.traverse`` and ``csrc/traverse.cuh``) folds these instances
in after the cluster walk: the ray goes into each instance's object space
by the inverse matrix and meets the unit sphere (radius 1) or the unit
cube ([-0.5, 0.5]^3); the normal comes back by the inverse-transpose.

The oracle path's analytic mode (:class:`AnalyticPrims`,
:func:`closest_hit_analytic`, ``analytic.py:37-88,113-188``) does the same
on [N, P] tensors after the brute-force triangle scan. The object-space
direction is not renormalized, so t stays in world parameterization.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cosig_tpu_torch.models.scene import SceneData
from cosig_tpu_torch.ops import intersect
from cosig_tpu_torch.ops.intersect import INF, Hit
from cosig_tpu_torch.scene import transforms as tf

F = np.float32

PRIM_COLS = 22  # 12 inverse-matrix entries, 9 inverse-transpose entries, material


def _instance_tables(scene: SceneData, prims):
    """Inverse [P, 3, 4], inverse-transpose [P, 3, 3] and material [P] tables."""
    if not prims:
        return (
            np.zeros((0, 3, 4), F), np.zeros((0, 3, 3), F),
            np.zeros((0,), np.int32),
        )
    inv = np.stack(
        [tf.inverse(tf.build_matrix(scene, p.transformation_index))[:3, :4] for p in prims]
    ).astype(F)
    nrm = np.stack(
        [tf.normal_matrix(tf.build_matrix(scene, p.transformation_index))[:3, :3] for p in prims]
    ).astype(F)
    mat = np.array([p.material_index for p in prims], np.int32)
    return inv, nrm, mat


def pack_prims_host(scene: SceneData):
    """-> (table [P, 22] f32, n_sph, n_box): per instance the 12 entries of
    the 3x4 inverse matrix, the 9 of the inverse-transpose and the material
    index, spheres first. Always at least one row (zeros), so the table is
    never empty."""
    rows = []
    for prims in (scene.spheres, scene.boxes):
        inv, nrm, mat = _instance_tables(scene, prims)
        for i in range(inv.shape[0]):
            rows.append(
                np.concatenate([inv[i].reshape(12), nrm[i].reshape(9), np.array([mat[i]], F)])
            )
    n_sph, n_box = len(scene.spheres), len(scene.boxes)
    if not rows:
        return np.zeros((1, PRIM_COLS), F), 0, 0
    return np.stack(rows).astype(F), n_sph, n_box


@dataclass(frozen=True)
class AnalyticPrims:
    """Sphere and box instance tables on one device: ``*_inv`` the 3x4
    inverse (world -> object) matrix, ``*_nrm`` the 3x3 inverse-transpose,
    ``*_mat`` the material index."""

    sph_inv: torch.Tensor  # [S, 3, 4]
    sph_nrm: torch.Tensor  # [S, 3, 3]
    sph_mat: torch.Tensor  # [S] int64
    box_inv: torch.Tensor  # [B, 3, 4]
    box_nrm: torch.Tensor  # [B, 3, 3]
    box_mat: torch.Tensor  # [B] int64


def compile_analytic(scene: SceneData, device="cpu") -> AnalyticPrims:
    """The instance tables of the scene's spheres and boxes on ``device``."""
    tables = []
    for prims in (scene.spheres, scene.boxes):
        inv, nrm, mat = _instance_tables(scene, prims)
        tables += [torch.as_tensor(inv, device=device), torch.as_tensor(nrm, device=device),
                   torch.as_tensor(mat, dtype=torch.int64, device=device)]
    return AnalyticPrims(*tables)


def _mat3(m, v):
    """m [..., 3, k>=3] times v [..., 3] over the first three columns,
    each row summed as (x + y) + z."""
    return torch.stack([(m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1])
                        + m[..., i, 2] * v[..., 2] for i in range(3)], dim=-1)


def _to_object(inv, o, d):
    """Rays into each instance's object space: inv [P, 3, 4]; o, d [N, 3]
    -> ([N, P, 3], [N, P, 3]); the direction is not normalized."""
    o_obj = _mat3(inv[None], o[:, None, :]) + inv[None, :, :, 3]
    d_obj = _mat3(inv[None], d[:, None, :])
    return o_obj, d_obj


def _closest_over_prims(valid, t):
    """Per ray, the first primitive of least t -> (hit, t, idx)."""
    t = torch.where(valid, t, INF)
    idx = torch.argmin(t, dim=1)
    t_best = t[torch.arange(t.shape[0], device=t.device), idx]
    return t_best < INF, t_best, idx


def _fold(best: Hit, o, d, inv, nrm, mat, unit_hit) -> Hit:
    """Fold one primitive kind into ``best``: strictly nearer wins."""
    n, p = o.shape[0], inv.shape[0]
    o_obj, d_obj = _to_object(inv, o, d)
    valid, t, n_obj = unit_hit(o_obj.reshape(-1, 3), d_obj.reshape(-1, 3))
    hit_p, t_p, idx = _closest_over_prims(valid.reshape(n, p), t.reshape(n, p))
    n_sel = n_obj.reshape(n, p, 3)[torch.arange(n, device=o.device), idx]
    n_world = intersect.normalize(_mat3(nrm[idx], n_sel))
    better = hit_p & (t_p < best.t)
    return Hit(
        hit=best.hit | better,
        t=torch.where(better, t_p, best.t),
        position=torch.where(better[:, None], o + t_p[:, None] * d, best.position),
        normal=torch.where(better[:, None], n_world, best.normal),
        material=torch.where(better, mat[idx], best.material),
    )


def closest_hit_analytic(scene_arrays, prims: AnalyticPrims, o, d, chunk: int = 256) -> Hit:
    """Closest hit over the triangles, then the analytic spheres
    (HittableObjects.cs:83-108; normal = the object-space hit point through
    the inverse-transpose), then the boxes (:182-224)."""
    best = intersect.closest_hit_brute(scene_arrays, o, d, chunk)
    if prims.sph_inv.shape[0] > 0:
        best = _fold(best, o, d, prims.sph_inv, prims.sph_nrm, prims.sph_mat,
                     intersect.intersect_unit_sphere)
    if prims.box_inv.shape[0] > 0:
        best = _fold(best, o, d, prims.box_inv, prims.box_nrm, prims.box_mat,
                     intersect.intersect_unit_box)
    return best
