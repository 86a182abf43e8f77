"""Analytic (non-tessellated) sphere and box instances: the host table.

Counterpart of the host half of :mod:`cosig_tpu.ops.analytic`
(``_instance_tables`` and ``pack_prims_host``, ``analytic.py:62-110``), in
numpy; the JAX module imports jax, so the port owns this copy. With
``RenderSettings.analytic_primitives`` the mesh is clustered without its
spheres and boxes, and every traversal (``kernel_core.traverse`` and
``csrc/traverse.cuh``) folds these instances in after the cluster walk:
the ray goes into each instance's object space by the inverse matrix and
meets the unit sphere (radius 1) or the unit cube ([-0.5, 0.5]^3); the
normal comes back by the inverse-transpose.
"""

from __future__ import annotations

import numpy as np

from cosig_tpu_torch.models.scene import SceneData
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
