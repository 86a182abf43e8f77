"""Tessellation of scene primitives into triangle SoA arrays (object space).

Parity reference: ``Assets/Services/SceneGeometryConverter.cs``:

* meshes: transform vertices by the object matrix, flat face normals
  (``:23-34``, ``CreateGPUTriangle :56-60``);
* boxes: unit cube (-0.5..+0.5), 12 triangles, flat normals, the exact
  winding table of ``AddCube :120-155``;
* spheres: UV sphere radius 1, 24 longitude x 16 latitude = 768 triangles
  (24 top cap + 15*24*2 band + 24 bottom cap, ``AddSphere :161-230``),
  smooth per-vertex normals = normalized object-space position transformed
  by the inverse-transpose (``AddSmoothTri :245-263``).

All geometry is produced in object space (object transforms applied, no
camera transform) so the acceleration structure stays static under camera
motion — the same architectural decision as the reference (``:11-17``).

Unlike the reference's AoS ``List<GPUTriangle>``, output is SoA numpy.

A frozen copy of the port's ``scene/tessellate.py``, which the benchmark
does not import.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference.scene import SceneData
from benchmark.reference import transforms as tf

F32 = np.float32


@dataclass
class TriangleSoA:
    """Structure-of-arrays triangle soup (the reference's GPUTriangle)."""

    v0: np.ndarray  # [T, 3] f32
    v1: np.ndarray  # [T, 3]
    v2: np.ndarray  # [T, 3]
    n0: np.ndarray  # [T, 3] per-vertex normals (flat: face normal repeated)
    n1: np.ndarray  # [T, 3]
    n2: np.ndarray  # [T, 3]
    material: np.ndarray  # [T] i32

    @property
    def count(self) -> int:
        return int(self.v0.shape[0])

    @property
    def centers(self) -> np.ndarray:
        """Centroids for BVH partitioning (GPUTriangle.center, BVHBuilder.cs:18)."""
        return ((self.v0 + self.v1 + self.v2) / F32(3.0)).astype(F32)

    @staticmethod
    def empty() -> "TriangleSoA":
        z = np.zeros((0, 3), dtype=F32)
        return TriangleSoA(z, z, z, z, z, z, np.zeros((0,), dtype=np.int32))

    @staticmethod
    def concatenate(parts: list) -> "TriangleSoA":
        parts = [p for p in parts if p.count > 0]
        if not parts:
            return TriangleSoA.empty()
        return TriangleSoA(
            *(
                np.concatenate([getattr(p, f) for p in parts], axis=0)
                for f in ("v0", "v1", "v2", "n0", "n1", "n2", "material")
            )
        )

    def take(self, idx: np.ndarray) -> "TriangleSoA":
        return TriangleSoA(
            self.v0[idx], self.v1[idx], self.v2[idx],
            self.n0[idx], self.n1[idx], self.n2[idx], self.material[idx],
        )


def _transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """MultiplyPoint3x4: affine transform of [N,3] points."""
    return (pts.astype(F32) @ m[:3, :3].T + m[:3, 3]).astype(F32)


def _transform_vectors(m3: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    return (vecs.astype(F32) @ m3[:3, :3].T).astype(F32)


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v.astype(F32), axis=-1, keepdims=True).astype(F32)
    n = np.where(n == 0, F32(1.0), n)
    return (v / n).astype(F32)


def _flat_tris(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, mat: np.ndarray) -> TriangleSoA:
    """Flat shading: face normal at all three vertices (CreateGPUTriangle :56-60)."""
    fn = _normalize(np.cross(v1 - v0, v2 - v0).astype(F32))
    return TriangleSoA(v0, v1, v2, fn, fn.copy(), fn.copy(), mat.astype(np.int32))


# ---------------------------------------------------------------------------
# Meshes


def _mesh_triangles(scene: SceneData, mesh) -> TriangleSoA:
    m = tf.build_matrix(scene, mesh.transformation_index)
    if not mesh.triangles:
        return TriangleSoA.empty()
    v0 = _transform_points(m, np.array([t.v0 for t in mesh.triangles], dtype=F32))
    v1 = _transform_points(m, np.array([t.v1 for t in mesh.triangles], dtype=F32))
    v2 = _transform_points(m, np.array([t.v2 for t in mesh.triangles], dtype=F32))
    mat = np.array([t.material_index for t in mesh.triangles], dtype=np.int32)
    return _flat_tris(v0, v1, v2, mat)


# ---------------------------------------------------------------------------
# Boxes — unit cube winding table (AddCube :120-155)

_CUBE_CORNERS = np.array(
    [
        [-0.5, -0.5, -0.5],
        [0.5, -0.5, -0.5],
        [0.5, 0.5, -0.5],
        [-0.5, 0.5, -0.5],
        [-0.5, -0.5, 0.5],
        [0.5, -0.5, 0.5],
        [0.5, 0.5, 0.5],
        [-0.5, 0.5, 0.5],
    ],
    dtype=F32,
)

# 12 triangles: (corner indices), order matches AddCube exactly.
_CUBE_FACES = np.array(
    [
        [0, 2, 1], [0, 3, 2],  # front  (-Z)
        [5, 7, 6], [5, 4, 7],  # back   (+Z)
        [3, 6, 2], [3, 7, 6],  # top    (+Y)
        [4, 1, 5], [4, 0, 1],  # bottom (-Y)
        [4, 3, 7], [4, 0, 3],  # left   (-X)
        [1, 6, 2], [1, 5, 6],  # right  (+X)
    ],
    dtype=np.int64,
)


def _box_triangles(scene: SceneData, box) -> TriangleSoA:
    m = tf.build_matrix(scene, box.transformation_index)
    v = _transform_points(m, _CUBE_CORNERS)
    v0, v1, v2 = v[_CUBE_FACES[:, 0]], v[_CUBE_FACES[:, 1]], v[_CUBE_FACES[:, 2]]
    mat = np.full((12,), box.material_index, dtype=np.int32)
    return _flat_tris(v0, v1, v2, mat)


# ---------------------------------------------------------------------------
# Spheres — UV sphere, smooth normals (AddSphere :161-230)

_N_LONG = 24
_N_LAT = 16


def _unit_sphere_vertices() -> np.ndarray:
    """(nbLong+1)*nbLat + 2 vertices, exact layout of AddSphere :168-193."""
    n = (_N_LONG + 1) * _N_LAT + 2
    verts = np.zeros((n, 3), dtype=F32)
    verts[0] = (0.0, 1.0, 0.0)  # top pole
    pi = F32(np.pi)
    for lat in range(_N_LAT):
        a1 = pi * F32(lat + 1) / F32(_N_LAT + 1)
        sin1, cos1 = np.sin(a1, dtype=F32), np.cos(a1, dtype=F32)
        for lon in range(_N_LONG + 1):
            a2 = F32(2.0) * pi * F32(0 if lon == _N_LONG else lon) / F32(_N_LONG)
            sin2, cos2 = np.sin(a2, dtype=F32), np.cos(a2, dtype=F32)
            verts[lon + lat * (_N_LONG + 1) + 1] = (sin1 * cos2, cos1, sin1 * sin2)
    verts[-1] = (0.0, -1.0, 0.0)  # bottom pole
    return verts


def _unit_sphere_indices() -> np.ndarray:
    """[768, 3] vertex-index triples in the exact emit order of :198-229."""
    tris = []
    row = _N_LONG + 1
    # Top cap (:198-204)
    for lon in range(_N_LONG):
        tris.append((0, lon + 2, lon + 1))
    # Middle bands (:207-219)
    for lat in range(_N_LAT - 1):
        for lon in range(_N_LONG):
            current = lon + lat * row + 1
            nxt = current + 1
            below = current + row
            below_next = below + 1
            tris.append((current, below, nxt))
            tris.append((nxt, below, below_next))
    # Bottom cap (:222-229)
    last = (row * _N_LAT + 2) - 1
    for lon in range(_N_LONG):
        tris.append((last, last - row + lon, last - row + lon + 1))
    return np.array(tris, dtype=np.int64)


_SPHERE_VERTS = _unit_sphere_vertices()
_SPHERE_IDX = _unit_sphere_indices()


def _sphere_triangles(scene: SceneData, sphere) -> TriangleSoA:
    m = tf.build_matrix(scene, sphere.transformation_index)
    nm = tf.normal_matrix(m)  # inverse-transpose (:258)
    obj = _SPHERE_VERTS
    # Smooth normals: normalized object-space position, then inverse-transpose,
    # then renormalize (AddSmoothTri :245-263).
    n_obj = _normalize(obj)
    world = _transform_points(m, obj)
    n_world = _normalize(_transform_vectors(nm, n_obj))
    i0, i1, i2 = _SPHERE_IDX[:, 0], _SPHERE_IDX[:, 1], _SPHERE_IDX[:, 2]
    mat = np.full((_SPHERE_IDX.shape[0],), sphere.material_index, dtype=np.int32)
    return TriangleSoA(
        world[i0], world[i1], world[i2],
        n_world[i0], n_world[i1], n_world[i2], mat,
    )


# ---------------------------------------------------------------------------


def extract_triangles(scene: SceneData, include_primitives: bool = True) -> TriangleSoA:
    """All scene geometry as triangles in object space, in the reference's
    emit order: meshes, then boxes, then spheres (ExtractTriangles :18-51).

    ``include_primitives=False`` leaves spheres/boxes out (analytic mode
    intersects them directly, see ops/analytic.py)."""
    parts = [_mesh_triangles(scene, m) for m in scene.triangle_meshes]
    if include_primitives:
        parts += [_box_triangles(scene, b) for b in scene.boxes]
        parts += [_sphere_triangles(scene, s) for s in scene.spheres]
    return TriangleSoA.concatenate(parts)
