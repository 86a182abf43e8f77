"""Composite-transform matrix construction.

Parity reference: ``Assets/Services/RayTracer.cs:410-437`` (BuildComposite),
``Assets/Services/SceneGeometryConverter.cs:83-114`` (BuildMatrix) — the
reference duplicates this builder three times; here it lives once.

Conventions (all verified against Unity semantics):

* Matrices act on column vectors: ``v' = M @ [v, 1]``.
* Composition is left-to-right over the element list:
  ``M = E1 @ E2 @ ... @ En`` — the *first* element in the scene file is the
  outermost (applied last to the vector), matching ``M = M * transform``
  (RayTracer.cs:434).
* ``Quaternion.AngleAxis(angle, axis)`` equals the standard axis-angle
  rotation matrix (Unity's left-handed frame and left-hand rotation rule
  cancel: AngleAxis(90, right) * up == forward == R_x(90) @ (0,1,0)).
* ``Matrix4x4.TRS(pos, Quaternion.Euler(x,y,z), one) = T @ Ry @ Rx @ Rz``
  (Unity Euler order: Z, then X, then Y).

Everything is float32 to match the reference's fp32 pipeline.

A frozen copy of the port's ``scene/transforms.py``, which the benchmark
does not import.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from benchmark.reference.scene import (
    CompositeTransformation,
    SceneData,
    T_ROT_X,
    T_ROT_Y,
    T_ROT_Z,
    T_SCALE,
    T_TRANSLATE,
)

F32 = np.float32


def identity() -> np.ndarray:
    return np.eye(4, dtype=F32)


def translate(xyz: Sequence[float]) -> np.ndarray:
    m = np.eye(4, dtype=F32)
    m[0, 3] = F32(xyz[0])
    m[1, 3] = F32(xyz[1])
    m[2, 3] = F32(xyz[2])
    return m


def scale(xyz: Sequence[float]) -> np.ndarray:
    m = np.eye(4, dtype=F32)
    m[0, 0] = F32(xyz[0])
    m[1, 1] = F32(xyz[1])
    m[2, 2] = F32(xyz[2])
    return m


def _cs(angle_deg: float):
    a = math.radians(float(angle_deg))
    return F32(math.cos(a)), F32(math.sin(a))


def rotate_x(angle_deg: float) -> np.ndarray:
    c, s = _cs(angle_deg)
    m = np.eye(4, dtype=F32)
    m[1, 1] = c
    m[1, 2] = -s
    m[2, 1] = s
    m[2, 2] = c
    return m


def rotate_y(angle_deg: float) -> np.ndarray:
    c, s = _cs(angle_deg)
    m = np.eye(4, dtype=F32)
    m[0, 0] = c
    m[0, 2] = s
    m[2, 0] = -s
    m[2, 2] = c
    return m


def rotate_z(angle_deg: float) -> np.ndarray:
    c, s = _cs(angle_deg)
    m = np.eye(4, dtype=F32)
    m[0, 0] = c
    m[0, 1] = -s
    m[1, 0] = s
    m[1, 1] = c
    return m


_BUILDERS = {
    T_TRANSLATE: lambda e: translate(e.xyz),
    T_SCALE: lambda e: scale(e.xyz),
    T_ROT_X: lambda e: rotate_x(e.angle_deg),
    T_ROT_Y: lambda e: rotate_y(e.angle_deg),
    T_ROT_Z: lambda e: rotate_z(e.angle_deg),
}


def build_composite(comp: CompositeTransformation) -> np.ndarray:
    """M = E1 @ E2 @ ... @ En (first element outermost). RayTracer.cs:410-437."""
    m = identity()
    for e in comp.elements:
        m = (m @ _BUILDERS[e.kind](e)).astype(F32)
    return m


def build_matrix(scene: SceneData, index: int) -> np.ndarray:
    """Composite matrix for a transformation index; identity when out of
    range (SceneGeometryConverter.cs:85, RayTracer.cs:96,240)."""
    if index < 0 or index >= len(scene.transformations):
        return identity()
    return build_composite(scene.transformations[index])


def trs_euler(pos: Sequence[float], euler_deg: Sequence[float]) -> np.ndarray:
    """Unity ``Matrix4x4.TRS(pos, Quaternion.Euler(rot), Vector3.one)``:
    T @ Ry(y) @ Rx(x) @ Rz(z). Used for UI camera overrides
    (RayTracer.cs:255-260)."""
    rx, ry, rz = (float(v) for v in euler_deg)
    m = translate(pos) @ rotate_y(ry) @ rotate_x(rx) @ rotate_z(rz)
    return m.astype(F32)


import logging

_log = logging.getLogger("benchmark.reference")


def inverse(m: np.ndarray) -> np.ndarray:
    """fp32 matrix inverse (Unity Matrix4x4.inverse is fp32).

    Singular matrices (e.g. a zero scale in the scene file) degrade to the
    identity with a logged warning — the same graceful-degradation stance
    the reference takes for structural errors (Unity's Matrix4x4.inverse
    silently returns garbage for singular inputs; identity is the safer
    equivalent)."""
    try:
        return np.linalg.inv(m.astype(np.float64)).astype(F32)
    except np.linalg.LinAlgError:
        _log.warning("singular transformation matrix; using identity inverse")
        return identity()


def normal_matrix(m: np.ndarray) -> np.ndarray:
    """Inverse-transpose 3x3 block, for transforming normals under
    non-uniform scale (SceneGeometryConverter.cs:258)."""
    return inverse(m).T.astype(F32)
