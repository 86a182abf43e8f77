"""Typed scene data model mirroring the scene description file format.

Parity reference: ``Assets/Models/ObjectData.cs`` (ObjectData:9-34,
ImageSettings:40-50, CompositeTransformation:57-61, TransformElement:80-120,
CameraSettings:128-138, LightSource:144-151, MaterialDescription:158-177,
TrianglesMesh:183-190, Triangle:196-215, SphereDescription:221-228,
BoxDescription:234-241).

These are plain host-side records: a frozen copy of the port's
``models/scene.py``, which the benchmark does not import.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Vec3 = Tuple[float, float, float]


# Elementary transform kinds; a composite transformation is an ordered list
# of these (applied left-to-right: first element is the outermost matrix).
T_TRANSLATE = "T"
T_SCALE = "S"
T_ROT_X = "Rx"
T_ROT_Y = "Ry"
T_ROT_Z = "Rz"


@dataclass
class TransformElement:
    """One elementary transform: T/S carry ``xyz``, rotations carry ``angle_deg``."""

    kind: str  # one of T, S, Rx, Ry, Rz
    xyz: Vec3 = (0.0, 0.0, 0.0)
    angle_deg: float = 0.0

    @staticmethod
    def translation(xyz: Vec3) -> "TransformElement":
        return TransformElement(T_TRANSLATE, xyz=tuple(xyz))

    @staticmethod
    def scale(xyz: Vec3) -> "TransformElement":
        return TransformElement(T_SCALE, xyz=tuple(xyz))

    @staticmethod
    def rotation_x(angle_deg: float) -> "TransformElement":
        return TransformElement(T_ROT_X, angle_deg=float(angle_deg))

    @staticmethod
    def rotation_y(angle_deg: float) -> "TransformElement":
        return TransformElement(T_ROT_Y, angle_deg=float(angle_deg))

    @staticmethod
    def rotation_z(angle_deg: float) -> "TransformElement":
        return TransformElement(T_ROT_Z, angle_deg=float(angle_deg))


@dataclass
class CompositeTransformation:
    elements: List[TransformElement] = field(default_factory=list)


@dataclass
class ImageSettings:
    horizontal: int = 0
    vertical: int = 0
    background: Vec3 = (0.0, 0.0, 0.0)


@dataclass
class CameraSettings:
    """Scene-file camera: fixed at (0, 0, distance) looking toward -Z; the
    indexed transformation conceptually moves the *scene* (the renderer
    instead transforms rays by its inverse)."""

    transformation_index: int = 0
    distance: float = 1.0
    vertical_fov_deg: float = 60.0


@dataclass
class LightSource:
    transformation_index: int = 0
    rgb: Vec3 = (1.0, 1.0, 1.0)


@dataclass
class MaterialDescription:
    color: Vec3 = (1.0, 1.0, 1.0)
    ambient: float = 0.0
    diffuse: float = 0.0
    specular: float = 0.0
    refraction: float = 0.0
    ior: float = 1.0


@dataclass
class Triangle:
    material_index: int
    v0: Vec3
    v1: Vec3
    v2: Vec3


@dataclass
class TrianglesMesh:
    transformation_index: int = 0
    triangles: List[Triangle] = field(default_factory=list)


@dataclass
class SphereDescription:
    transformation_index: int = 0
    material_index: int = 0


@dataclass
class BoxDescription:
    transformation_index: int = 0
    material_index: int = 0


@dataclass
class SceneData:
    """Root aggregate for a parsed scene."""

    image: Optional[ImageSettings] = None
    transformations: List[CompositeTransformation] = field(default_factory=list)
    camera: Optional[CameraSettings] = None
    lights: List[LightSource] = field(default_factory=list)
    materials: List[MaterialDescription] = field(default_factory=list)
    triangle_meshes: List[TrianglesMesh] = field(default_factory=list)
    spheres: List[SphereDescription] = field(default_factory=list)
    boxes: List[BoxDescription] = field(default_factory=list)

    def summary(self) -> str:
        n_tris = sum(len(m.triangles) for m in self.triangle_meshes)
        return (
            f"SceneData(image={self.image}, transforms={len(self.transformations)}, "
            f"lights={len(self.lights)}, materials={len(self.materials)}, "
            f"meshes={len(self.triangle_meshes)} ({n_tris} tris), "
            f"spheres={len(self.spheres)}, boxes={len(self.boxes)})"
        )

    def replace(self, **kw) -> "SceneData":
        return dataclasses.replace(self, **kw)
