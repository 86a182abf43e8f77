"""Line-oriented parser for the brace-delimited scene description format.

Parity reference: ``Assets/Services/SceneService.cs:26-242``.

Grammar (order-agnostic segments, ``//`` comments, case-insensitive segment
names, invariant-culture floats):

* ``Image``          — resolution line (w h), background line (r g b)
* ``Transformation`` — zero or more of ``T x y z | S x y z | Rx a | Ry a | Rz a``
* ``Camera``         — transformation index, distance, vertical FOV (deg)
* ``Light``          — transformation index, rgb line
* ``Material``       — color line (r g b), coefficients line (ka kd ks krefr ior)
* ``Triangles``      — transformation index, then per triangle: material
                        index line + 3 vertex lines (x y z)
* ``Sphere``/``Box`` — transformation index, material index

Error behavior matches the reference: missing file -> empty scene + logged
error (SceneService.cs:28-33); structural errors are logged and parsing
continues (SceneService.cs:283-300).

A frozen copy of the port's ``scene/parser.py``, which the benchmark does
not import.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from benchmark.reference.scene import (
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

log = logging.getLogger("benchmark.reference")


def _clean(line: Optional[str]) -> str:
    """Strip ``//`` comments and whitespace (SceneService.cs:258-267)."""
    if line is None:
        return ""
    idx = line.find("//")
    if idx >= 0:
        line = line[:idx]
    return line.strip()


def _is_segment(line: str, name: str) -> bool:
    return line.lower() == name.lower()


def _parse_floats(line: str) -> List[float]:
    return [float(p) for p in line.replace("\t", " ").split()]


class _Cursor:
    def __init__(self, lines: List[str]):
        self.lines = lines
        self.i = 0

    def done(self) -> bool:
        return self.i >= len(self.lines)

    def next_clean(self) -> str:
        line = _clean(self.lines[self.i])
        self.i += 1
        return line

    def expect_brace(self, brace: str) -> None:
        """Skip blank lines then consume one line expected to be the brace
        (SceneService.cs:280-301)."""
        while self.i < len(self.lines) and not _clean(self.lines[self.i]):
            self.i += 1
        if self.i >= len(self.lines) or _clean(self.lines[self.i]) != brace:
            log.error("Expected '%s' in scene file at line %d.", brace, self.i + 1)
        self.i += 1


def parse_scene(text: str) -> SceneData:
    """Parse scene description text into a :class:`SceneData`."""
    scene = SceneData()
    cur = _Cursor(text.splitlines())

    while not cur.done():
        line = cur.next_clean()
        if not line:
            continue

        if _is_segment(line, "Image"):
            cur.expect_brace("{")
            res = _parse_floats(cur.next_clean())
            bg = _parse_floats(cur.next_clean())
            cur.expect_brace("}")
            scene.image = ImageSettings(
                horizontal=int(res[0]),
                vertical=int(res[1]),
                background=(bg[0], bg[1], bg[2]),
            )

        elif _is_segment(line, "Transformation"):
            comp = CompositeTransformation()
            cur.expect_brace("{")
            while not cur.done():
                inner = cur.next_clean()
                if inner == "}":
                    break
                if not inner:
                    continue
                tokens = inner.replace("\t", " ").split()
                if not tokens:
                    continue
                op = tokens[0]
                if op == "T":
                    comp.elements.append(
                        TransformElement.translation(
                            (float(tokens[1]), float(tokens[2]), float(tokens[3]))
                        )
                    )
                elif op == "S":
                    comp.elements.append(
                        TransformElement.scale(
                            (float(tokens[1]), float(tokens[2]), float(tokens[3]))
                        )
                    )
                elif op == "Rx":
                    comp.elements.append(TransformElement.rotation_x(float(tokens[1])))
                elif op == "Ry":
                    comp.elements.append(TransformElement.rotation_y(float(tokens[1])))
                elif op == "Rz":
                    comp.elements.append(TransformElement.rotation_z(float(tokens[1])))
                # Unknown ops are silently skipped, like the reference switch.
            scene.transformations.append(comp)

        elif _is_segment(line, "Camera"):
            cur.expect_brace("{")
            t_index = int(float(cur.next_clean()))
            distance = float(cur.next_clean())
            fov = float(cur.next_clean())
            cur.expect_brace("}")
            scene.camera = CameraSettings(
                transformation_index=t_index,
                distance=distance,
                vertical_fov_deg=fov,
            )

        elif _is_segment(line, "Light"):
            cur.expect_brace("{")
            t_index = int(float(cur.next_clean()))
            rgb = _parse_floats(cur.next_clean())
            cur.expect_brace("}")
            scene.lights.append(
                LightSource(transformation_index=t_index, rgb=(rgb[0], rgb[1], rgb[2]))
            )

        elif _is_segment(line, "Material"):
            cur.expect_brace("{")
            col = _parse_floats(cur.next_clean())
            coeffs = _parse_floats(cur.next_clean())
            cur.expect_brace("}")
            scene.materials.append(
                MaterialDescription(
                    color=(col[0], col[1], col[2]),
                    ambient=coeffs[0],
                    diffuse=coeffs[1],
                    specular=coeffs[2],
                    refraction=coeffs[3],
                    ior=coeffs[4],
                )
            )

        elif _is_segment(line, "Triangles"):
            mesh = TrianglesMesh()
            cur.expect_brace("{")
            mesh.transformation_index = int(float(cur.next_clean()))
            while not cur.done():
                inner = _clean(cur.lines[cur.i])
                if inner == "}":
                    cur.i += 1
                    break
                if not inner:
                    cur.i += 1
                    continue
                mat = int(float(inner))
                v0 = _parse_floats(_clean(cur.lines[cur.i + 1]))
                v1 = _parse_floats(_clean(cur.lines[cur.i + 2]))
                v2 = _parse_floats(_clean(cur.lines[cur.i + 3]))
                mesh.triangles.append(
                    Triangle(mat, tuple(v0[:3]), tuple(v1[:3]), tuple(v2[:3]))
                )
                cur.i += 4
            scene.triangle_meshes.append(mesh)

        elif _is_segment(line, "Sphere"):
            cur.expect_brace("{")
            t_index = int(float(cur.next_clean()))
            m_index = int(float(cur.next_clean()))
            cur.expect_brace("}")
            scene.spheres.append(
                SphereDescription(transformation_index=t_index, material_index=m_index)
            )

        elif _is_segment(line, "Box"):
            cur.expect_brace("{")
            t_index = int(float(cur.next_clean()))
            m_index = int(float(cur.next_clean()))
            cur.expect_brace("}")
            scene.boxes.append(
                BoxDescription(transformation_index=t_index, material_index=m_index)
            )

    return scene


def load_scene(file_path: str) -> SceneData:
    """Load and parse a scene file; missing file -> empty scene + error log
    (SceneService.cs:28-33)."""
    if not os.path.exists(file_path):
        log.error("File not found at %s", file_path)
        return SceneData()
    with open(file_path) as f:
        return parse_scene(f.read())
