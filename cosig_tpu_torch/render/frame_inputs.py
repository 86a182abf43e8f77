"""A frame's device inputs on the host: the scene's part, computed once a
scene, and each frame's uniforms, computed from the settings alone.

A kernel path's frame reads 25 uniforms, the materials and the light
table from its record (:data:`~cosig_tpu_torch.kernels.binding.FRAME_DATA`).
:func:`~cosig_tpu_torch.models.soa.frame_params` with
:func:`~cosig_tpu_torch.ops.kernel_core.build_uniforms` and
:func:`~cosig_tpu_torch.ops.kernel_core.build_lights` compute them anew
every frame, the scene's light transforms and camera inverse included.
:class:`FrameInputs` computes once what depends on the scene object alone
(the light table of each ``multi_light`` value, the inverse of the scene
camera's composite, the scene's distance and background, the image plane's
height and the orthographic size at the scene's fov), and
:meth:`FrameInputs.uniforms` the rest each frame with the same float32 and
float64 operations in the same order: the camera override's
``T @ Ry @ Rx @ Rz`` in float32, its inverse in float64 then rounded,
``tan`` of the half angle in float32 and in float64. So its uniforms are
``build_uniforms(frame_params(scene, settings), row_offset)`` bit for bit,
and its light tables ``build_lights``'s. Nothing of a frame's settings is
kept from one frame to the next; the materials are the cluster set's
(``ClusterSet.mats_host``), cached with the geometry already.

The tables are read-only (``binding.read_only``), so a
:class:`~cosig_tpu_torch.kernels.binding.FrameBuffer` given the same ones
frame after frame packs them once into each of its ring's records.
``trace.COUNTS["frame_inputs_built"]`` counts the instances built.
"""

from __future__ import annotations

import numpy as np

from cosig_tpu_torch.kernels.binding import read_only
from cosig_tpu_torch.models.scene import SceneData
from cosig_tpu_torch.models.settings import RenderSettings
from cosig_tpu_torch.models.soa import frame_params
from cosig_tpu_torch.ops.kernel_core import UNIFORMS_LEN, build_lights
from cosig_tpu_torch.scene import transforms as tf
from cosig_tpu_torch.utils import trace

F32 = np.float32
_HALF = F32(0.5)
_ORIGIN = (0.0, 0.0, 0.0)


class FrameInputs:
    """The part of a frame's uniforms and lights that ``scene`` alone
    fixes, and the writer of each frame's uniforms (module docstring)."""

    def __init__(self, scene: SceneData):
        own = {m: frame_params(scene, RenderSettings(multi_light=m)) for m in (False, True)}
        base = own[False]
        self._lights = {m: read_only(build_lights(p, m)) for m, p in own.items()}
        self._cam = read_only(base.cam_to_obj[:3].reshape(12))  # no camera override
        self._distance = base.cam_distance
        self._twice_distance = F32(2.0) * base.cam_distance
        self._background = base.background
        self._planes = self._planes_of(base.fov_deg)  # no fov override
        # The camera override's factors and products, written every frame.
        self._t, self._ry, self._rx, self._rz = (np.eye(4, dtype=F32) for _ in range(4))
        self._tr, self._trr, self._trs = (np.empty((4, 4), F32) for _ in range(3))
        self._trs64 = np.empty((4, 4), np.float64)
        trace.COUNTS["frame_inputs_built"] += 1

    def lights(self, multi_light: bool) -> np.ndarray:
        """The light table f32 [L, 8] (``build_lights``), read-only."""
        return self._lights[bool(multi_light)]

    def uniforms(self, settings: RenderSettings, row_offset: float = 0.0) -> np.ndarray:
        """The frame's uniforms f32 [UNIFORMS_LEN]:
        ``build_uniforms(frame_params(scene, settings), row_offset)``."""
        s = settings
        u = np.empty(UNIFORMS_LEN, F32)
        if s.camera_position_override is None and s.camera_rotation_override is None:
            u[:12] = self._cam
        else:
            u[:12] = self._camera(s.camera_position_override or _ORIGIN,
                                  s.camera_rotation_override or _ORIGIN)
        plane_h, ortho = self._planes if s.camera_fov_override is None \
            else self._planes_of(F32(s.camera_fov_override))
        bg = self._background if s.background_color_override is None \
            else s.background_color_override
        u[12:] = (self._distance, plane_h, ortho, bg[0], bg[1], bg[2], s.light_intensity_scale,
                  s.light_size, s.surface_roughness, s.shutter_speed, row_offset, 0.0, 0.0)
        return u

    def _planes_of(self, fov: np.float32) -> tuple:
        """(plane_h, ortho_size) of the vertical field of view ``fov``
        degrees: ``build_uniforms``'s ``tan`` in float64 and
        ``frame_params``'s in float32 of the same float32 half angle."""
        half = np.deg2rad(fov) * _HALF
        return (self._twice_distance * F32(np.tan(np.float64(half))),
                self._distance * np.tan(half))

    def _camera(self, pos, euler_deg) -> np.ndarray:
        """The first three rows of ``tf.inverse(tf.trs_euler(pos,
        euler_deg))``, float64 before their rounding: the same products
        and inverse, in place of the factors' allocations."""
        rx, ry, rz = (float(v) for v in euler_deg)
        t = self._t
        t[0, 3], t[1, 3], t[2, 3] = F32(pos[0]), F32(pos[1]), F32(pos[2])
        _rotation(self._ry, ry, 2, 0)
        _rotation(self._rx, rx, 1, 2)
        _rotation(self._rz, rz, 0, 1)
        np.matmul(t, self._ry, out=self._tr)
        np.matmul(self._tr, self._rx, out=self._trr)
        np.matmul(self._trr, self._rz, out=self._trs)
        self._trs64[...] = self._trs
        try:
            return np.linalg.inv(self._trs64)[:3].reshape(12)
        except np.linalg.LinAlgError:
            return tf.inverse(self._trs)[:3].reshape(12)  # the identity, with its warning


def _rotation(m: np.ndarray, angle_deg: float, i: int, j: int) -> None:
    """Write ``tf.rotate_x/y/z``'s entries into ``m``: the rotation by
    ``angle_deg`` in the plane of axes ``i``, ``j`` (x: 1, 2; y: 2, 0;
    z: 0, 1)."""
    c, s = tf._cs(angle_deg)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
