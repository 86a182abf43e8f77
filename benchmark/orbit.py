"""The traffic generator: a closed loop of frames on a camera orbit.

A traffic mix (``benchmark/traffic/<name>.json``) gives the frame's
render settings (resolution, depth, AA and any other field of
``RenderSettings``), the loop kind and the orbit: ``poses`` camera poses
``step_deg`` apart. Pose 0 is the configuration's own camera, given in
its ``.json`` as a Unity TRS (``camera.position``, ``camera.euler_deg``);
pose i turns that camera by ``step_deg * i`` about the world z axis
through the origin. Unity's TRS is T Ry Rx Rz, so a turn about z is a
change of the last Euler angle: the camera-to-object matrix of pose i is
``Rz(step_deg * i)`` times pose 0's. The poses travel to the renderer
only as the settings' two camera overrides, so the scene object, and the
frame's captured graph with it, stay the same from frame to frame.

The seed picks the starting pose; a run then walks the orbit in order,
wrapping around it as often as the window lasts.
"""

from __future__ import annotations

import random


def pose_settings(config: dict, traffic: dict) -> list:
    """The keyword arguments of ``RenderSettings`` for each pose."""
    if traffic["loop"] != "closed":
        raise ValueError(f"unknown loop {traffic['loop']!r}: only 'closed' is generated")
    base = dict(traffic["settings"])
    if "resolution_override" in base:
        base["resolution_override"] = tuple(base["resolution_override"])
    pos = tuple(float(v) for v in config["camera"]["position"])
    ex, ey, ez = (float(v) for v in config["camera"]["euler_deg"])
    step = float(traffic["orbit"]["step_deg"])
    return [dict(base, camera_position_override=pos,
                 camera_rotation_override=(ex, ey, ez - step * i))
            for i in range(int(traffic["orbit"]["poses"]))]


def start_pose(rng: random.Random, n_poses: int) -> int:
    """The first pose, drawn from the run's source of choices (a
    ``random.Random`` of the seed, which also draws the frames and pixels
    compared)."""
    return rng.randrange(n_poses)
