"""The cell with the upstream's distributed ray tracing effects
(``glass_sphere-drt``: soft shadows, glossy reflection, motion blur): its
kept pixels trace alone, from their coordinates, to the bits they have in
the whole frame, which the check of ``correct`` relies on."""

import random

import numpy as np

from benchmark import check, orbit
from benchmark.manifest import Cell
from benchmark.reference import frame, parser, settings, trace
from benchmark.reference.tessellate import extract_triangles

SIDE = 20


def test_a_pixel_traces_alike_alone_and_in_the_frame_with_every_effect():
    c = Cell("glass_sphere-drt")
    kw = dict(orbit.pose_settings(c.config, c.traffic)[3], resolution_override=(SIDE, SIDE))
    assert all(kw[k] for k in ("enable_soft_shadows", "enable_glossy", "enable_motion_blur"))
    scene = parser.load_scene(c.scene_path())
    arrays = frame.compile_scene(scene, extract_triangles(scene))
    s = settings.RenderSettings(**kw)
    whole = trace.render_image(arrays, frame.frame_params(scene, s), frame.static_config(scene, s))
    px, py = check.pick_pixels(random.Random(5), SIDE, SIDE, 37)
    got, rays, _ = check.reference_pixels(c.scene_path(), [kw], [(px, py)], "cpu")
    np.testing.assert_array_equal(got[0], whole.numpy()[py, px])
    assert rays[0].shape == (len(px),) and (rays[0] >= 1).all()
