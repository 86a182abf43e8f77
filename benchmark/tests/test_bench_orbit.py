"""The orbit: pose 0 is the configuration's own camera, pose i that
camera turned by step x i about the world z axis through the origin."""

import random

import numpy as np
import pytest

from benchmark import manifest, orbit
from benchmark.manifest import Cell
from cosig_tpu_torch import RenderSettings, load_scene
from cosig_tpu_torch.models.soa import camera_to_object_matrix, static_config
from cosig_tpu_torch.scene import transforms as tf

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_pose_zero_is_the_configurations_camera(cell):
    c = Cell(cell)
    scene = load_scene(c.scene_path())
    own = camera_to_object_matrix(scene, RenderSettings())
    pose0 = RenderSettings(**orbit.pose_settings(c.config, c.traffic)[0])
    assert np.array_equal(camera_to_object_matrix(scene, pose0), own)


@pytest.mark.parametrize("cell", CELLS)
def test_pose_i_turns_the_camera_about_world_z(cell):
    c = Cell(cell)
    scene = load_scene(c.scene_path())
    kwargs = orbit.pose_settings(c.config, c.traffic)
    step = c.traffic["orbit"]["step_deg"]
    assert len(kwargs) == c.traffic["orbit"]["poses"] == 36 and step == 10.0
    own = camera_to_object_matrix(scene, RenderSettings())
    for i, kw in enumerate(kwargs):
        got = camera_to_object_matrix(scene, RenderSettings(**kw))
        np.testing.assert_allclose(got, tf.rotate_z(step * i) @ own, atol=2e-6)
    # A full turn: the last pose is one step short of pose 0.
    assert not np.allclose(camera_to_object_matrix(scene, RenderSettings(**kwargs[-1])), own)


@pytest.mark.parametrize("cell", CELLS)
def test_poses_change_only_the_camera(cell):
    c = Cell(cell)
    scene = load_scene(c.scene_path())
    configs = {static_config(scene, RenderSettings(**kw))
               for kw in orbit.pose_settings(c.config, c.traffic)}
    assert len(configs) == 1  # one captured graph serves every pose
    cfg = configs.pop()
    w, h = c.traffic["settings"]["resolution_override"]
    assert (cfg.width, cfg.height, cfg.max_depth, cfg.aa_samples) == (
        w, h, c.traffic["settings"]["max_depth"], c.traffic["settings"]["aa_samples"])


def test_the_seed_picks_the_start_pose():
    starts = {orbit.start_pose(random.Random(s), 36) for s in range(2**31, 2**31 + 64)}
    assert len(starts) > 20
    assert orbit.start_pose(random.Random(2**33 + 5), 36) == orbit.start_pose(
        random.Random(2**33 + 5), 36)
