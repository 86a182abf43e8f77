"""The reference against the port's CPU path at a tiny size, and the
work count's walk against a walk of one ray at a time."""

import random

import numpy as np
import pytest
import torch

from benchmark import check, manifest, orbit
from benchmark.manifest import Cell
from benchmark.reference import bvh, frame, parser, settings, trace
from benchmark.reference.tessellate import extract_triangles
from cosig_tpu_torch import Renderer, RenderSettings, load_scene

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
SIDE = 20


def _ref_scene(c):
    scene = parser.load_scene(c.scene_path())
    return scene, frame.compile_scene(scene, extract_triangles(scene))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_ports_kernel_path_on_the_cpu(cell):
    """The port's wavefront (its kernels' plain PyTorch versions on the
    CPU) against the reference at two poses, to the project's tolerances
    (depth >= 2: RMSE < 1e-5, max < 1e-3; rays within 8)."""
    c = Cell(cell)
    kwargs = orbit.pose_settings(c.config, c.traffic)
    port_scene = load_scene(c.scene_path())
    ref_scene, arrays = _ref_scene(c)
    renderer = Renderer(device="cpu", backend="wavefront")
    for pose in (0, 7):
        kw = dict(kwargs[pose], resolution_override=(SIDE, SIDE))
        got = renderer.render(port_scene, RenderSettings(**kw))
        s = settings.RenderSettings(**kw)
        want, rays = trace.render_image(arrays, frame.frame_params(ref_scene, s),
                                        frame.static_config(ref_scene, s), with_rays=True)
        gap = np.abs(got - want.numpy())
        assert np.sqrt(np.mean(gap ** 2)) < 1e-5 and gap.max() < 1e-3
        assert abs(renderer.last_stats.rays_traced - rays) <= 8


def test_a_pixel_traces_alike_alone_and_in_the_frame():
    c = Cell("glass_sphere-orbit")
    scene, arrays = _ref_scene(c)
    kw = dict(orbit.pose_settings(c.config, c.traffic)[3], resolution_override=(SIDE, SIDE))
    whole = trace.render_image(arrays, frame.frame_params(scene, settings.RenderSettings(**kw)),
                               frame.static_config(scene, settings.RenderSettings(**kw)))
    px, py = check.pick_pixels(random.Random(5), SIDE, SIDE, 37)
    got, rays, work = check.reference_pixels(c.scene_path(), [kw], [(px, py)], "cpu")
    assert work is None
    np.testing.assert_array_equal(got[0], whole.numpy()[py, px])
    assert rays[0].shape == (len(px),) and (rays[0] >= 1).all()


def _walk_one(tree, o, d, t_max):
    """The work count's walk for one ray, one node at a time."""
    inv = (1.0 / d).astype(np.float32)

    def slab(n):
        t0 = (tree.node_min[n] - o) * inv
        t1 = (tree.node_max[n] - o) * inv
        near = np.max(np.minimum(t0, t1))
        far = np.min(np.maximum(t0, t1))
        return np.float32(3.4028235e38) if near > far or far < 0 else near

    tris = tree.triangles
    best = np.float32(3.4028235e38) if t_max is None else np.float32(t_max)
    boxes = tests = 0
    stack = [0]
    while stack:
        node = stack.pop()
        boxes += 1
        if not slab(node) < best:
            continue
        first, cnt = int(tree.left_or_first[node]), int(tree.count[node])
        if cnt:
            tests += cnt
            _, t, _, _ = bvh.ray_triangle(
                torch.tensor(o)[None, None], torch.tensor(d)[None, None],
                torch.tensor(tris.v0[first:first + cnt])[None],
                torch.tensor(tris.v1[first:first + cnt])[None],
                torch.tensor(tris.v2[first:first + cnt])[None])
            tmin = np.float32(t.min())
            if tmin < best:
                best = tmin
                if t_max is not None:
                    break
        else:
            boxes += 2
            near, far = (first, first + 1) if slab(first) <= slab(first + 1) else (first + 1, first)
            stack += [far, near]
    return boxes, tests


@pytest.mark.parametrize("shadow", [False, True])
def test_work_count_walks_as_one_ray_at_a_time(shadow):
    c = Cell("glass_sphere-orbit")
    scene = parser.load_scene(c.scene_path())
    tris = extract_triangles(scene)
    rng = np.random.default_rng(7)
    o = rng.uniform(-20, 20, (24, 3)).astype(np.float32)
    target = rng.uniform(-5, 5, (24, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = (np.linalg.norm(target - o, axis=1) * 0.9).astype(np.float32) if shadow else None
    count = bvh.WorkCount(tris, "cpu")
    count(torch.tensor(o), torch.tensor(d), None if t_max is None else torch.tensor(t_max))
    got = count.run()
    tree = bvh.build_bvh(tris)
    want = np.sum([_walk_one(tree, o[i], d[i], None if t_max is None else t_max[i])
                   for i in range(len(o))], axis=0)
    assert got["rays"] == len(o)
    assert (got["box_tests"], got["tri_tests"]) == tuple(int(x) for x in want)
    assert got["tri_tests"] > 0
