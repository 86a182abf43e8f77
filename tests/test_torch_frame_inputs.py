"""A frame's device inputs on the host (``render/frame_inputs.py``): the
scene's part cached with the Renderer's geometry, each frame's uniforms
from its settings, and the frame buffer's records, held to the plain chain
``pack_frame_data(build_uniforms(frame_params(...)), mats,
build_lights(...))`` byte for byte: on every pose of the benchmark's
traffic on its frozen scenes, on a small scene's overrides, and through the
Renderer. The ``gpu``-marked test holds the card's pinned and device
records to it: ``python -m pytest tests/test_torch_frame_inputs.py -m gpu
--noconftest``."""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu_torch
from benchmark import orbit
from benchmark.manifest import Cell
from cosig_tpu_torch import RenderSettings
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import frame_graph
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.render import renderer as trender
from cosig_tpu_torch.render.frame_inputs import FrameInputs
from cosig_tpu_torch.utils import trace

CELLS = ("large_mesh-orbit", "glass_sphere-orbit", "glass_sphere-preview", "large_mesh-aa4",
         "glass_sphere-drt")
POSES = 36
SECOND_LIGHT = """
Light
{
    3
    0.5 0.7 0.9
}
"""
BARE_SCENE = """
Transformation
{
}
Material
{
    0.8 0.2 0.2
    0.1 0.6 0.3 0 1
}
Triangles
{
    0
    0
    -8 -8 -2
    8 -8 -2
    0 8 -2
}
"""
SMALL = dict(resolution_override=(16, 12))
# A small scene's frames: (scene, settings).
SMALL_CASES = {
    "no-override": ("tiny", SMALL),
    "fov-and-background": ("tiny", dict(SMALL, camera_fov_override=33.3,
                                        background_color_override=(0.1, 0.25, 0.9))),
    "orthographic": ("tiny", dict(SMALL, is_orthographic=True, camera_fov_override=70.0)),
    "position-only": ("tiny", dict(SMALL, camera_position_override=(1.0, -2.0, 25.0))),
    "rotation-only": ("tiny", dict(SMALL, camera_rotation_override=(10.0, -20.0, 30.0))),
    "effects": ("tiny", dict(SMALL, light_intensity_scale=0.7, enable_soft_shadows=True,
                             light_size=5.0, enable_glossy=True, surface_roughness=0.05,
                             enable_motion_blur=True, shutter_speed=0.5)),
    "two-lights": ("two_lights", dict(SMALL, multi_light=True,
                                      camera_rotation_override=(-30.0, 15.0, 40.0))),
    "two-lights-faithful": ("two_lights", SMALL),
    "analytic": ("tiny", dict(SMALL, analytic_primitives=True, camera_fov_override=60.0)),
    "bare-scene": ("bare", dict(SMALL, multi_light=True)),
}


@functools.lru_cache(maxsize=None)
def _scene(name: str):
    """A scene by name: a benchmark cell's frozen scene, or a small one."""
    text = {"tiny": chip_smoke.TINY_SCENE, "two_lights": chip_smoke.TINY_SCENE + SECOND_LIGHT,
            "bare": BARE_SCENE}.get(name)
    if text is not None:
        return cosig_tpu_torch.parse_scene(text)
    return cosig_tpu_torch.load_scene(Cell(name).scene_path())


@functools.lru_cache(maxsize=None)
def _poses(cell: str) -> tuple:
    c = Cell(cell)
    return tuple(RenderSettings(**kw) for kw in orbit.pose_settings(c.config, c.traffic))


def _case(case: str):
    """(scene, settings) of a case id: ``<cell>/<pose>`` or a small case."""
    if "/" in case:
        cell, pose = case.split("/")
        poses = _poses(cell)
        assert len(poses) == POSES
        return _scene(cell), poses[int(pose)]
    scene, kw = SMALL_CASES[case]
    return _scene(scene), RenderSettings(**kw)


def _plain(scene, settings) -> tuple:
    """(uniforms, lights, the record) of the plain chain."""
    params = tsoa.frame_params(scene, settings)
    uni = tkc.build_uniforms(params)
    lights = tkc.build_lights(params, tsoa.static_config(scene, settings).multi_light)
    record = np.zeros((), binding.FRAME_DATA)
    binding.pack_frame_data(record, uni, np.concatenate(tsoa.materials_host(scene), axis=1),
                            lights)
    return uni, lights, record


@pytest.mark.parametrize("case", [f"{c}/{p}" for c in CELLS for p in range(POSES)]
                         + list(SMALL_CASES))
def test_record_equals_the_plain_pack(case):
    """The writer's uniforms and light table, and the record a frame buffer
    holds after it writes them into a record whose tables an earlier frame
    (the scene's own camera) packed, equal the plain chain's bytes."""
    scene, settings = _case(case)
    uni, lights, record = _plain(scene, settings)
    inputs = FrameInputs(scene)
    tables = (binding.read_only(np.concatenate(tsoa.materials_host(scene), axis=1)),
              inputs.lights(settings.multi_light))
    assert inputs.uniforms(settings).tobytes() == uni.tobytes()
    assert tables[1].tobytes() == lights.tobytes() and not tables[1].flags.writeable
    fb = binding.FrameBuffer("cpu")
    fb.write(inputs.uniforms(RenderSettings(multi_light=settings.multi_light)), *tables)
    packed = fb._tables[0]
    fb.write(inputs.uniforms(settings), *tables)
    assert fb._tables[0] is packed  # the second frame wrote its uniforms alone
    assert fb._records[0].tobytes() == record.tobytes()
    assert fb.uniforms.tobytes() == uni.tobytes() and fb.lights.tobytes() == lights.tobytes()


def test_writable_tables_are_packed_every_frame():
    """A frame buffer given writable tables packs them at every write, so a
    table changed in place between frames reaches the record."""
    scene, settings = _case("two-lights")
    uni, lights, record = _plain(scene, settings)
    mats = np.concatenate(tsoa.materials_host(scene), axis=1)
    fb = binding.FrameBuffer("cpu")
    table = lights.copy()
    table[:] = 0.0
    fb.write(uni, mats, table)
    table[:] = lights
    fb.write(uni, mats, table)
    assert fb._tables[0] is None and fb._records[0].tobytes() == record.tobytes()


STEPS = {
    "camera-position": dict(camera_position_override=(1.0, -2.0, 25.0)),
    "camera-rotation": dict(camera_rotation_override=(5.0, 10.0, -15.0)),
    "fov": dict(camera_fov_override=30.0),
    "background": dict(background_color_override=(0.9, 0.1, 0.3)),
    "intensity": dict(light_intensity_scale=0.4),
    "light-size": dict(enable_soft_shadows=True, light_size=3.0),
    "roughness": dict(enable_glossy=True, surface_roughness=0.2),
    "shutter": dict(enable_motion_blur=True, shutter_speed=0.7),
}


def _spy(monkeypatch) -> list:
    """Record the uniforms and lights each Renderer frame on the CPU hands
    ``frame_graph.render_chain``, which then renders as before."""
    seen, chain = [], frame_graph.render_chain

    def spy(path, cset, uniforms, lights, *args, **kw):
        seen.append((np.array(uniforms), np.array(lights)))
        return chain(path, cset, uniforms, lights, *args, **kw)

    monkeypatch.setattr(trender.frame_graph, "render_chain", spy)
    return seen


@pytest.mark.parametrize("step", list(STEPS))
def test_each_setting_reaches_the_next_frame(monkeypatch, step):
    """Two frames of one scene: the second, with one per-frame setting
    changed, hands the plain path that setting's uniforms, and no rebuild
    of the scene's part."""
    scene = _scene("two_lights")
    base = RenderSettings(resolution_override=(8, 6), max_depth=2,
                          camera_rotation_override=(-20.0, 0.0, 5.0))
    changed = base.replace(**STEPS[step])
    seen = _spy(monkeypatch)
    r = cosig_tpu_torch.Renderer(device="cpu", backend="wavefront")
    r.render_to_device(scene, base)
    built = trace.COUNTS["frame_inputs_built"]
    r.render_to_device(scene, changed)
    assert trace.COUNTS["frame_inputs_built"] == built
    for (uni, lights), st in zip(seen, (base, changed)):
        want, want_lights, _ = _plain(scene, st)
        assert uni.tobytes() == want.tobytes() and lights.tobytes() == want_lights.tobytes()
    assert not np.array_equal(seen[0][0], seen[1][0])


def test_scene_part_built_once_a_scene(monkeypatch):
    """An orbit's frames reuse the scene's part; another scene object (the
    same text) rebuilds it once; ``invalidate_cache`` drops it."""
    seen = _spy(monkeypatch)
    text = chip_smoke.TINY_SCENE
    scene = cosig_tpu_torch.parse_scene(text)
    poses = [RenderSettings(resolution_override=(8, 6), max_depth=1,
                            camera_position_override=(0.0, -12.0, 3.0),
                            camera_rotation_override=(-80.0, 0.0, 10.0 * i))
             for i in range(POSES)]
    r = cosig_tpu_torch.Renderer(device="cpu", backend="wavefront")
    before = trace.COUNTS["frame_inputs_built"]
    r.render_to_device(scene, poses[0])
    inputs = r._cached[5]
    for st in poses[1:]:
        r.render_to_device(scene, st)
    assert trace.COUNTS["frame_inputs_built"] == before + 1 and r._cached[5] is inputs
    for (uni, _), st in zip(seen, poses):
        assert uni.tobytes() == _plain(scene, st)[0].tobytes()
    r.render_to_device(cosig_tpu_torch.parse_scene(text), poses[0])
    assert trace.COUNTS["frame_inputs_built"] == before + 2 and r._cached[5] is not inputs
    r.invalidate_cache()
    assert r._cached is None
    r.render_to_device(scene, poses[1])
    assert trace.COUNTS["frame_inputs_built"] == before + 3


@pytest.mark.parametrize("backend,kw", [("wavefront", {}), ("megakernel", {}),
                                        ("wavefront", dict(debug_mode=2)),
                                        ("wavefront", dict(analytic_primitives=True))])
def test_renderer_frame_equals_the_plain_stages_at_a_pose(backend, kw):
    """A Renderer frame with camera, fov and multi-light settings equals the
    plain stages fed from ``frame_params``, image and rays."""
    scene = _scene("two_lights")
    st = RenderSettings(resolution_override=(24, 16), max_depth=3, multi_light=True,
                        camera_position_override=(2.0, -3.0, 22.0),
                        camera_rotation_override=(-10.0, 5.0, 20.0), camera_fov_override=40.0,
                        **kw)
    r = cosig_tpu_torch.Renderer(device="cpu", backend=backend)
    img = r.render_to_device(scene, st)
    uni, lights, _ = _plain(scene, st)
    key = r.graph_key(scene, st)
    cset, prims, counts = r._geometry_for(scene, st.analytic_primitives)
    ref, rays = frame_graph.render_chain(key[2], cset, uni, lights, tsoa.static_config(scene, st),
                                         1, prims, counts, mxu=key[4],
                                         fission=key[5] == "fission")
    assert torch.equal(img, ref) and r.last_stats.rays_traced == rays


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_renderer_records_equal_the_plain_pack_on_card(card):
    """On the card, an orbit of Renderer frames: each frame's pinned record
    and the device record it was copied to equal the plain chain's bytes
    (the materials the cluster set's), one scene part and one capture for
    the orbit, and a frame's image equals a graph fed from
    ``frame_params``."""
    scene = _scene("two_lights")
    poses = [RenderSettings(resolution_override=(32, 24), max_depth=2, multi_light=True,
                            camera_position_override=(0.0, -12.0, 3.0),
                            camera_rotation_override=(-80.0, 0.0, 10.0 * i))
             for i in range(POSES)]
    r = cosig_tpu_torch.Renderer(device="cuda")
    built, captures = trace.COUNTS["frame_inputs_built"], trace.COUNTS["captures"]
    for i, st in enumerate(poses):
        img = r.render_to_device(scene, st)
        fb = r._graph[2].fb
        uni, lights, _ = _plain(scene, st)
        want = np.zeros((), binding.FRAME_DATA)
        binding.pack_frame_data(want, uni, r._geometry_for(scene)[0].mats_host, lights)
        torch.cuda.synchronize()
        assert fb._records[(fb._next - 1) % len(fb._records)].tobytes() == want.tobytes()
        assert fb.data.cpu().numpy().tobytes() == want.tobytes()
        if i in (0, POSES - 1):
            cset, prims, counts = r._geometry_for(scene)
            key = r.graph_key(scene, st)
            ref, rays = frame_graph.render_chain(key[2], cset, uni, lights,
                                                 tsoa.static_config(scene, st), 1, prims,
                                                 counts, mxu=key[4],
                                                 fission=key[5] == "fission")
            assert torch.equal(img, ref) and r.last_stats.rays_traced == rays
    assert trace.COUNTS["frame_inputs_built"] == built + 1
    assert trace.COUNTS["captures"] == captures + 3  # the Renderer's and two plain graphs
