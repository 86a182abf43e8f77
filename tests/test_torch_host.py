"""Host-side parity of the PyTorch port with the JAX package: cluster
build, hash RNG, uniforms and lights, frame configuration."""

import dataclasses

import numpy as np
import pytest
import torch

import cosig_tpu
from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import kernel_core as jkc
from cosig_tpu.ops import rng as jrng
from cosig_tpu.scene.generate import CONFIGS
from cosig_tpu.scene.tessellate import extract_triangles
from cosig_tpu_torch.accel import clusters as tcl
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import rng as trng


def _scene(name):
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene(), cosig_tpu.RenderSettings()
    if name == "demo_cornell":
        return cosig_tpu.load_scene("scenes/demo_cornell.txt"), cosig_tpu.RenderSettings()
    return CONFIGS[name]()


def _port_clusters(scene):
    mats = np.concatenate(tsoa.materials_host(scene), axis=1)
    return tcl.build_clusters(extract_triangles(scene), mats)


@pytest.mark.parametrize(
    "name", ["tiny", "demo_cornell", "diffuse_sphere", "glass_sphere", "large_mesh"]
)
def test_clusters_bit_equal_to_jax(name):
    """Same soup, same cut: geometry, boxes, superblocks and materials are
    bit-identical (NaN padding included); large_mesh exercises the auto-k
    doubling (k = 64)."""
    scene, _ = _scene(name)
    ref = jcl.build_clusters(jsoa.compile_scene(scene))
    port = _port_clusters(scene)
    for field in ("geom", "aabb_t", "sb_aabb_t", "mats"):
        a = np.asarray(getattr(ref, field))
        b = getattr(port, field).numpy()
        assert a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert port.num_triangles == ref.num_triangles
    assert port.k == ref.k
    if name == "large_mesh":
        assert port.k == 64


def test_cluster_set_from_arrays_round_trip():
    scene, _ = _scene("tiny")
    ref = jcl.build_clusters(jsoa.compile_scene(scene))
    cs = tcl.cluster_set_from_arrays(
        np.asarray(ref.geom), np.asarray(ref.aabb_t), np.asarray(ref.sb_aabb_t),
        np.asarray(ref.mats),
    )
    port = _port_clusters(scene)
    assert cs.num_triangles == port.num_triangles == ref.num_triangles
    assert torch.equal(cs.geom, port.geom)
    assert torch.equal(cs.aabb_t.nan_to_num(7.0), port.aabb_t.nan_to_num(7.0))
    moved = cs.to("cpu")
    assert moved.device.type == "cpu" and moved.k == cs.k
    with pytest.raises(ValueError):
        tcl.cluster_set_from_arrays(np.zeros((2, 4, 35)), ref.aabb_t, ref.sb_aabb_t, ref.mats)


def test_empty_scene_clusters():
    scene = cosig_tpu.SceneData()
    ref = jcl.build_clusters(jsoa.compile_scene(scene))
    port = _port_clusters(scene)
    assert port.num_triangles == 0
    np.testing.assert_array_equal(np.asarray(ref.geom), port.geom.numpy())
    np.testing.assert_array_equal(np.asarray(ref.aabb_t), port.aabb_t.numpy())


def _planes(seed, n=4096):
    """Seed planes as the kernels feed them (pixel and sample indices,
    sample-scaled offsets, depths) plus general floats, negatives included."""
    r = np.random.default_rng(seed)
    px = r.integers(0, 2048, n).astype(np.float32)
    py = r.integers(0, 2048, n).astype(np.float32)
    s = r.integers(0, 16, n).astype(np.float32)
    return [
        (px + s * np.float32(13.0), py + s * np.float32(7.0), s),
        (r.uniform(-500, 500, n).astype(np.float32), r.uniform(-1, 1, n).astype(np.float32),
         r.normal(0, 50, n).astype(np.float32)),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_bitwise(seed):
    for a, b, c in _planes(seed):
        ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
        for j, t in zip(jrng.hash22(a, b), trng.hash22(ta, tb)):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
        for j, t in zip(jrng.hash33(a, b, c), trng.hash33(ta, tb, tc)):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())


SETTINGS = [
    ("tiny", {}),
    ("demo_cornell", dict(is_orthographic=True, light_intensity_scale=1.5)),
    ("cosig_walls", dict(multi_light=True)),
    ("glass_sphere", dict(enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
                          surface_roughness=0.05, enable_motion_blur=True,
                          shutter_speed=0.5, camera_fov_override=60.0)),
    ("large_mesh", dict(camera_position_override=(1.0, 2.0, -30.0),
                        camera_rotation_override=(10.0, 20.0, 5.0),
                        background_color_override=(0.3, 0.2, 0.1))),
]


@pytest.mark.parametrize("name,kw", SETTINGS, ids=[s[0] for s in SETTINGS])
def test_uniforms_and_lights_match(name, kw):
    """Uniforms within 1 ulp (XLA's tan is not correctly rounded; the port
    rounds the float64 tan once), lights and static config exact."""
    scene, settings = _scene(name)
    settings = settings.replace(**kw)
    jp = jsoa.frame_params(scene, settings)
    tp = tsoa.frame_params(scene, settings)
    for row_offset in (0.0, 37.0):
        ju = np.asarray(jkc.build_uniforms(jp, np.float32(row_offset)))
        tu = tkc.build_uniforms(tp, row_offset)
        assert tu.dtype == np.float32 and tu.shape == (tkc.UNIFORMS_LEN,)
        np.testing.assert_array_max_ulp(ju, tu, maxulp=1)
        np.testing.assert_array_equal(np.delete(ju, tkc.U_PLANE_H),
                                      np.delete(tu, tkc.U_PLANE_H))
    for multi in (False, True):
        np.testing.assert_array_equal(
            np.asarray(jkc.build_lights(jp, multi)), tkc.build_lights(tp, multi)
        )
    jc = jsoa.static_config(scene, settings)
    tc = tsoa.static_config(scene, settings)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_uniform_slots_match_jax():
    for name in ("U_CAM", "U_DIST", "U_PLANE_H", "U_ORTHO", "U_BG", "U_INTENSITY",
                 "U_LIGHT_SIZE", "U_ROUGHNESS", "U_SHUTTER", "U_ROW_OFF", "U_DEPTH",
                 "U_LAST", "UNIFORMS_LEN", "ROW_ALIVE", "ROW_COUNT"):
        assert getattr(tkc, name) == getattr(jkc, name), name
    assert np.float32(tkc.INF) == jkc.INF
    assert np.float32(tkc.EPSILON) == jkc.EPSILON
    assert np.float32(tkc.OFFSET) == jkc.OFFSET
