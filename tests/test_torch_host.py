"""Host-side parity of the PyTorch port with the JAX package: the port's
own copies of the host modules (scene model, settings, parser, generator,
tessellation, BVH builder), cluster build, hash RNG, uniforms and lights,
frame configuration. Each side builds its inputs with its own modules."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu
import cosig_tpu_torch
from cosig_tpu.accel import bvh as jbvh
from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import kernel_core as jkc
from cosig_tpu.ops import rng as jrng
from cosig_tpu.scene import generate as jgen
from cosig_tpu.scene import tessellate as jtess
from cosig_tpu_torch.accel import bvh as tbvh
from cosig_tpu_torch.accel import clusters as tcl
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import rng as trng
from cosig_tpu_torch.scene import generate as tgen
from cosig_tpu_torch.scene import tessellate as ttess

SCENE_FILES = sorted(pathlib.Path("scenes").glob("*.txt"))


def _scene(name):
    """(scene, settings) built with the JAX package's modules."""
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene(), cosig_tpu.RenderSettings()
    if name == "demo_cornell":
        return cosig_tpu.load_scene("scenes/demo_cornell.txt"), cosig_tpu.RenderSettings()
    return jgen.CONFIGS[name]()


def _port_scene(name):
    """The same (scene, settings) built with the port's own modules."""
    if name == "tiny":
        return cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE), cosig_tpu_torch.RenderSettings()
    if name == "demo_cornell":
        return (cosig_tpu_torch.load_scene("scenes/demo_cornell.txt"),
                cosig_tpu_torch.RenderSettings())
    return tgen.CONFIGS[name]()


def _port_clusters(scene):
    mats = np.concatenate(tsoa.materials_host(scene), axis=1)
    return tcl.build_clusters(ttess.extract_triangles(scene), mats)


@pytest.mark.parametrize("path", SCENE_FILES, ids=[p.stem for p in SCENE_FILES])
def test_parser_copy_matches_jax(path):
    assert len(SCENE_FILES) >= 1
    ref = cosig_tpu.load_scene(str(path))
    port = cosig_tpu_torch.load_scene(str(path))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    text = path.read_text()
    assert (dataclasses.asdict(cosig_tpu_torch.parse_scene(text))
            == dataclasses.asdict(cosig_tpu.parse_scene(text)))


def test_inline_scenes_match_jax():
    """chip_smoke.py carries the JAX entry module's tiny scene as text and
    rebuilds the JAX analytic test scene with the port's classes."""
    from __graft_entry__ import _tiny_scene
    from test_analytic import _mixed_scene

    assert (dataclasses.asdict(cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE))
            == dataclasses.asdict(_tiny_scene()))
    assert dataclasses.asdict(chip_smoke.mixed_scene()) == dataclasses.asdict(_mixed_scene())


@pytest.mark.parametrize("backend", ["wavefront", "megakernel"])
def test_jax_parsed_scene_renders_in_port(backend):
    """The port reads a scene by its fields: one parsed by the JAX package
    gives the same image as one parsed by the port, analytic mode too."""
    from __graft_entry__ import _tiny_scene

    st = cosig_tpu_torch.RenderSettings(resolution_override=(16, 12), max_depth=2)
    for analytic in (False, True):
        s = st.replace(analytic_primitives=analytic)
        r = cosig_tpu_torch.Renderer(device="cpu", backend=backend)
        a = r.render(_tiny_scene(), s)
        b = r.render(cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE), s)
        assert a.max() > 0.0
        np.testing.assert_array_equal(a, b)


# The port's configurations that the JAX package lacks: name -> (the JAX
# configuration it is built from, the settings it changes).
PORT_ONLY = {"large_mesh_aa4": ("large_mesh", {"aa_samples": 4}),
             "glass_sphere_drt": ("glass_sphere", {
                 "enable_soft_shadows": True, "light_size": 5.0, "enable_glossy": True,
                 "surface_roughness": 0.05, "enable_motion_blur": True, "shutter_speed": 0.5})}


@pytest.mark.parametrize("name", sorted(jgen.CONFIGS))
def test_generator_copy_matches_jax(name):
    assert sorted(tgen.CONFIGS) == sorted([*jgen.CONFIGS, *PORT_ONLY])
    j_scene, j_settings = jgen.CONFIGS[name]()
    t_scene, t_settings = tgen.CONFIGS[name]()
    assert dataclasses.asdict(t_scene) == dataclasses.asdict(j_scene)
    assert dataclasses.asdict(t_settings) == dataclasses.asdict(j_settings)


@pytest.mark.parametrize("name", sorted(PORT_ONLY))
def test_port_only_config_is_a_jax_config_with_other_settings(name):
    base, changed = PORT_ONLY[name]
    j_scene, j_settings = jgen.CONFIGS[base]()
    t_scene, t_settings = tgen.CONFIGS[name]()
    assert dataclasses.asdict(t_scene) == dataclasses.asdict(j_scene)
    assert dataclasses.asdict(t_settings) == dataclasses.asdict(j_settings.replace(**changed))


def test_render_settings_copy_matches_jax():
    ref, port = cosig_tpu.RenderSettings(), cosig_tpu_torch.RenderSettings()
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    changed = dict(max_depth=5, aa_samples=3, debug_mode=2, analytic_primitives=True)
    assert dataclasses.asdict(port.replace(**changed)) == dataclasses.asdict(ref.replace(**changed))


@pytest.mark.parametrize("name", ["tiny", "demo_cornell", "cosig_walls", "large_mesh"])
@pytest.mark.parametrize("primitives", [True, False])
def test_tessellation_copy_bit_equal(name, primitives):
    ref = jtess.extract_triangles(_scene(name)[0], include_primitives=primitives)
    port = ttess.extract_triangles(_port_scene(name)[0], include_primitives=primitives)
    assert port.count == ref.count
    for field in ("v0", "v1", "v2", "n0", "n1", "n2", "material"):
        a, b = getattr(ref, field), getattr(port, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("name", ["tiny", "glass_sphere", "cosig_walls", "large_mesh"])
def test_bvh_copy_bit_equal(name):
    """The port's builder against the JAX package's Python builder (whose
    nodes its C++ one equals, tests/test_torch_native.py): the same nodes
    and triangle order. The reference builds no native library, so this
    test does not race other workers that load the JAX package's."""
    tris = ttess.extract_triangles(_port_scene(name)[0])
    for leaf in (4, 128):
        ref = jbvh.build_bvh(jtess.extract_triangles(_scene(name)[0]), max_leaf=leaf,
                             use_native="python")
        port = tbvh.build_bvh(tris, max_leaf=leaf)
        for field in ("node_min", "node_max", "left_or_first", "count", "order"):
            np.testing.assert_array_equal(getattr(ref, field), getattr(port, field),
                                          err_msg=field)


@pytest.mark.parametrize(
    "name", ["tiny", "demo_cornell", "diffuse_sphere", "glass_sphere", "large_mesh"]
)
def test_clusters_bit_equal_to_jax(name):
    """Same soup, same cut: geometry, boxes, superblocks and materials are
    bit-identical (NaN padding included); large_mesh exercises the auto-k
    doubling (k = 64)."""
    scene, _ = _scene(name)
    ref = jcl.build_clusters(jsoa.compile_scene(scene))
    port = _port_clusters(_port_scene(name)[0])
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
    port = _port_clusters(_port_scene("tiny")[0])
    assert cs.num_triangles == port.num_triangles == ref.num_triangles
    assert torch.equal(cs.geom, port.geom)
    assert torch.equal(cs.aabb_t.nan_to_num(7.0), port.aabb_t.nan_to_num(7.0))
    moved = cs.to("cpu")
    assert moved.device.type == "cpu" and moved.k == cs.k
    with pytest.raises(ValueError):
        tcl.cluster_set_from_arrays(np.zeros((2, 4, 35)), ref.aabb_t, ref.sb_aabb_t, ref.mats)


def test_empty_scene_clusters():
    ref = jcl.build_clusters(jsoa.compile_scene(cosig_tpu.SceneData()))
    port = _port_clusters(cosig_tpu_torch.SceneData())
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
    port_scene, port_settings = _port_scene(name)
    port_settings = port_settings.replace(**kw)
    jp = jsoa.frame_params(scene, settings)
    tp = tsoa.frame_params(port_scene, port_settings)
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
    tc = tsoa.static_config(port_scene, port_settings)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_uniform_slots_match_jax():
    for name in ("U_CAM", "U_DIST", "U_PLANE_H", "U_ORTHO", "U_BG", "U_INTENSITY",
                 "U_LIGHT_SIZE", "U_ROUGHNESS", "U_SHUTTER", "U_ROW_OFF", "U_DEPTH",
                 "U_LAST", "UNIFORMS_LEN", "ROW_ALIVE", "ROW_COUNT"):
        assert getattr(tkc, name) == getattr(jkc, name), name
    assert np.float32(tkc.INF) == jkc.INF
    assert np.float32(tkc.EPSILON) == jkc.EPSILON
    assert np.float32(tkc.OFFSET) == jkc.OFFSET
    assert np.float32(tkc.GID_SPH) == jkc.GID_SPH


def test_sqrt_correctly_rounded():
    """The plain versions' sqrt equals the correctly rounded float32 root
    (numpy's), which the kernels' IEEE sqrtf gives; PyTorch's own float32
    sqrt on this CPU may not (printed for the record, not asserted)."""
    r = np.random.default_rng(0)
    x = np.concatenate([r.uniform(0, 10, 500_000), r.uniform(0, 1e-3, 250_000),
                        r.uniform(0, 1e6, 250_000)]).astype(np.float32)
    ref = np.sqrt(x)
    np.testing.assert_array_equal(tkc._sqrt(torch.from_numpy(x)).numpy(), ref)
    off = int((torch.sqrt(torch.from_numpy(x)).numpy() != ref).sum())
    print(f"torch.sqrt float32 on {torch.backends.cpu.get_cpu_capability()}: "
          f"{off} of {x.size} roots off by 1 ulp")


@pytest.mark.parametrize("mode", ["python", "native"])
@pytest.mark.parametrize("name", ["tiny", "demo_cornell", "glass_sphere", "large_mesh"])
def test_validate_bvh_accepts_built_trees(name, mode):
    """The port's validate_bvh passes the port's BVHs of the in-repo scenes,
    from both builders, as the JAX package's validate_bvh does."""
    tris = ttess.extract_triangles(_port_scene(name)[0])
    bvh = tbvh.build_bvh(tris, use_native=mode)
    tbvh.validate_bvh(bvh, tris)
    jbvh.validate_bvh(bvh, tris)


def _corrupt(bvh, how):
    """A copy of ``bvh`` with one invariant broken."""
    import copy

    bad = copy.deepcopy(bvh)
    leaf = int(np.nonzero(bad.count > 0)[0][0])
    inner = int(np.nonzero(bad.count == 0)[0][0])
    if how == "order":
        bad.order[0] = bad.order[1]
    elif how == "box":
        bad.node_min[0], bad.node_max[0] = bvh.node_max[0], bvh.node_min[0] - 1.0
    elif how == "child_index":
        bad.left_or_first[inner] = bad.num_nodes - 1
    elif how == "child_box":
        child = int(bad.left_or_first[inner])
        bad.node_max[child] = bvh.node_max[inner] + 1.0
    elif how == "leaf_range":
        bad.left_or_first[leaf] = len(bvh.order)
    elif how == "leaf_box":
        bad.node_max[leaf] = bvh.node_min[leaf]
    return bad


@pytest.mark.parametrize("how", ["order", "box", "child_index", "child_box", "leaf_range",
                                 "leaf_box"])
def test_validate_bvh_rejects_corrupted_trees(how):
    tris = ttess.extract_triangles(_port_scene("glass_sphere")[0])
    bvh = tbvh.build_bvh(tris)
    with pytest.raises(ValueError):
        tbvh.validate_bvh(_corrupt(bvh, how), tris)
