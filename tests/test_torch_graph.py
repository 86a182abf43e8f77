"""Each frame as one device program: the frame buffer the kernels read
through a pointer, the Renderer's graph cache key, and ``render_chain``
on the CPU (plain stages) against k eager frames and one frame against
the JAX package's jitted wavefront frame (``trace_wavefront.render_jit``,
Pallas in interpret mode) at ROADMAP's tolerances. The graphs themselves
(``cosig_tpu_torch.ops.frame_graph``) capture only on a card: the
``gpu``-marked tests hold replays to the eager frames bit for bit there;
the module imports JAX only inside the test that compares with it, so
they run where JAX is missing:
``python -m pytest tests/test_torch_graph.py -m gpu --noconftest``."""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.accel.clusters import cluster_set_from_arrays
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import camera as tcam
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_megakernel as ttm
from cosig_tpu_torch.ops import trace_wavefront as ttw


def _tiny():
    return cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)


class _OldFrame(ctypes.Structure):
    """The launch parameters as one struct by value, as the kernels took
    them before the frame data moved to device memory."""

    _fields_ = [
        ("u", ctypes.c_float * tkc.UNIFORMS_LEN),
        ("flags", ctypes.c_int),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("band", ctypes.c_int),
        ("aa", ctypes.c_int),
        ("grid_w", ctypes.c_int),
        ("grid_h", ctypes.c_int),
        ("aspect", ctypes.c_float),
        ("n_rays", ctypes.c_int),
        ("n_mats", ctypes.c_int),
        ("n_lights", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("is_last", ctypes.c_int),
        ("mats", ctypes.c_float * (binding.MAX_MATS * 8)),
        ("lights", ctypes.c_float * (binding.MAX_LIGHTS * 8)),
    ]


def _old_frame(cfg, uniforms, mats, lights, band, depth, is_last, n_rays):
    """The former binding.make_frame, float by float."""
    aa = max(1, cfg.aa_samples)
    grid_w, grid_h = tcam.aa_grid(aa)
    f = _OldFrame()
    f.u[:] = [float(x) for x in np.asarray(uniforms, np.float32)]
    f.flags = binding.config_flags(cfg)
    f.width, f.height, f.band = cfg.width, cfg.height, band
    f.aa, f.grid_w, f.grid_h = aa, grid_w, grid_h
    f.aspect = float(np.float32(cfg.width / cfg.height))
    f.n_rays = n_rays
    f.n_mats, f.n_lights = mats.shape[0], lights.shape[0]
    f.depth, f.is_last = depth, int(is_last)
    m = np.zeros(binding.MAX_MATS * 8, np.float32)
    m[: mats.size] = np.asarray(mats, np.float32).ravel()
    f.mats[:] = [float(x) for x in m]
    li = np.zeros(binding.MAX_LIGHTS * 8, np.float32)
    li[: lights.size] = np.asarray(lights, np.float32).ravel()
    f.lights[:] = [float(x) for x in li]
    return f


def _field(struct, name) -> bytes:
    """The bytes of field ``name`` of a ctypes struct."""
    desc = getattr(type(struct), name)
    return ctypes.string_at(ctypes.addressof(struct) + desc.offset, desc.size)


@pytest.mark.parametrize("seed", range(4))
def test_frame_packing_matches_the_former_frame(seed):
    """The numpy packing into a FRAME_DATA record and the launch struct
    give the same bytes, field for field, as the former one-struct
    ``make_frame`` on random inputs (NaN, infinities and signed zeros
    among the uniforms)."""
    r = np.random.default_rng(seed)
    uni = r.normal(size=tkc.UNIFORMS_LEN).astype(np.float32)
    uni[r.integers(0, tkc.UNIFORMS_LEN, 3)] = [np.nan, -0.0, np.inf]
    mats = r.normal(size=(int(r.integers(1, binding.MAX_MATS + 1)), 8)).astype(np.float32)
    lights = r.normal(size=(int(r.integers(1, binding.MAX_LIGHTS + 1)), 8)).astype(np.float32)
    cfg = tsoa.StaticConfig(width=int(r.integers(1, 300)), height=int(r.integers(1, 300)),
                            max_depth=int(r.integers(1, 7)), aa_samples=int(r.integers(1, 9)),
                            enable_soft_shadows=bool(seed % 2), is_orthographic=bool(seed % 3),
                            multi_light=seed > 1)
    band, depth = int(r.integers(1, cfg.height + 1)), int(r.integers(0, cfg.max_depth))
    n = ttw.num_rays(cfg, band)
    old = _old_frame(cfg, uni, mats, lights, band, depth, depth == cfg.max_depth - 1, n)

    rec = np.zeros((), binding.FRAME_DATA)
    binding.pack_frame_data(rec, uni, mats, lights)
    for name in ("u", "n_mats", "n_lights", "mats", "lights"):
        assert rec[name].tobytes() == _field(old, name), name
    fb = binding.frame_buffer("cpu", uni, mats, lights)
    np.testing.assert_array_equal(fb.uniforms, uni)
    fb.data = torch.zeros(1)  # stands in for the device buffer
    f = binding.make_frame(cfg, fb, band, depth, depth == cfg.max_depth - 1)
    for name, _ in binding.Frame._fields_[:-1]:
        assert _field(f, name) == _field(old, name), name
    assert f.data == fb.data.data_ptr()
    # A second write over a used record leaves no stale rows.
    binding.pack_frame_data(rec, uni, mats[:1], lights[:1])
    assert not rec["mats"][8:].any() and not rec["lights"][8:].any()


_SAME_GRAPH = {
    "camera": dict(camera_rotation_override=(10.0, 20.0, 30.0)),
    "fov": dict(camera_fov_override=35.0),
    "light": dict(light_intensity_scale=0.5),
    "background": dict(background_color_override=(0.1, 0.2, 0.3)),
    "light size": dict(light_size=2.0),
}
_NEW_GRAPH = {
    "resolution": dict(resolution_override=(24, 16)),
    "depth": dict(max_depth=4),
    "aa": dict(aa_samples=4),
    "toggle": dict(enable_soft_shadows=True),
    "debug": dict(debug_mode=2),
    "analytic": dict(analytic_primitives=True),
}


@pytest.mark.parametrize("change", sorted(_SAME_GRAPH) + sorted(_NEW_GRAPH))
def test_graph_key(change):
    """A camera, light or other per-frame change keeps the Renderer's graph
    key (the graph replays); resolution, depth, AA, a toggle, the debug
    mode or analytic mode change it (a new capture)."""
    scene = _tiny()
    base = cosig_tpu_torch.RenderSettings(resolution_override=(16, 12), max_depth=2)
    r = cosig_tpu_torch.Renderer(device="cpu", backend="wavefront")
    kw = _SAME_GRAPH.get(change) or _NEW_GRAPH[change]
    same = r.graph_key(scene, base.replace(**kw)) == r.graph_key(scene, base)
    assert same == (change in _SAME_GRAPH)
    assert r.graph_key(_tiny(), base) != r.graph_key(scene, base)  # another scene object
    mk = cosig_tpu_torch.Renderer(device="cpu", backend="megakernel")
    assert mk.graph_key(scene, base)[2] == "megakernel" != r.graph_key(scene, base)[2]
    assert mk.graph_key(scene, base.replace(debug_mode=1))[2] == "debug"
    assert cosig_tpu_torch.Renderer(device="cpu", backend="xla").graph_key(scene, base)[2] is None


@pytest.fixture(scope="module")
def port_frame():
    scene = _tiny()
    st = cosig_tpu_torch.RenderSettings(resolution_override=(20, 14), max_depth=3,
                                        aa_samples=2)
    params = tsoa.frame_params(scene, st)
    cfg = tsoa.static_config(scene, st)
    cset = cosig_tpu_torch.Renderer(device="cpu")._geometry_for(scene)[0]
    return scene, st, cset, tkc.build_uniforms(params), tkc.build_lights(params, False), cfg


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("module", ["wavefront", "megakernel"])
def test_render_chain_equals_k_frames(port_frame, module, k):
    """``render_chain`` on the CPU (the plain stages) gives the single
    frame's image and k times its rays, for both modules and for the
    Renderer, which counts no launch on the CPU."""
    scene, st, cset, uni, lights, cfg = port_frame
    single = ttw.render_wavefront if module == "wavefront" else ttm.render_clusters
    chain = ttw.render_chain if module == "wavefront" else ttm.render_chain
    img, rays = single(cset, uni, lights, cfg)
    binding.reset_counts()
    img_k, rays_k = chain(cset, uni, lights, cfg, k)
    assert torch.equal(img_k, img) and rays_k == k * rays and isinstance(rays_k, int)
    r = cosig_tpu_torch.Renderer(device="cpu", backend=module)
    img_r, rays_r = r.render_chain(scene, st, k)
    assert torch.equal(img_r, img) and rays_r == k * rays == r.last_stats.rays_traced
    assert not any(binding.LAUNCHES.values())
    with pytest.raises(ValueError, match="k must be"):
        chain(cset, uni, lights, cfg, 0)


def test_frame_graph_refuses_the_cpu(port_frame):
    from cosig_tpu_torch.ops.frame_graph import FrameGraph

    _, _, cset, uni, lights, cfg = port_frame
    with pytest.raises(ValueError, match="CUDA device"):
        FrameGraph("wavefront", cset, cfg, uni, lights)
    with pytest.raises(ValueError, match="unknown path"):
        FrameGraph("oracle", cset, cfg, uni, lights)


def test_frame_inputs_read_the_host_materials(port_frame, monkeypatch):
    """A frame's materials come from the cluster set's host copy: nothing
    is read back from the device."""
    _, _, cset, uni, lights, _ = port_frame
    np.testing.assert_array_equal(cset.mats_host, cset.mats.numpy())
    moved = cset.to("meta")  # no data to read back
    assert moved.mats_host is cset.mats_host
    out = ttw.frame_inputs(moved, uni, lights, 0, None, None, (0, 0))
    assert out[2] is cset.mats_host


def test_one_chain_frame_matches_jax_render_jit(monkeypatch):
    """One frame of the wavefront's ``render_chain`` on the CPU against the
    JAX package's jitted wavefront frame (``render_jit``, Pallas in
    interpret mode) on the same cluster structure: ROADMAP's depth >= 2
    tolerances (RMSE < 1e-5, max < 1e-3, rays within 8). The JAX build's
    BVH is its Python builder (the same nodes as its native one), so this
    test builds no native library while other workers may load it."""
    import cosig_tpu
    from __graft_entry__ import _tiny_scene
    from cosig_tpu.accel import bvh as jbvh
    from cosig_tpu.accel import clusters as jcl
    from cosig_tpu.models import soa as jsoa
    from cosig_tpu.ops import trace_wavefront as jtw

    monkeypatch.setattr(jcl, "build_bvh", functools.partial(jbvh.build_bvh,
                                                            use_native="python"))

    scene = _tiny_scene()
    st = cosig_tpu.RenderSettings(resolution_override=(32, 24), max_depth=3)
    jcs = jcl.build_clusters(jsoa.compile_scene(scene))
    ref, jrays = jtw.render_jit(jcs, jsoa.frame_params(scene, st), jsoa.static_config(scene, st),
                                interpret=True)
    ref = np.asarray(ref)
    cset = cluster_set_from_arrays(np.asarray(jcs.geom), np.asarray(jcs.aabb_t),
                                   np.asarray(jcs.sb_aabb_t), np.asarray(jcs.mats))
    pscene = _tiny()
    pst = cosig_tpu_torch.RenderSettings(**dataclasses.asdict(st))
    params = tsoa.frame_params(pscene, pst)
    cfg = tsoa.static_config(pscene, pst)
    img, rays = ttw.render_chain(cset, tkc.build_uniforms(params),
                                 tkc.build_lights(params, cfg.multi_light), cfg, 1)
    img = img.numpy()
    assert img.shape == ref.shape == (24, 32, 3)
    assert float(np.sqrt(((img - ref) ** 2).mean())) < 1e-5
    assert np.abs(img - ref).max() < 1e-3
    assert abs(rays - int(jrays)) <= 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("backend,kw", [("wavefront", {}), ("megakernel", {}),
                                        ("wavefront", dict(debug_mode=2)),
                                        ("megakernel", dict(analytic_primitives=True))])
def test_replay_bit_equal_on_card(card, backend, kw):
    """Renderer frames on the card are replays of one graph, bit-equal to
    the eager frames, image and rays, across camera changes; a toggle
    captures a new graph."""
    scene = _tiny()
    st = cosig_tpu_torch.RenderSettings(resolution_override=(40, 24), max_depth=3,
                                        aa_samples=2, **kw)
    r = cosig_tpu_torch.Renderer(device=card, backend=backend)
    graph = None
    for i in range(3):
        st_i = st.replace(camera_rotation_override=(0.0, 0.0, 10.0 * i))
        binding.reset_counts()
        img = r.render_to_device(scene, st_i)
        assert binding.LAUNCHES["graph"] == 1
        graph = graph or r._graph[2]
        assert r._graph[2] is graph
        params = tsoa.frame_params(scene, st_i)
        cfg = tsoa.static_config(scene, st_i)
        cset, prims, counts = r._geometry_for(scene, st.analytic_primitives)
        uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, cfg.multi_light)
        pk = dict(prims=prims, prim_counts=counts)
        if cfg.debug_mode:
            ref, rays = ttm.render_debug(cset, uni, lights, cfg, **pk)
        elif backend == "megakernel":
            ref, rays = ttm.render_clusters(cset, uni, lights, cfg, **pk)
        else:
            ref, rays = ttw.render_wavefront(cset, uni, lights, cfg, **pk)
        assert torch.equal(img, ref) and r.last_stats.rays_traced == rays
    r.render_to_device(scene, st.replace(enable_soft_shadows=True))
    assert r._graph[2] is not graph


@pytest.mark.gpu
def test_render_chain_on_card(card):
    scene = _tiny()
    st = cosig_tpu_torch.RenderSettings(resolution_override=(40, 24), max_depth=3)
    r = cosig_tpu_torch.Renderer(device=card)
    img = r.render_to_device(scene, st)
    rays = r.last_stats.rays_traced
    img_k, rays_k = r.render_chain(scene, st, 5)
    assert torch.equal(img_k, img) and rays_k == 5 * rays
