"""The port's Renderer and kernel plumbing on the CPU: caching, row bands,
the backends and options, launch counters, the build commands and the
C/Python mirror of the kernels' launch parameters."""

import ctypes
import pathlib
import re
import types
from dataclasses import replace

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.kernels import build as kbuild
from cosig_tpu_torch.kernels import megakernel as km
from cosig_tpu_torch.kernels import wavefront as kw
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import frame_graph
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_megakernel as ttm
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.render import renderer as trender
from cosig_tpu_torch.scene.generate import CONFIGS
from cosig_tpu_torch.utils import trace

CSRC = pathlib.Path(kbuild.CSRC_DIR)


def _tiny_scene():
    return cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)


@pytest.fixture(scope="module")
def tiny():
    return _tiny_scene()


def test_cache_reused_across_frames(tiny):
    r = cosig_tpu_torch.Renderer(device="cpu")
    st = cosig_tpu_torch.RenderSettings(resolution_override=(16, 16), max_depth=2)
    a = r.render(tiny, st)
    cached = r._cached
    cset, prims, counts = cached[2:5]
    assert cached[:2] == (tiny, False) and counts == (0, 0)
    assert prims.shape == (1, 22) and not prims.any()
    assert tkc.prim_table(prims, counts, r.device)[0] is prims  # a frame uploads no table
    b = r.render(tiny, st.replace(camera_fov_override=40.0, light_intensity_scale=0.5))
    assert r._cached is cached  # camera/settings changes keep the geometry and the table
    assert a.shape == b.shape == (16, 16, 3) and not np.array_equal(a, b)
    np.testing.assert_array_equal(r.render(tiny, st), a)
    other = _tiny_scene()
    r.render(other, st)  # another scene object: rebuilt
    assert r._cached[0] is other and r._cached[2] is not cset
    r.render(other, st.replace(analytic_primitives=True))  # another mode: rebuilt
    assert r._cached[:2] == (other, True) and r._cached[4] == (1, 1)
    r.invalidate_cache()
    assert r._cached is None


def test_last_stats(tiny):
    r = cosig_tpu_torch.Renderer(device="cpu")
    st = cosig_tpu_torch.RenderSettings(resolution_override=(20, 12), max_depth=3)
    img = r.render_to_device(tiny, st)
    assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
    s = r.last_stats
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    _, rays = ttw.render_wavefront(r._geometry_for(tiny)[0], tkc.build_uniforms(params),
                                   tkc.build_lights(params, False), cfg)
    assert (s.width, s.height) == (20, 12)
    assert s.triangles == r._geometry_for(tiny)[0].num_triangles > 0
    assert s.rays_traced == rays >= 20 * 12
    assert s.render_ms > 0 and s.mrays_per_s > 0


@pytest.mark.parametrize("effects", [False, True])
def test_row_bands_bit_equal_full_frame(tiny, effects):
    st = cosig_tpu_torch.RenderSettings(resolution_override=(24, 20), max_depth=3, aa_samples=2)
    if effects:
        st = st.replace(enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
                        surface_roughness=0.05)
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    r = cosig_tpu_torch.Renderer(device="cpu")
    cset = r._geometry_for(tiny)[0]
    uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, False)
    full, rays = ttw.render_wavefront(cset, uni, lights, cfg)
    bands, band_rays = [], 0
    for lo, n in ((0, 7), (7, 7), (14, 6)):
        img, rr = ttw.render_wavefront(cset, uni, lights, cfg, rows=n, row_offset=lo)
        bands.append(img)
        band_rays += rr
    assert torch.equal(torch.cat(bands), full)
    assert band_rays == rays
    # A band reaching past the image: the extra rows are dead (background 0).
    tail, _ = ttw.render_wavefront(cset, uni, lights, cfg, rows=8, row_offset=14)
    assert torch.equal(tail[:6], bands[2]) and not tail[6:].any()


@pytest.mark.parametrize("kw_", [dict(debug_mode=1), dict(debug_mode=3),
                                 dict(analytic_primitives=True)])
def test_unported_options_raise(tiny, kw_):
    """These options raised NotImplementedError until the debug kernel and
    the analytic fold were ported. Now both backends render them, as the
    direct calls do; what the renderer still refuses is a backend it does
    not have and a debug mode the debug kernel does not draw."""
    st = cosig_tpu_torch.RenderSettings(resolution_override=(8, 8), max_depth=2, **kw_)
    cfg = tsoa.static_config(tiny, st)
    params = tsoa.frame_params(tiny, st)
    uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, False)
    for backend in ("wavefront", "megakernel"):
        r = cosig_tpu_torch.Renderer(device="cpu", backend=backend)
        img = r.render(tiny, st)
        cset, prims, counts = r._geometry_for(tiny, st.analytic_primitives)
        if st.analytic_primitives:
            assert counts == (1, 1) and cset.num_triangles == 1
        else:
            assert counts == (0, 0)
        pk = dict(prims=prims, prim_counts=counts)
        if cfg.debug_mode:
            ref, rays = ttm.render_debug(cset, uni, lights, cfg, **pk)
            assert rays == 64
        elif backend == "wavefront":
            ref, rays = ttw.render_wavefront(cset, uni, lights, cfg, **pk)
        else:
            ref, rays = ttm.render_clusters(cset, uni, lights, cfg, **pk)
        np.testing.assert_array_equal(img, ref.numpy())
        assert r.last_stats.rays_traced == rays
    with pytest.raises(ValueError, match="backend"):
        cosig_tpu_torch.Renderer(device="cpu", backend="pallas")
    with pytest.raises(ValueError, match="debug_mode"):
        cosig_tpu_torch.Renderer(device="cpu").render(tiny, st.replace(debug_mode=4))


FUSED_PLAN = ["primary", "compact.1", "bounce.1", "compact.2", "bounce.2"]
FISSION_PLAN = ["primary", "shade_all", "compact.1", "trace.1", "shade.1", "compact.2",
                "trace.2", "shade.2"]


def _frame_inputs(scene, st, renderer):
    params, cfg = tsoa.frame_params(scene, st), tsoa.static_config(scene, st)
    cset, prims, counts = renderer._geometry_for(scene, st.analytic_primitives)
    return (cset, tkc.build_uniforms(params), tkc.build_lights(params, cfg.multi_light), cfg,
            dict(prims=prims, prim_counts=counts))


@pytest.mark.parametrize("analytic", [False, True])
@pytest.mark.parametrize("mxu", ["off", "full"])
def test_wavefront_form_follows_the_pair_test(tiny, mxu, analytic):
    """The Renderer's wavefront frame runs the fission form with the exact
    pair test and the fused kernels with the tensor-core form; the graph key
    carries the form, and either frame is the fused frame bit for bit,
    image and rays."""
    st = cosig_tpu_torch.RenderSettings(resolution_override=(64, 48), max_depth=3,
                                        analytic_primitives=analytic)
    r = cosig_tpu_torch.Renderer(device="cpu", backend="wavefront", mxu=mxu)
    form = "fission" if mxu == "off" else "fused"
    assert trender.wavefront_form("wavefront", mxu) == form
    assert r.graph_key(tiny, st)[4:] == (mxu, form)
    with trace.recording() as plan:
        img = r.render_to_device(tiny, st)
    cset, uni, lights, cfg, pk = _frame_inputs(tiny, st, r)
    with trace.recording() as fused:
        ref, rays = frame_graph.render_chain("wavefront", cset, uni, lights, cfg, 1, **pk,
                                             mxu=mxu, fission=False)
    assert torch.equal(img, ref) and r.last_stats.rays_traced == rays
    assert fused.labels == FUSED_PLAN
    assert plan.labels == (FISSION_PLAN if form == "fission" else FUSED_PLAN)
    assert [d for d, _ in plan.n_live] == [1, 2]


@pytest.mark.parametrize("backend,mxu,kw_", [("wavefront", "closest", {}),
                                             ("megakernel", "off", {}),
                                             ("megakernel", "full", {}),
                                             ("wavefront", "off", dict(debug_mode=1))])
def test_other_paths_keep_their_kernels(tiny, backend, mxu, kw_):
    """Every frame but the exact wavefront's launches the kernels it did
    before the form rule: the fused primary and bounces with
    ``mxu="closest"``, the megakernel, the debug kernel; its key says
    ``"fused"``."""
    st = cosig_tpu_torch.RenderSettings(resolution_override=(32, 24), max_depth=3, **kw_)
    r = cosig_tpu_torch.Renderer(device="cpu", backend=backend, mxu=mxu)
    path = r.kernel_path(tsoa.static_config(tiny, st))
    assert trender.wavefront_form(path, mxu) == "fused" and r.graph_key(tiny, st)[5] == "fused"
    with trace.recording() as plan:
        img = r.render_to_device(tiny, st)
    cset, uni, lights, cfg, pk = _frame_inputs(tiny, st, r)
    with trace.recording() as before:
        if path == "debug":
            ref, rays = ttm.render_debug(cset, uni, lights, cfg, **pk)
        elif path == "megakernel":
            ref, rays = ttm.render_clusters(cset, uni, lights, cfg, **pk, mxu=mxu)
        else:
            ref, rays = ttw.render_wavefront(cset, uni, lights, cfg, **pk, mxu=mxu)
    assert torch.equal(img, ref) and r.last_stats.rays_traced == rays
    assert plan.labels == before.labels == {"debug": ["debug"], "megakernel": ["megakernel"],
                                            "wavefront": FUSED_PLAN}[path]


def test_cpu_wrappers_run_plain_and_count_nothing(tiny):
    for name in binding.LAUNCHES:
        binding.LAUNCHES[name] = 7
    binding.reset_counts()
    zero = dict(primary=0, compact=0, bounce=0, trace=0, shade=0, primary_fission=0,
                primary_shadow=0, bounce_shadow=0, primary_mx=0, bounce_mx=0, megakernel_mx=0,
                primary_fission_mx=0, trace_mx=0, shade_mx=0, shade_all_mx=0,
                primary_shadow_mx=0, bounce_shadow_mx=0, megakernel=0, debug=0, graph=0)
    assert binding.LAUNCHES == zero
    st = cosig_tpu_torch.RenderSettings(resolution_override=(8, 8), max_depth=3)
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    for backend, render in (("wavefront", ttw.render_wavefront),
                            ("megakernel", ttm.render_clusters)):
        r = cosig_tpu_torch.Renderer(device="cpu", backend=backend)
        a = r.render(tiny, st)
        b, _ = render(r._geometry_for(tiny)[0], tkc.build_uniforms(params),
                      tkc.build_lights(params, False), cfg, plain=True)
        np.testing.assert_array_equal(a, b.numpy())
        r.render(tiny, st.replace(debug_mode=2))
        r.render_chain(tiny, st, 2)
    cset = r._geometry_for(tiny)[0]
    for mxu in ("off", "full"):
        ttw.render_wavefront(cset, tkc.build_uniforms(params), tkc.build_lights(params, False),
                             cfg, fission=True, cset_shadow=cset, mxu=mxu)
    assert binding.LAUNCHES == zero


def test_wrappers_reject_other_devices(tiny):
    r = cosig_tpu_torch.Renderer(device="cpu")
    cset = r._geometry_for(tiny)[0].to("meta")
    st = cosig_tpu_torch.RenderSettings(resolution_override=(8, 8))
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    mats = np.zeros((2, 8), np.float32)
    uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, False)
    fb = binding.frame_buffer("cpu", uni, mats, lights)
    pk = (torch.zeros((1, 22), device="meta"), 0, 0)
    with pytest.raises(ValueError, match="no primary kernel"):
        kw.primary(cset, fb, cfg, 8, *pk)
    state = torch.zeros((16, 64), device="meta")
    idx = torch.zeros(64, dtype=torch.int32, device="meta")
    n_live = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no compaction kernel"):
        kw.compact(state)
    with pytest.raises(ValueError, match="no bounce kernel"):
        kw.bounce(state, idx, n_live, cset, fb, cfg, 1, *pk)
    with pytest.raises(ValueError, match="no megakernel"):
        km.megakernel(cset, fb, cfg, 8, *pk)
    with pytest.raises(ValueError, match="no debug kernel"):
        km.debug(cset, fb, cfg, *pk)


def test_check_inputs_rejects_misaligned_geom(tiny):
    """The block walk copies cluster rows with bulk async copies, which need
    16-byte aligned sources: a geom view that starts 4 bytes into its
    storage is refused before any launch."""
    cset = cosig_tpu_torch.Renderer(device="cpu")._geometry_for(tiny)[0]
    pk = tkc.prim_table(None, (0, 0), "cpu")
    binding.check_inputs(cset, torch.device("cpu"), *pk)
    flat = torch.zeros(cset.geom.numel() + 4, dtype=torch.float32)
    shifted = flat[1:1 + cset.geom.numel()].view(cset.geom.shape)
    shifted.copy_(cset.geom)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        binding.check_inputs(replace(cset, geom=shifted), torch.device("cpu"), *pk)


def test_nvcc_command_keeps_ieee_arithmetic():
    """Every kernel source compiles with the IEEE flags for sm_90a, one
    nvcc each; one link makes the library."""
    assert kbuild.KERNEL_SOURCES == ("wavefront.cu", "forms.cu", "mx.cu", "mx_forms.cu",
                                     "megakernel.cu")
    for src in kbuild.KERNEL_SOURCES:
        cmd = kbuild.nvcc_command("nvcc", src, "/tmp/x.o")
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined
        assert "--fmad=false" in cmd and "-O3" in cmd and "-c" in cmd
        assert "fast_math" not in joined and "fast-math" not in joined
        assert cmd[-1].endswith(src) and (CSRC / src).is_file()
        assert "-v" in kbuild.nvcc_command("nvcc", src, "/tmp/x.o", verbose=True)
    link = kbuild.link_command("nvcc", ["/tmp/a.o", "/tmp/b.o"], "/tmp/x.so")
    assert "-shared" in link and link[-2:] == ["/tmp/a.o", "/tmp/b.o"]
    assert set(kbuild.SOURCES) == {p.name for p in CSRC.iterdir()
                                   if p.suffix in (".cu", ".cuh", ".h")}
    assert re.fullmatch(r".*libcosig_kernels_[0-9a-f]{16}\.so", kbuild.library_path())


@pytest.mark.parametrize("parallel", [True, False])
def test_compile_waits_for_every_command(parallel):
    """Each compile's exit code and stderr, in order, also after a failure."""
    import sys

    cmds = [[sys.executable, "-c", f"import sys; sys.stderr.write('{i}'); sys.exit({rc})"]
            for i, rc in enumerate((0, 3, 0))]
    assert kbuild._compile(cmds, parallel) == [(0, "0"), (3, "1"), (0, "2")]


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(kbuild.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    with pytest.raises(kbuild.BuildError, match="nvcc not found"):
        kbuild.find_nvcc()


def _header(name):
    return (CSRC / name).read_text()


def _struct_fields(src, name):
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [re.findall(r"\w+", part.split("[")[0])[-1]
            for decl in body.split(";") if decl.strip() for part in decl.split(",")]


def test_frame_struct_mirrors_header():
    """binding.Frame (a launch's parameters, by value) and binding.FRAME_DATA
    (the frame's uniforms, materials and lights, read through Frame::data)
    mirror the two structs of csrc/bounce.cuh field for field."""
    src = _header("bounce.cuh")
    assert _struct_fields(src, "Frame") == [f[0] for f in binding.Frame._fields_]
    assert _struct_fields(src, "FrameData") == list(binding.FRAME_DATA.names)
    consts = dict(re.findall(r"\b(MAX_MATS|MAX_LIGHTS|UNIFORMS_LEN) = (\d+)", src))
    assert int(consts["MAX_MATS"]) == binding.MAX_MATS
    assert int(consts["MAX_LIGHTS"]) == binding.MAX_LIGHTS
    assert int(consts["UNIFORMS_LEN"]) == tkc.UNIFORMS_LEN
    assert binding.FRAME_DATA.itemsize == 4 * (
        tkc.UNIFORMS_LEN + 2 + 8 * (binding.MAX_MATS + binding.MAX_LIGHTS))
    n_scalars = len(binding.Frame._fields_) - 1  # all but the data pointer
    assert ctypes.sizeof(binding.Frame) == -(-4 * n_scalars // 8) * 8 + 8
    flags = dict((k, int(v)) for k, v in re.findall(r"\bF_(\w+) = (\d+)", src))
    assert flags.pop("MX_SHADOW") == binding.F_MX_SHADOW
    assert sorted(flags.values()) == sorted(bit for _, bit in binding._FLAGS)


def test_frame_contents_and_limits(tiny):
    scene, settings = CONFIGS["cosig_walls"]()
    params = tsoa.frame_params(scene, settings)
    cfg = tsoa.static_config(scene, settings)
    mats = np.concatenate(tsoa.materials_host(scene), axis=1)
    lights = tkc.build_lights(params, cfg.multi_light)
    uni = tkc.build_uniforms(params)
    rec = np.zeros((), binding.FRAME_DATA)
    binding.pack_frame_data(rec, uni, mats, lights)
    assert (rec["n_mats"], rec["n_lights"]) == (mats.shape[0], 2)
    np.testing.assert_array_equal(rec["u"], uni)
    np.testing.assert_array_equal(rec["mats"][: mats.size], mats.ravel())
    assert not rec["mats"][mats.size:].any() and not rec["lights"][lights.size:].any()
    fb = types.SimpleNamespace(data=torch.zeros(4))
    f = binding.make_frame(cfg, fb, band=cfg.height, depth=2, is_last=True)
    assert f.n_rays == cfg.width * cfg.height and f.data == fb.data.data_ptr()
    assert (f.depth, f.is_last) == (2, 1)
    assert f.flags & 256 and not f.flags & 16  # multi_light on, orthographic off
    with pytest.raises(ValueError, match="materials"):
        binding.pack_frame_data(rec, uni, np.zeros((binding.MAX_MATS + 1, 8), np.float32),
                                lights)
    with pytest.raises(ValueError, match="materials"):
        binding.frame_buffer("cpu", uni, np.zeros((binding.MAX_MATS + 1, 8), np.float32),
                             lights)
    with pytest.raises(ValueError, match="f32-exact"):
        ttw.num_rays(cfg.__class__(width=4096, height=4096, aa_samples=1), 4096)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_kernels_match_plain_on_card(tiny, card):
    """The kernels against their plain versions on the same inputs, and one
    counted launch per stage (chip_smoke.py runs this at more sizes)."""
    st = cosig_tpu_torch.RenderSettings(resolution_override=(64, 48), max_depth=3,
                                        aa_samples=2, enable_soft_shadows=True,
                                        light_size=5.0, enable_glossy=True,
                                        surface_roughness=0.05)
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    cset = cosig_tpu_torch.Renderer(device="cpu")._geometry_for(tiny)[0].to(card)
    uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, False)
    binding.reset_counts()
    st_k = ttw.trace_state(cset, uni, lights, cfg)
    img_m, rays_m = ttm.render_clusters(cset, uni, lights, cfg)
    img_d, _ = ttm.render_debug(cset, uni, lights, tsoa.static_config(tiny, st.replace(debug_mode=2)))
    counts = dict(binding.LAUNCHES)
    assert counts == dict(primary=1, compact=2, bounce=2, trace=0, shade=0, primary_fission=0,
                          primary_shadow=0, bounce_shadow=0, primary_mx=0, bounce_mx=0,
                          megakernel_mx=0, primary_fission_mx=0, trace_mx=0, shade_mx=0,
                          shade_all_mx=0, primary_shadow_mx=0, bounce_shadow_mx=0, megakernel=1,
                          debug=1, graph=0)
    st_p = ttw.trace_state(cset, uni, lights, cfg, plain=True)
    img_mp, rays_mp = ttm.render_clusters(cset, uni, lights, cfg, plain=True)
    img_dp, _ = ttm.render_debug(cset, uni, lights, tsoa.static_config(tiny, st.replace(debug_mode=2)),
                                 plain=True)
    torch.cuda.synchronize()
    assert binding.LAUNCHES == counts
    assert torch.equal(st_k, st_p)
    assert torch.equal(img_m, img_mp) and rays_m == rays_mp
    assert torch.equal(img_d, img_dp)
    # The megakernel and the wavefront kernels run the same device code.
    assert torch.equal(img_m, ttw.finalize(st_k, cfg, cfg.height)[0])


@pytest.mark.gpu
def test_wrappers_check_inputs_on_card(tiny, card):
    st = cosig_tpu_torch.RenderSettings(resolution_override=(8, 8), max_depth=2)
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    cset = cosig_tpu_torch.Renderer(device="cpu")._geometry_for(tiny)[0].to(card)
    uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, False)
    fb = binding.frame_buffer(card, uni, cset.mats_host, lights)
    pk = tkc.prim_table(None, (0, 0), card)
    state = kw.primary(cset, fb, cfg, 8, *pk)
    idx, n_live = kw.compact(state)
    with pytest.raises(ValueError, match="state must be"):
        kw.compact(state.double())
    with pytest.raises(ValueError, match="state must be"):
        kw.bounce(state.double(), idx, n_live, cset, fb, cfg, 1, *pk)
    with pytest.raises(ValueError, match="state must be"):
        kw.bounce(state[:, :-1].contiguous(), idx, n_live, cset, fb, cfg, 1, *pk)
    with pytest.raises(ValueError, match="idx must be"):
        kw.bounce(state, idx.long(), n_live, cset, fb, cfg, 1, *pk)
    with pytest.raises(ValueError, match="n_live must be"):
        kw.bounce(state, idx, n_live.cpu(), cset, fb, cfg, 1, *pk)
    with pytest.raises(ValueError, match="depth"):
        kw.bounce(state, idx, n_live, cset, fb, cfg, 2, *pk)
    with pytest.raises(ValueError, match="expected"):
        kw.bounce(state, idx, n_live, cosig_tpu_torch.Renderer(device="cpu")._geometry_for(tiny)[0],
                  fb, cfg, 1, *pk)
    with pytest.raises(ValueError, match="prims"):
        km.megakernel(cset, fb, cfg, 8, pk[0].cpu(), 0, 0)
    with pytest.raises(ValueError, match="prims"):
        km.debug(cset, fb, cfg, pk[0], 2, 0)
    with pytest.raises(ValueError, match="frame buffer"):
        kw.primary(cset, binding.frame_buffer("cpu", uni, cset.mats_host, lights), cfg, 8, *pk)


@pytest.mark.gpu
def test_compaction_matches_plain_on_card(card):
    """The compaction kernel's list equals the plain one as integers on
    states over several blocks of the kernel's grid: random liveness and
    directions (zeros and NaN included), every ray dead, every ray alive."""
    r = np.random.default_rng(3)
    n = 5 * 2048 + 77
    state = torch.from_numpy(r.normal(size=(16, n)).astype(np.float32))
    state[3, ::7] = 0.0
    state[4, ::11] = float("nan")
    for alive in (r.random(n) < 0.3, np.zeros(n, bool), np.ones(n, bool)):
        state[tkc.ROW_ALIVE] = torch.from_numpy(alive.astype(np.float32))
        idx_p, n_p = ttw.compact_plain(state)
        binding.reset_counts()
        idx, n_live = kw.compact(state.to(card))
        assert binding.LAUNCHES["compact"] == 1
        m = int(n_live)
        assert m == int(n_p) == int(alive.sum())
        assert torch.equal(idx[:m].cpu(), idx_p[:m])


@pytest.mark.parametrize("refused", ["grid", "launch"])
def test_refused_compaction_raises(monkeypatch, refused):
    """A compaction whose cooperative grid does not fit, or whose launch the
    card refuses (cudaErrorCooperativeLaunchTooLarge, 720), raises; nothing
    falls back to the plain list. A stand-in library takes the CUDA calls."""
    import contextlib
    import types

    calls = []

    def grid(n, blocks, rays):
        blocks._obj.value, rays._obj.value = 3, 512
        return 720 if refused == "grid" else 0

    def launch(*args):
        calls.append(args)
        return 720

    fake = types.SimpleNamespace(cosig_compact_grid=grid, cosig_compact_launch=launch)
    monkeypatch.setattr(binding, "library", lambda: fake)
    binding.compact_grid.cache_clear()
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ttw, "compact_plain", lambda *a: pytest.fail("fell back"))
    state = torch.zeros((16, 1500), dtype=torch.float32)
    idx = torch.empty(1500, dtype=torch.int32)
    n_live = torch.empty(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        binding.launch_compact(state, idx, n_live)
    if refused == "launch":
        # state, n, blocks, rays per block, counts, scratch ints, idx, n_live, stream
        assert len(calls) == 1 and calls[0][1:4] == (1500, 3, 512)
        assert calls[0][5] == 3 * binding.OCTANTS
    else:
        assert not calls
    binding.compact_grid.cache_clear()
