"""The port's Renderer and kernel plumbing on the CPU: caching, row bands,
unported options, launch counters, the build command and the C/Python
mirror of the kernels' launch parameters."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

import cosig_tpu_torch
from cosig_tpu.scene.generate import CONFIGS
from cosig_tpu_torch.kernels import build as kbuild
from cosig_tpu_torch.kernels import wavefront as kw
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_wavefront as ttw

CSRC = pathlib.Path(kbuild.CSRC_DIR)


@pytest.fixture(scope="module")
def tiny():
    from __graft_entry__ import _tiny_scene

    return _tiny_scene()


def test_cache_reused_across_frames(tiny):
    r = cosig_tpu_torch.Renderer(device="cpu")
    st = cosig_tpu_torch.RenderSettings(resolution_override=(16, 16), max_depth=2)
    a = r.render(tiny, st)
    cset = r._cached_cset
    b = r.render(tiny, st.replace(camera_fov_override=40.0, light_intensity_scale=0.5))
    assert r._cached_cset is cset  # camera/settings changes keep the geometry
    assert a.shape == b.shape == (16, 16, 3) and not np.array_equal(a, b)
    np.testing.assert_array_equal(r.render(tiny, st), a)
    from __graft_entry__ import _tiny_scene

    r.render(_tiny_scene(), st)  # another scene object: rebuilt
    assert r._cached_cset is not cset
    r.invalidate_cache()
    assert r._cached_cset is None


def test_last_stats(tiny):
    r = cosig_tpu_torch.Renderer(device="cpu")
    st = cosig_tpu_torch.RenderSettings(resolution_override=(20, 12), max_depth=3)
    img = r.render_to_device(tiny, st)
    assert isinstance(img, torch.Tensor) and img.device.type == "cpu"
    s = r.last_stats
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    _, rays = ttw.render_wavefront(r._cached_cset, tkc.build_uniforms(params),
                                   tkc.build_lights(params, False), cfg)
    assert (s.width, s.height) == (20, 12)
    assert s.triangles == r._cached_cset.num_triangles > 0
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
    cset = r._cset_for(tiny)
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
    r = cosig_tpu_torch.Renderer(device="cpu")
    st = cosig_tpu_torch.RenderSettings(resolution_override=(8, 8), **kw_)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        r.render(tiny, st)


def test_cpu_wrappers_run_plain_and_count_nothing(tiny):
    kw.reset_counts()
    st = cosig_tpu_torch.RenderSettings(resolution_override=(8, 8), max_depth=3)
    r = cosig_tpu_torch.Renderer(device="cpu")
    a = r.render(tiny, st)
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    b, _ = ttw.render_wavefront(r._cached_cset, tkc.build_uniforms(params),
                                tkc.build_lights(params, False), cfg, plain=True)
    np.testing.assert_array_equal(a, b.numpy())
    assert kw.primary_launches == 0 and kw.bounce_launches == 0


def test_wrappers_reject_other_devices(tiny):
    r = cosig_tpu_torch.Renderer(device="cpu")
    cset = r._cset_for(tiny).to("meta")
    st = cosig_tpu_torch.RenderSettings(resolution_override=(8, 8))
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    mats = np.zeros((2, 8), np.float32)
    with pytest.raises(ValueError, match="no primary kernel"):
        kw.primary(cset, tkc.build_uniforms(params), mats, tkc.build_lights(params, False), cfg, 8)
    state = torch.zeros((16, 64), device="meta")
    with pytest.raises(ValueError, match="no bounce kernel"):
        kw.bounce(state, cset, tkc.build_uniforms(params), mats,
                  tkc.build_lights(params, False), cfg, 1)


def test_nvcc_command_keeps_ieee_arithmetic():
    cmd = kbuild.nvcc_command("nvcc", "/tmp/x.so")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "--fmad=false" in cmd and "-O3" in cmd and "-shared" in cmd
    assert "fast_math" not in joined and "fast-math" not in joined
    assert cmd[-1].endswith("wavefront.cu")
    assert "-v" in kbuild.nvcc_command("nvcc", "/tmp/x.so", verbose=True)
    assert re.fullmatch(r".*libcosig_wavefront_[0-9a-f]{16}\.so", kbuild.library_path())


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(kbuild.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    with pytest.raises(kbuild.BuildError, match="nvcc not found"):
        kbuild.find_nvcc()


def _header(name):
    return (CSRC / name).read_text()


def test_frame_struct_mirrors_header():
    src = _header("bounce.cuh")
    body = re.search(r"struct Frame \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        for part in decl.split(None, 1)[1].split(","):
            names.append(part.strip().split("[")[0])
    assert names == [f[0] for f in kw.Frame._fields_]
    consts = dict(re.findall(r"\b(MAX_MATS|MAX_LIGHTS|UNIFORMS_LEN) = (\d+)", src))
    assert int(consts["MAX_MATS"]) == kw.MAX_MATS
    assert int(consts["MAX_LIGHTS"]) == kw.MAX_LIGHTS
    assert int(consts["UNIFORMS_LEN"]) == tkc.UNIFORMS_LEN
    n_scalars = len(names) - 3  # all but u, mats, lights
    assert ctypes.sizeof(kw.Frame) == 4 * (
        tkc.UNIFORMS_LEN + n_scalars + 8 * (kw.MAX_MATS + kw.MAX_LIGHTS))
    flags = dict((k, int(v)) for k, v in re.findall(r"\bF_(\w+) = (\d+)", src))
    assert sorted(flags.values()) == sorted(bit for _, bit in kw._FLAGS)


def test_frame_contents_and_limits(tiny):
    scene, settings = CONFIGS["cosig_walls"]()
    params = tsoa.frame_params(scene, settings)
    cfg = tsoa.static_config(scene, settings)
    mats = np.concatenate(tsoa.materials_host(scene), axis=1)
    lights = tkc.build_lights(params, cfg.multi_light)
    uni = tkc.build_uniforms(params)
    f = kw.make_frame(cfg, uni, mats, lights, band=cfg.height, depth=2, is_last=True)
    assert f.n_rays == cfg.width * cfg.height
    assert (f.n_mats, f.n_lights, f.depth, f.is_last) == (mats.shape[0], 2, 2, 1)
    assert f.flags & 256 and not f.flags & 16  # multi_light on, orthographic off
    np.testing.assert_array_equal(np.array(f.u[:], np.float32), uni)
    np.testing.assert_array_equal(np.array(f.mats[: mats.size], np.float32), mats.ravel())
    with pytest.raises(ValueError, match="materials"):
        kw.make_frame(cfg, uni, np.zeros((kw.MAX_MATS + 1, 8), np.float32), lights,
                      cfg.height, 0, False)
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
    cset = cosig_tpu_torch.Renderer(device="cpu")._cset_for(tiny).to(card)
    uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, False)
    kw.reset_counts()
    st_k = ttw.trace_state(cset, uni, lights, cfg)
    assert (kw.primary_launches, kw.bounce_launches) == (1, 2)
    st_p = ttw.trace_state(cset, uni, lights, cfg, plain=True)
    torch.cuda.synchronize()
    assert (kw.primary_launches, kw.bounce_launches) == (1, 2)
    assert torch.equal(st_k, st_p)


@pytest.mark.gpu
def test_wrappers_check_inputs_on_card(tiny, card):
    st = cosig_tpu_torch.RenderSettings(resolution_override=(8, 8), max_depth=2)
    params = tsoa.frame_params(tiny, st)
    cfg = tsoa.static_config(tiny, st)
    cset = cosig_tpu_torch.Renderer(device="cpu")._cset_for(tiny).to(card)
    uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, False)
    mats = cset.mats.cpu().numpy()
    state = kw.primary(cset, uni, mats, lights, cfg, 8)
    with pytest.raises(ValueError, match="state must be"):
        kw.bounce(state.double(), cset, uni, mats, lights, cfg, 1)
    with pytest.raises(ValueError, match="state must be"):
        kw.bounce(state[:, :-1].contiguous(), cset, uni, mats, lights, cfg, 1)
    with pytest.raises(ValueError, match="depth"):
        kw.bounce(state, cset, uni, mats, lights, cfg, 2)
    with pytest.raises(ValueError, match="expected"):
        kw.bounce(state, cosig_tpu_torch.Renderer(device="cpu")._cset_for(tiny),
                  uni, mats, lights, cfg, 1)
