"""The port's megakernel and debug renders (plain PyTorch on the CPU)
against the JAX package's Pallas megakernel and debug kernel in interpret
mode, on one identical cluster structure (the JAX ``ClusterSet`` carried
across with ``cluster_set_from_arrays``); against the port's wavefront
render; and through the Renderer. Tolerances are the ones the JAX backends
hold among themselves (tests/test_pallas.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu
import cosig_tpu_torch
from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import trace_pallas
from cosig_tpu.scene.generate import CONFIGS
from cosig_tpu_torch.accel.clusters import cluster_set_from_arrays
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_megakernel as ttm
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.scene import generate as tgen

EFFECTS = dict(aa_samples=4, enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
               surface_roughness=0.05, enable_motion_blur=True, shutter_speed=0.5)


def _scenes(name):
    """(JAX-built scene, port-built scene)."""
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene(), cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    if name == "demo_cornell":
        return (cosig_tpu.load_scene("scenes/demo_cornell.txt"),
                cosig_tpu_torch.load_scene("scenes/demo_cornell.txt"))
    return CONFIGS[name]()[0], tgen.CONFIGS[name]()[0]


def _setup(name, settings):
    """JAX (cluster set, params, cfg) and the port's (cluster set from the
    JAX arrays, uniforms, lights, cfg), each from its own scene."""
    jscene, tscene = _scenes(name)
    jcs = jcl.build_clusters(jsoa.compile_scene(jscene))
    jax_side = (jcs, jsoa.frame_params(jscene, settings), jsoa.static_config(jscene, settings))
    cset = cluster_set_from_arrays(np.asarray(jcs.geom), np.asarray(jcs.aabb_t),
                                   np.asarray(jcs.sb_aabb_t), np.asarray(jcs.mats))
    tsettings = cosig_tpu_torch.RenderSettings(**dataclasses.asdict(settings))
    tparams = tsoa.frame_params(tscene, tsettings)
    tcfg = tsoa.static_config(tscene, tsettings)
    port = (cset, tkc.build_uniforms(tparams), tkc.build_lights(tparams, tcfg.multi_light), tcfg)
    return jax_side, port


def _mega(port, **kw):
    cset, uni, lights, cfg = port
    img, rays = ttm.render_clusters(cset, uni, lights, cfg, **kw)
    return img.numpy(), rays


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def test_demo_cornell_depth1_matches_jax_megakernel():
    """Depth 1: one bounce, so only float32 rounding differs (<= 2e-6)."""
    st = cosig_tpu.RenderSettings(resolution_override=(64, 48), max_depth=1)
    (jcs, params, cfg), port = _setup("demo_cornell", st)
    ref, jrays = trace_pallas.render_clusters(jcs, params, cfg, interpret=True)
    img, rays = _mega(port)
    assert img.shape == (48, 64, 3)
    assert np.abs(img - np.asarray(ref)).max() <= 2e-6
    assert abs(rays - float(jrays)) <= 8


@pytest.mark.parametrize("ortho", [False, True], ids=["perspective", "orthographic"])
def test_tiny_depth3_matches_jax_megakernel(ortho):
    """Depth >= 2 at the JAX backends' own gate: RMSE < 1e-5, max < 1e-3,
    rays within 8."""
    st = cosig_tpu.RenderSettings(resolution_override=(32, 32), max_depth=3,
                                  is_orthographic=ortho)
    (jcs, params, cfg), port = _setup("tiny", st)
    ref, jrays = trace_pallas.render_clusters(jcs, params, cfg, interpret=True)
    ref = np.asarray(ref)
    img, rays = _mega(port)
    assert _rmse(img, ref) < 1e-5
    assert np.abs(img - ref).max() < 1e-3
    assert abs(rays - float(jrays)) <= 8
    assert isinstance(rays, int) and rays >= 32 * 32


def test_effects_match_jax_megakernel_on_stable_pixels():
    """AA 4, soft shadows, glossy and motion blur, with test_pallas.py's
    rule: a pixel may differ by more than 1e-3 only where one of the
    programs is itself unstable (its own render at another program shape
    moves the pixel by more than 1e-6) — grazing stochastic rays amplify
    float32 ULPs there."""
    st = cosig_tpu.RenderSettings(resolution_override=(32, 32), max_depth=2, **EFFECTS)
    (jcs, params, cfg), port = _setup("tiny", st)
    ref = np.asarray(trace_pallas.render_clusters(jcs, params, cfg, interpret=True)[0])
    ref2 = np.asarray(trace_pallas.render_clusters(jcs, params, cfg, interpret=True,
                                                   tile=(8, 16))[0])
    img, _ = _mega(port)
    top, _ = _mega(port, rows=13, row_offset=0)
    bottom, _ = _mega(port, rows=19, row_offset=13)
    img2 = np.concatenate([top, bottom])
    diff = np.abs(img - ref).max(axis=2)
    unstable = (np.abs(ref - ref2).max(axis=2) > 1e-6) | (np.abs(img - img2).max(axis=2) > 1e-6)
    assert ((diff > 1e-3) & ~unstable).sum() == 0
    assert diff.max() < 0.05
    assert _rmse(img, ref) < 1e-4 + _rmse(ref, ref2)


@pytest.mark.parametrize("effects", [False, True])
def test_band_bit_equal_full_frame(effects):
    """rows/row_offset keep the projection and the RNG seeds global: bands
    inside the image are the full frame's rows bit for bit."""
    st = cosig_tpu.RenderSettings(resolution_override=(24, 20), max_depth=3,
                                  **(EFFECTS if effects else {}))
    _, port = _setup("tiny", st)
    full, rays = _mega(port)
    bands, band_rays = [], 0
    for lo, n in ((0, 7), (7, 7), (14, 6)):
        img, r = _mega(port, rows=n, row_offset=lo)
        bands.append(img)
        band_rays += r
    np.testing.assert_array_equal(np.concatenate(bands), full)
    assert band_rays == rays


def test_render_chain_matches_single_and_jax_chain():
    """``render_chain`` (tests/test_pallas.py:121 for the JAX one): k frames
    queued in a row give the single frame's image bit for bit and k times
    its rays; the JAX chain of k frames in interpret mode gives the same
    image within the depth >= 2 tolerances and the same rays within 8 a
    frame."""
    st = cosig_tpu.RenderSettings(resolution_override=(32, 32), max_depth=2)
    (jcs, params, cfg), port = _setup("tiny", st)
    cset, uni, lights, tcfg = port
    img1, rays1 = _mega(port)
    img3, rays3 = ttm.render_chain(cset, uni, lights, tcfg, k=3)
    assert torch.equal(img3, torch.from_numpy(img1)) and rays3 == 3 * rays1
    assert isinstance(rays3, int)
    ref, jrays = trace_pallas.render_chain(jcs, params, cfg, k=3, interpret=True)
    ref = np.asarray(ref)
    assert _rmse(img3.numpy(), ref) < 1e-5 and np.abs(img3.numpy() - ref).max() < 1e-3
    assert abs(rays3 - float(jrays)) <= 8 * 3
    with pytest.raises(ValueError, match="k must be"):
        ttm.render_chain(cset, uni, lights, tcfg, k=0)


@pytest.mark.parametrize("aa", [1, 4, 3])
def test_megakernel_plain_vs_wavefront_plain(aa):
    """Same camera rays and the same bounce code, so the same per-sample
    colours and ray counts. The AA mean is acc * float32(1/aa) in the
    megakernel and acc / aa in the wavefront: bit-equal when aa is a power
    of two (1, 4), one rounding apart otherwise (aa 3: <= 1e-6)."""
    st = cosig_tpu.RenderSettings(resolution_override=(24, 16), max_depth=3, **dict(
        EFFECTS, aa_samples=aa))
    _, (cset, uni, lights, cfg) = _setup("tiny", st)
    img_m, rays_m = ttm.render_clusters(cset, uni, lights, cfg, plain=True)
    img_w, rays_w = ttw.render_wavefront(cset, uni, lights, cfg, plain=True)
    assert rays_m == rays_w
    if aa in (1, 4):
        assert torch.equal(img_m, img_w)
    else:
        d = (img_m - img_w).abs().max().item()
        assert 0 < d <= 1e-6


@pytest.mark.parametrize("name", ["demo_cornell", "tiny"])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_debug_modes_match_jax_debug_kernel(name, mode):
    """One centre ray per pixel, depth 1: max <= 2e-6 and H * W rays, also
    under the orthographic toggle (the centre ray stays perspective)."""
    imgs = []
    for ortho in (False, True):
        st = cosig_tpu.RenderSettings(resolution_override=(40, 24), debug_mode=mode,
                                      is_orthographic=ortho)
        (jcs, params, cfg), (cset, uni, lights, tcfg) = _setup(name, st)
        ref, jrays = trace_pallas.render_debug(jcs, params, cfg, interpret=True)
        img, rays = ttm.render_debug(cset, uni, lights, tcfg)
        assert img.shape == (24, 40, 3) and rays == 40 * 24 == float(jrays)
        assert np.abs(img.numpy() - np.asarray(ref)).max() <= 2e-6
        imgs.append(img)
    assert torch.equal(imgs[0], imgs[1])


def test_renderer_megakernel_equals_plain_call():
    scene = cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    st = cosig_tpu_torch.RenderSettings(resolution_override=(20, 12), max_depth=3, aa_samples=2)
    r = cosig_tpu_torch.Renderer(device="cpu", backend="megakernel")
    assert r.backend == "megakernel"
    img = r.render(scene, st)
    params = tsoa.frame_params(scene, st)
    cfg = tsoa.static_config(scene, st)
    ref, rays = ttm.render_clusters(r._geometry_for(scene)[0], tkc.build_uniforms(params),
                                    tkc.build_lights(params, False), cfg, plain=True)
    np.testing.assert_array_equal(img, ref.numpy())
    assert r.last_stats.rays_traced == rays >= 20 * 12 * 2
    assert cosig_tpu_torch.Renderer(device="cpu").backend == "wavefront"


@pytest.mark.parametrize("backend", ["pallas", "cuda", "xla_brute", ""])
def test_unknown_backend_raises(backend):
    """"pallas" is the JAX package's name (the CLI maps it); "auto" and
    "xla" are backends of the port since the oracle path came."""
    with pytest.raises(ValueError, match="unknown backend"):
        cosig_tpu_torch.Renderer(device="cpu", backend=backend)


def test_cuda_megakernel_renderer_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cosig_tpu_torch.Renderer(device="cuda", backend="megakernel")
