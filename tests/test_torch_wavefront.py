"""The port's wavefront render (plain PyTorch on the CPU) against the JAX
package's backends, on one identical cluster structure: the JAX
``ClusterSet`` is carried across with ``cluster_set_from_arrays``. The
frame parameters come from each package's own scene and settings.

JAX runs as its own tests run it on the CPU: the wavefront Pallas
kernels in interpret mode, and the XLA oracle ``trace_xla``. Tolerances
are the ones the JAX backends hold among themselves
(tests/test_pallas.py)."""

import dataclasses

import numpy as np
import pytest

import chip_smoke
import cosig_tpu
import cosig_tpu_torch
from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import trace_wavefront as jtw
from cosig_tpu.ops import trace_xla
from cosig_tpu.scene.generate import CONFIGS
from cosig_tpu_torch.accel.clusters import cluster_set_from_arrays
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.scene import generate as tgen


def _scene(name):
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene()
    if name == "demo_cornell":
        return cosig_tpu.load_scene("scenes/demo_cornell.txt")
    return CONFIGS[name]()[0]


def _port_scene(name):
    """The same scene built with the port's own modules."""
    if name == "tiny":
        return cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    if name == "demo_cornell":
        return cosig_tpu_torch.load_scene("scenes/demo_cornell.txt")
    return tgen.CONFIGS[name]()[0]


def _setup(name, settings):
    """(JAX arrays, JAX params, JAX cfg, JAX cluster set) and the port's
    (cluster set from the JAX arrays, uniforms, lights, cfg)."""
    scene = _scene(name)
    arrays = jsoa.compile_scene(scene)
    jparams = jsoa.frame_params(scene, settings)
    jcfg = jsoa.static_config(scene, settings)
    jcs = jcl.build_clusters(arrays)
    cset = cluster_set_from_arrays(np.asarray(jcs.geom), np.asarray(jcs.aabb_t),
                                   np.asarray(jcs.sb_aabb_t), np.asarray(jcs.mats))
    port_scene = _port_scene(name)
    port_settings = cosig_tpu_torch.RenderSettings(**dataclasses.asdict(settings))
    tparams = tsoa.frame_params(port_scene, port_settings)
    tcfg = tsoa.static_config(port_scene, port_settings)
    port = (cset, tkc.build_uniforms(tparams), tkc.build_lights(tparams, tcfg.multi_light), tcfg)
    return (arrays, jparams, jcfg, jcs), port


def _port_render(port, **kw):
    cset, uni, lights, cfg = port
    img, rays = ttw.render_wavefront(cset, uni, lights, cfg, **kw)
    return img.numpy(), rays


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def test_demo_cornell_depth1_matches_jax_wavefront():
    st = cosig_tpu.RenderSettings(resolution_override=(64, 48), max_depth=1)
    (arrays, params, cfg, jcs), port = _setup("demo_cornell", st)
    ref, jrays = jtw.render_wavefront(jcs, params, cfg, interpret=True)
    img, rays = _port_render(port)
    assert img.shape == (48, 64, 3)
    assert np.abs(img - np.asarray(ref)).max() <= 2e-6
    assert abs(rays - float(jrays)) <= 8


def test_tiny_depth3_matches_jax_wavefront():
    st = cosig_tpu.RenderSettings(resolution_override=(32, 32), max_depth=3)
    (arrays, params, cfg, jcs), port = _setup("tiny", st)
    ref, jrays = jtw.render_wavefront(jcs, params, cfg, interpret=True)
    ref = np.asarray(ref)
    img, rays = _port_render(port)
    assert _rmse(img, ref) < 1e-5
    assert np.abs(img - ref).max() < 1e-3
    assert abs(rays - float(jrays)) <= 8
    assert isinstance(rays, int) and rays >= 32 * 32


def test_effects_match_oracle_on_stable_pixels():
    """AA 4, soft shadows, glossy and motion blur against the XLA oracle,
    with test_pallas.py's rule: a pixel may differ by more than 1e-3 only
    where one of the programs is itself unstable (its own render at
    another program shape moves the pixel by more than 1e-6) — grazing
    stochastic rays amplify float32 ULPs there."""
    st = cosig_tpu.RenderSettings(
        resolution_override=(32, 32), max_depth=2, aa_samples=4,
        enable_soft_shadows=True, light_size=5.0,
        enable_glossy=True, surface_roughness=0.05,
        enable_motion_blur=True, shutter_speed=0.5,
    )
    (arrays, params, cfg, _), port = _setup("tiny", st)
    ref = np.asarray(trace_xla.render_jit(arrays, params, cfg))
    ref2 = np.asarray(trace_xla.render_jit(arrays, params, cfg, pixel_tile=512))
    img, _ = _port_render(port)
    # The port at another shape: the frame rendered as two row bands.
    top, _ = _port_render(port, rows=13, row_offset=0)
    bottom, _ = _port_render(port, rows=19, row_offset=13)
    img2 = np.concatenate([top, bottom])
    diff = np.abs(img - ref).max(axis=2)
    unstable = (np.abs(ref - ref2).max(axis=2) > 1e-6) | (np.abs(img - img2).max(axis=2) > 1e-6)
    assert ((diff > 1e-3) & ~unstable).sum() == 0
    assert diff.max() < 0.05
    # RMSE within 1e-4 of the oracle's own shape noise (on this scene the
    # oracle at pixel_tile 512 is itself ~1.2e-4 away from its default).
    assert _rmse(img, ref) < 1e-4 + _rmse(ref, ref2)


ORACLE_CASES = [
    ("orthographic", "tiny", dict(max_depth=2, is_orthographic=True)),
    ("multi_light", "cosig_walls", dict(max_depth=2, multi_light=True)),
    ("toggles", "tiny", dict(max_depth=3, enable_ambient=False, enable_specular=False,
                             enable_refraction=False)),
    ("no_diffuse", "tiny", dict(max_depth=2, enable_diffuse=False)),
]


@pytest.mark.parametrize("label,name,kw", ORACLE_CASES, ids=[c[0] for c in ORACLE_CASES])
def test_matches_oracle(label, name, kw):
    st = cosig_tpu.RenderSettings(resolution_override=(32, 32), **kw)
    (arrays, params, cfg, _), port = _setup(name, st)
    ref, jrays = trace_xla.render_jit(arrays, params, cfg, with_rays=True)
    img, rays = _port_render(port)
    assert _rmse(img, np.asarray(ref)) < 1e-5
    assert abs(rays - float(jrays)) <= 8

