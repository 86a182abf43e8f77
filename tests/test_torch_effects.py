"""The stochastic effects (soft shadows, glossy, motion blur) and the
fission forms with every effect, held to the JAX package at the slice
tolerances: depth 1 max <= 2e-6; deeper RMSE < 1e-5 and max < 1e-3; rays
within 8.

The JAX references render in a child process with
``XLA_FLAGS=--xla_cpu_max_isa=AVX``. XLA:CPU's default code contracts the
multiply-adds of ``rng.hash33`` into FMA instructions, and the hash ends in
a fractional part that turns those ulps into jumps of up to 1 in the
jitter: the jitted JAX hash then differs from its own op-by-op form (and
from the port, which rounds every operation) on about a third of the
seeds, so the effect renders part on grazing and jittered pixels. AVX has
no FMA, so the child's XLA rounds as the port does, and what is left is
sin/cos ulps. The flag must be set before JAX starts, and
``tests/conftest.py`` imports JAX for every test process, hence the child
process. :func:`jax_references` is the helper; ``test_torch_mxu.py`` uses it
for the JAX package's MXU form as well. The stable-pixel tests of
``test_torch_wavefront.py`` stay as they are: these add checks beside them.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from cosig_tpu_torch.ops import trace_megakernel as ttm
from cosig_tpu_torch.ops import trace_wavefront as ttw

ROOT = pathlib.Path(__file__).resolve().parents[1]

# The child: renders each job of a JSON list with the JAX package in
# interpret mode and saves "<key>/img" and "<key>/rays" into an .npz.
# A job: key, scene ("tiny", "demo_cornell" or a generate.CONFIGS name),
# settings (RenderSettings keywords), path ("wavefront" or "megakernel"),
# mxu (the MXU form: COSIG_MXU=force, or trace_pallas._MXU_ENV = "force"),
# closest (with mxu: closest-only mode, COSIG_MXU_SHADOW=0, which
# trace_wavefront._stage_resources reads at each call), fission
# (trace_wavefront._FISSION), ks ({"main"/"primary"/"shadow": k or None,
# the cluster sets of the render; default the auto-k main set).
_CHILD = r"""
import json, os, sys
import numpy as np
import cosig_tpu
from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import trace_pallas
from cosig_tpu.ops import trace_wavefront as jtw
from cosig_tpu.scene.generate import CONFIGS

jobs, out = json.loads(sys.argv[1]), sys.argv[2]
res = {}
for job in jobs:
    name = job["scene"]
    if name == "tiny":
        from __graft_entry__ import _tiny_scene
        scene = _tiny_scene()
    elif name == "demo_cornell":
        scene = cosig_tpu.load_scene("scenes/demo_cornell.txt")
    else:
        scene = CONFIGS[name]()[0]
    kw = dict(job["settings"])
    if "resolution_override" in kw:
        kw["resolution_override"] = tuple(kw["resolution_override"])
    st = cosig_tpu.RenderSettings(**kw)
    arrays = jsoa.compile_scene(scene)
    params, cfg = jsoa.frame_params(scene, st), jsoa.static_config(scene, st)
    sets = {n: jcl.build_clusters(arrays, k=k) for n, k in job.get("ks", {"main": None}).items()}
    mxu = "force" if job.get("mxu") else "0"
    os.environ["COSIG_MXU"] = mxu
    os.environ["COSIG_MXU_SHADOW"] = "0" if job.get("closest") else "1"
    trace_pallas._MXU_ENV = mxu
    jtw._FISSION = bool(job.get("fission"))
    if job["path"] == "megakernel":
        img, rays = trace_pallas.render_clusters(sets["main"], params, cfg, interpret=True)
    else:
        img, rays = jtw.render_wavefront(sets["main"], params, cfg, interpret=True,
                                         cset_primary=sets.get("primary"),
                                         cset_shadow=sets.get("shadow"))
    res[job["key"] + "/img"] = np.asarray(img)
    res[job["key"] + "/rays"] = np.asarray(float(rays))
np.savez(out, **res)
"""


def jax_references(jobs: list, tmp_path) -> dict:
    """Render ``jobs`` (see _CHILD) with the JAX package in a child process
    whose XLA emits no FMA (``--xla_cpu_max_isa=AVX``) -> {key: (image
    [H, W, 3] numpy, rays)}."""
    out = pathlib.Path(tmp_path) / "jax_refs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX")
    for var in ("COSIG_MXU", "COSIG_MXU_SHADOW", "COSIG_WF_FISSION"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(jobs), str(out)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    data = np.load(out)
    return {job["key"]: (data[job["key"] + "/img"], float(data[job["key"] + "/rays"]))
            for job in jobs}


def hold_slice(img, rays, ref, ref_rays, max_depth):
    """The slice tolerances of a port frame against the JAX reference."""
    img = img.numpy() if isinstance(img, torch.Tensor) else img
    assert img.shape == ref.shape
    assert abs(rays - ref_rays) <= 8
    d = np.abs(img.astype(np.float64) - ref)
    if max_depth == 1:
        assert d.max() <= 2e-6, d.max()
    else:
        assert np.sqrt((d ** 2).mean()) < 1e-5, np.sqrt((d ** 2).mean())
        assert d.max() < 1e-3, d.max()


SOFT = dict(enable_soft_shadows=True, light_size=5.0)
GLOSSY = dict(enable_glossy=True, surface_roughness=0.05)
BLUR = dict(enable_motion_blur=True, shutter_speed=0.5)
# key -> (scene, settings, fission form with k = 8 primary and k = 64 shadow sets)
CASES = {
    "soft_d1": ("tiny", dict(resolution_override=(32, 32), max_depth=1, **SOFT), False),
    "soft_glossy_d3_aa2": ("tiny", dict(resolution_override=(32, 32), max_depth=3, aa_samples=2,
                                        **SOFT, **GLOSSY), False),
    "all_effects_d2_aa4": ("tiny", dict(resolution_override=(32, 32), max_depth=2, aa_samples=4,
                                        **SOFT, **GLOSSY, **BLUR), False),
    "fission_all_effects": ("tiny", dict(resolution_override=(32, 32), max_depth=3,
                                         aa_samples=2, **SOFT, **GLOSSY, **BLUR), True),
}
FORM_KS = dict(main=None, primary=8, shadow=64)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    jobs = [dict(key=key, scene=name, settings=kw, path="wavefront", fission=fission,
                 **({"ks": FORM_KS} if fission else {}))
            for key, (name, kw, fission) in CASES.items()]
    return jax_references(jobs, tmp_path_factory.mktemp("effects"))


@pytest.mark.parametrize("key", list(CASES))
def test_effects_match_jax_without_fma(refs, key):
    """The port's wavefront (the plain stages on the CPU; with every effect
    in the fission form and both separate sets) against the JAX package's
    wavefront at the slice tolerances."""
    name, kw, fission = CASES[key]
    s = chip_smoke.scene_setup(name, kw, "cpu")
    forms = {}
    if fission:
        sets = chip_smoke.form_sets(s, dict(primary=FORM_KS["primary"], shadow=FORM_KS["shadow"]),
                                    "cpu")
        forms = dict(fission=True, cset_primary=sets["primary"], cset_shadow=sets["shadow"])
    img, rays = ttw.render_wavefront(s["cset"], s["uni"], s["lights"], s["cfg"], **forms)
    hold_slice(img, rays, *refs[key], s["cfg"].max_depth)


def test_megakernel_effects_match_the_wavefront():
    """The megakernel's plain version with every effect equals the
    wavefront's at AA 4 bit for bit (the same device code, and acc *
    f32(1/4) is acc / 4), so the JAX-held wavefront holds it too."""
    name, kw, _ = CASES["all_effects_d2_aa4"]
    s = chip_smoke.scene_setup(name, kw, "cpu")
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    img_w, rays_w = ttw.render_wavefront(*a)
    img_m, rays_m = ttm.render_clusters(*a)
    assert torch.equal(img_w, img_m) and rays_w == rays_m
