"""The port's row-band sharding (``cosig_tpu_torch.parallel.sharding``) on
the CPU: n bands on ``[cpu] * n``.

Each sharded function is held bit for bit to the port's single render
(every band is the single frame's rows: projection and RNG seeds are
global), with equal ray counts; then to the JAX package's sharded
functions on the 8 virtual CPU devices of conftest.py, at the tolerances
the JAX backends hold among themselves (depth 1: max <= 2e-6; depth >= 2:
RMSE < 1e-5 and max < 1e-3; rays within 8)."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu
import cosig_tpu_torch
from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import trace_xla as jtrace
from cosig_tpu.parallel import sharding as jsh
from cosig_tpu_torch.accel.clusters import cluster_set_from_arrays
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_megakernel as ttm
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.ops import trace_xla as ttrace
from cosig_tpu_torch.parallel import sharding as tsh

EFFECTS = dict(aa_samples=4, enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
               surface_roughness=0.05, enable_motion_blur=True, shutter_speed=0.5)
# dryrun_multichip's frame (__graft_entry__.py): the tiny scene, 32 x 24, depth 2.
DRYRUN = dict(resolution_override=(32, 24), max_depth=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the frames are small and the suite runs several
    test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(name):
    """(JAX-built scene, port-built scene)."""
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene(), cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    return (cosig_tpu.load_scene("scenes/demo_cornell.txt"),
            cosig_tpu_torch.load_scene("scenes/demo_cornell.txt"))


def _port(name, **kw):
    """The port's inputs of one frame: cluster set, uniforms, lights, cfg,
    and the oracle's scene arrays and frame parameters."""
    s = chip_smoke.scene_setup(name, kw, "cpu")
    return dict(s, arrays=tsoa.compile_scene(s["scene"]),
                params=tsoa.frame_params(s["scene"], s["settings"]))


def _cpus(n):
    return tsh.make_mesh(devices=["cpu"] * n)


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def _hold(img, ref, rays, ref_rays, depth):
    assert np.isfinite(img).all() and img.max() > 0.05
    d = np.abs(img - ref)
    if depth == 1:
        assert d.max() <= 2e-6, d.max()
    else:
        assert _rmse(img, ref) < 1e-5 and d.max() < 1e-3, (_rmse(img, ref), d.max())
    if rays is not None:
        assert abs(rays - int(ref_rays)) <= 8, (rays, ref_rays)


# The port's own single render: 32 x 24 has bands wholly below the image
# on the kernel paths (the wavefront's 64-row bands at AA 1, the
# megakernel's 32-row bands); 32 x 50 at AA 4 has bands with padding rows
# on every path (7-row oracle bands over 8 devices end at row 56).
SINGLE_CASES = {
    "dryrun 32x24 d2": DRYRUN,
    "32x50 d3 effects": dict(resolution_override=(32, 50), max_depth=3, **EFFECTS),
}


@pytest.fixture(scope="module", params=list(SINGLE_CASES))
def single(request):
    s = _port("tiny", **SINGLE_CASES[request.param])
    uni, lights, cfg = s["uni"], s["lights"], s["cfg"]
    s["wavefront"] = ttw.render_wavefront(s["cset"], uni, lights, cfg)
    s["megakernel"] = ttm.render_clusters(s["cset"], uni, lights, cfg)
    s["xla"] = ttrace.render_image(s["arrays"], s["params"], cfg)
    return s


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_sharded_bit_equal_to_single(single, n):
    s, devs = single, _cpus(n)
    uni, lights, cfg = s["uni"], s["lights"], s["cfg"]
    img, rays = tsh.render_sharded_wavefront(s["cset"], uni, lights, cfg, devs)
    assert torch.equal(img, s["wavefront"][0]) and rays == s["wavefront"][1]
    img, rays = tsh.render_sharded_megakernel(s["cset"], uni, lights, cfg, devs)
    assert torch.equal(img, s["megakernel"][0]) and rays == s["megakernel"][1]
    assert isinstance(rays, int) and rays >= cfg.width * cfg.height
    img = tsh.render_sharded(s["arrays"], s["params"], cfg, devs)
    assert img.shape == (cfg.height, cfg.width, 3)
    assert torch.equal(img, s["xla"])


@pytest.mark.parametrize("path", ["wavefront", "megakernel"])
def test_sharded_tensor_core_frame_bit_equal_to_single(path):
    """Two bands on ``["cpu"] * 2`` in the tensor-core form (``mxu="full"``)
    are the single tensor-core frame bit for bit, as the JAX package's
    sharded frames run its MXU form whenever its stages do: a pair's planes
    are a fixed sum of exact limb products, whichever rays share a band or
    a tile. The case whose bands have padding rows, with every effect."""
    s = _port("tiny", **SINGLE_CASES["32x50 d3 effects"])
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    single, sharded = {"wavefront": (ttw.render_wavefront, tsh.render_sharded_wavefront),
                       "megakernel": (ttm.render_clusters, tsh.render_sharded_megakernel)}[path]
    img_1, rays_1 = single(*a, mxu="full")
    img, rays = sharded(*a, _cpus(2), mxu="full")
    assert torch.equal(img, img_1) and rays == rays_1
    assert not torch.equal(img_1, single(*a)[0])  # the tensor-core form ran


def test_band_heights_follow_the_jax_formulas():
    """The rows each device gets are the TPU's: the oracle's ceil(H / n),
    the megakernel's multiple of 32 (16 past one cull superblock), the
    wavefront's multiple of the primary block's rows; bands wholly below
    the image are left out."""
    from cosig_tpu.ops import trace_wavefront as jwf

    for aa in (1, 2, 3, 4, 8):
        assert tsh.primary_block(aa) == jwf._primary_block(aa)
    cfg = tsoa.StaticConfig(width=32, height=24)
    assert tsh.wavefront_band(cfg, 8) == 64
    assert tsh.wavefront_band(dataclasses.replace(cfg, height=1024, aa_samples=4), 3) == 352
    assert tsh.band_offsets(24, 64, 8) == [0]
    assert tsh.band_offsets(50, 7, 8) == [0, 7, 14, 21, 28, 35, 42, 49]
    assert tsh.xla_band(50, 8) == 7
    cset = _port("tiny", **DRYRUN)["cset"]
    assert tsh.megakernel_band(cset, 24, 4) == 32
    assert tsh.megakernel_band(chip_smoke.split_clusters(cset, 2), 24, 4) == 32
    big = dataclasses.replace(cset, aabb_t=torch.zeros(8, 1024))
    assert tsh.megakernel_band(big, 50, 2) == 32  # 16-row tiles past 512 clusters
    assert tsh.megakernel_band(cset, 50, 2, tile=(8, 16)) == 32


def test_make_mesh():
    assert tsh.make_mesh(2, devices=["cpu"] * 4) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="asked for 5 devices"):
        tsh.make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="no devices"):
        tsh.make_mesh(devices=[])


def test_band_of_2_24_rays_raises():
    """2048 x 2048 at AA 4 is 2^24 camera rays: one band holds them all and
    the wavefront refuses it before any work; two bands of 2^23 are taken
    (checked on the card: chip_smoke.py phase 7c)."""
    cfg = tsoa.StaticConfig(width=2048, height=2048, max_depth=4, aa_samples=4)
    s = _port("tiny", **DRYRUN)
    with pytest.raises(ValueError, match="f32-exact ray ids"):
        tsh.render_sharded_wavefront(s["cset"], s["uni"], s["lights"], cfg, _cpus(1))
    assert ttw.num_rays(cfg, tsh.wavefront_band(cfg, 2)) == 2 ** 23


# ---------------------------------------------------------------------------
# Against the JAX package's sharded functions


def _jax(name, n, **kw):
    """JAX (scene arrays, params, cfg, mesh of n virtual CPU devices)."""
    jscene, _ = _scenes(name)
    st = cosig_tpu.RenderSettings(**kw)
    return (jsoa.compile_scene(jscene), jsoa.frame_params(jscene, st),
            jsoa.static_config(jscene, st), jsh.make_mesh(n))


@pytest.mark.parametrize("name,kw,n", [
    ("tiny", DRYRUN, 8),
    ("tiny", dict(resolution_override=(32, 50), max_depth=1), 8),
    ("demo_cornell", dict(resolution_override=(61, 37), max_depth=1), 3),
    ("demo_cornell", dict(resolution_override=(61, 37), max_depth=1), 8),
], ids=["tiny dryrun n8", "tiny 32x50 n8", "cornell 61x37 n3", "cornell 61x37 n8"])
def test_render_sharded_matches_jax(name, kw, n):
    """The oracle path against JAX's ``render_sharded`` on the same n. JAX
    compiles each band's program, which contracts multiply-adds: demo_cornell
    is held at depth 1 only, where that moves a pixel by float32 ulps (at
    depth >= 2 its coplanar glass face turns ulps into whole pixels, and at
    AA > 1 the contracted sub-pixel offsets move rays; ROADMAP section 3,
    tests/test_torch_oracle.py)."""
    ja, jp, jc, mesh = _jax(name, n, **kw)
    ref = np.asarray(jsh.render_sharded(ja, jp, jc, mesh))
    s = _port(name, **kw)
    img = tsh.render_sharded(s["arrays"], s["params"], s["cfg"], _cpus(n)).numpy()
    assert img.shape == ref.shape == (jc.height, jc.width, 3)
    _hold(img, ref, None, None, kw["max_depth"])
    # And JAX's own single render: the sharded and single JAX frames agree.
    np.testing.assert_allclose(np.asarray(jtrace.render_jit(ja, jp, jc)), ref, atol=1e-5)


@pytest.fixture(scope="module")
def jax_kernels_sharded():
    """JAX's sharded wavefront and megakernel (Pallas in interpret mode) at
    dryrun_multichip's frame on 4 devices, against one cluster structure:
    the JAX ClusterSet, carried to the port with cluster_set_from_arrays."""
    ja, jp, jc, mesh = _jax("tiny", 4, **DRYRUN)
    jcs = jcl.build_clusters(ja)
    wave = jsh.render_sharded_wavefront(jcs, jp, jc, mesh, interpret=True)
    mega = jsh.render_sharded_pallas(jcs, jp, jc, mesh, interpret=True)
    _, tscene = _scenes("tiny")
    tset = cosig_tpu_torch.RenderSettings(**DRYRUN)
    tparams = tsoa.frame_params(tscene, tset)
    port = (cluster_set_from_arrays(np.asarray(jcs.geom), np.asarray(jcs.aabb_t),
                                    np.asarray(jcs.sb_aabb_t), np.asarray(jcs.mats)),
            tkc.build_uniforms(tparams), tkc.build_lights(tparams, jc.multi_light),
            tsoa.static_config(tscene, tset))
    return {"wavefront": [np.asarray(x) for x in wave],
            "megakernel": [np.asarray(x) for x in mega], "port": port}


def test_sharded_wavefront_matches_jax(jax_kernels_sharded):
    ref, ref_rays = jax_kernels_sharded["wavefront"]
    cset, uni, lights, cfg = jax_kernels_sharded["port"]
    img, rays = tsh.render_sharded_wavefront(cset, uni, lights, cfg, _cpus(4))
    assert img.shape == ref.shape == (24, 32, 3)
    _hold(img.numpy(), ref, rays, ref_rays, 2)


def test_sharded_megakernel_matches_jax(jax_kernels_sharded):
    """The image at the depth >= 2 tolerances. The rays equal the port's
    single render (964), not JAX's sharded count: with 4 devices JAX's
    bands are 32 rows (its tile rows), so bands 1-3 lie wholly below the
    24-row image, and ``render_clusters`` sums each band's rows up to the
    global height (trace_pallas.py:597-598); it counts 24 rows of each
    band, 4,292 rays in all, where the frame traces 964. The port counts
    the rows inside the image only and renders no band below it."""
    ref, ref_rays = jax_kernels_sharded["megakernel"]
    cset, uni, lights, cfg = jax_kernels_sharded["port"]
    img, rays = tsh.render_sharded_megakernel(cset, uni, lights, cfg, _cpus(4))
    _hold(img.numpy(), ref, None, None, 2)
    single, single_rays = ttm.render_clusters(cset, uni, lights, cfg)
    assert torch.equal(img, single) and rays == single_rays == 964
    assert int(ref_rays) == 4292
