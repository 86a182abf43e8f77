"""The slab cull's two exact pre-filters in the port (the superblock cull
and the bounding-frustum cull of cosig_tpu/ops/kernel_core.py:455-590) on
the CPU, through their plain versions (cosig_tpu_torch/ops/kernel_core.py):

a. properties: a packet's frustum flag is set whenever some active ray of
   the packet passes the per-ray slab test of the box, and a superblock's
   flag whenever some active ray passes a cluster box inside the union,
   with zero and -0 direction components, origins on a face, NaN padding
   columns and max_t among the cases;
b. the port's ``build_clusters(k=8)`` equals the JAX build on large_mesh,
   1,734 clusters in c_pad 2048: four superblocks;
c. on that set the traversal with the pre-filters gives the bits of the
   flat walk, with the same pair tests and fewer slab tests;
d. the slice: the port's plain wavefront and megakernel renders of that
   set against the JAX package's wavefront and megakernel in interpret
   mode, which run the JAX superblock and frustum culls at CULL_BLOCK 512,
   at the tolerances the JAX backends hold among themselves
   (tests/test_pallas.py: RMSE < 1e-5, max < 1e-3, rays within 8)."""

import math

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import trace_pallas
from cosig_tpu.ops import trace_wavefront as jtw
from cosig_tpu.scene import generate as jgen
from cosig_tpu.scene.tessellate import TriangleSoA as JTriangleSoA
from cosig_tpu_torch.accel import clusters as tcl
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import camera
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_megakernel as ttm
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.scene import generate as tgen
from cosig_tpu_torch.scene.tessellate import TriangleSoA, extract_triangles

NAN = float("nan")


def _slab(box, ox, oy, oz, dx, dy, dz, max_t=None):
    """The per-ray slab test of traverse (kernel_core.py:430-449), each ray
    against one box (b0..b5) -> bool [N]."""
    idx, idy, idz = torch.reciprocal(dx), torch.reciprocal(dy), torch.reciprocal(dz)
    t0x, t1x = (box[0] - ox) * idx, (box[3] - ox) * idx
    t0y, t1y = (box[1] - oy) * idy, (box[4] - oy) * idy
    t0z, t1z = (box[2] - oz) * idz, (box[5] - oz) * idz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    ok = ~(tn > tf) & ~(tf < 0.0)
    return ok if max_t is None else ok & ~(tn > max_t)


# Box bounds, and per ray and axis an origin (a float, or the box's low or
# high face on that axis) and a direction component (either zero, a
# subnormal whose reciprocal is infinite, or a float).
_BOUND = st.one_of(st.sampled_from([0.0, -1.0, 1.0, 2.5]),
                   st.floats(-4.0, 4.0, width=32))
_ORIGIN = st.one_of(st.sampled_from(["lo", "hi"]), st.floats(-6.0, 6.0, width=32))
_DIR = st.one_of(st.sampled_from([0.0, -0.0, 1e-40, -1e-40, 1.0, -1.0, 0.5]),
                 st.floats(-1.0, 1.0, width=32))
_RAY = st.tuples(st.booleans(), st.tuples(_ORIGIN, _ORIGIN, _ORIGIN),
                 st.tuples(_DIR, _DIR, _DIR))
_BOX = st.tuples(st.tuples(_BOUND, _BOUND), st.tuples(_BOUND, _BOUND),
                 st.tuples(_BOUND, _BOUND))
_MAX_T = st.one_of(st.none(), st.sampled_from([0.0, -1.0, NAN, math.inf]),
                   st.floats(0.0, 20.0, width=32))


def _box(axes):
    """((a, b), ...) per axis -> [lo xyz, hi xyz]."""
    return [min(a, b) for a, b in axes] + [max(a, b) for a, b in axes]


def _rays(rays, face_box):
    """Drawn rays -> (active [N], six planes [N]); an origin "lo" / "hi" sits
    on that face of ``face_box``."""
    act = torch.tensor([a for a, _, _ in rays])
    o = [[face_box[ax] if c == "lo" else face_box[ax + 3] if c == "hi" else c
          for ax, c in enumerate(org)] for _, org, _ in rays]
    d = [list(dr) for _, _, dr in rays]
    planes = [torch.tensor([r[ax] for r in o], dtype=torch.float32) for ax in range(3)]
    planes += [torch.tensor([r[ax] for r in d], dtype=torch.float32) for ax in range(3)]
    return act, planes


def _max_t(max_t, n):
    return None if max_t is None else torch.full((n,), max_t, dtype=torch.float32)


@settings(max_examples=400, deadline=None, database=None)
@given(box=_BOX, rays=st.lists(_RAY, min_size=1, max_size=6), max_t=_MAX_T,
       nan_column=st.booleans())
@example(box=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0)),
         rays=[(True, ("lo", 5.0, 0.5), (0.0, 1.0, 0.0))], max_t=None, nan_column=True)
@example(box=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0)),
         rays=[(True, ("lo", 5.0, 0.5), (1e-40, 1.0, 0.0)),
               (True, (0.5, 5.0, 0.5), (1.0, 1.0, 0.0))], max_t=None, nan_column=False)
@example(box=((0.0, 1.0), (0.0, 1.0), (0.0, 1.0)),
         rays=[(True, (0.5, 0.5, -2.0), (0.0, 0.0, 1.0))], max_t=-1.0, nan_column=False)
def test_frustum_flag_covers_every_ray_that_passes_the_slab_test(box, rays, max_t, nan_column):
    """One packet: the frustum flag of each box (a NaN padding column too)
    is set whenever an active ray of the packet passes that box's slab test
    (with the any hit's max_t clip when drawn). The examples are the cases
    the JAX form misses: a ray on a face with a zero (or subnormal)
    direction component, whose NaN slab passes while the hull misses the
    box on another axis; and a negative max_t."""
    b = _box(box)
    act, planes = _rays(rays, b)
    mt = _max_t(max_t, len(rays))
    cols = [b] + ([[NAN] * 6] if nan_column else [])
    boxes = torch.tensor(cols, dtype=torch.float32).T
    hull = tkc.packet_hulls(torch.zeros(len(rays), dtype=torch.int64), 1, act, *planes,
                            max_t=mt)
    flags = tkc.frustum_flags(hull, boxes)
    assert flags.shape == (1, len(cols))
    for w, col in enumerate(cols):
        passed = _slab(col, *planes, max_t=mt) & act
        if bool(passed.any()):
            assert bool(flags[0, w]), (col, rays)


@settings(max_examples=400, deadline=None, database=None)
@given(boxes=st.lists(_BOX, min_size=1, max_size=4), rays=st.lists(_RAY, min_size=1, max_size=6),
       max_t=_MAX_T, packets=st.lists(st.integers(0, 2), min_size=6, max_size=6))
@example(boxes=[((0.0, 1.0), (0.0, 1.0), (0.0, 1.0)), ((-1.0, 0.0), (0.0, 1.0), (0.0, 1.0))],
         rays=[(True, ("lo", 5.0, 0.5), (0.0, 1.0, 0.0))], max_t=None, packets=[0] * 6)
@example(boxes=[((0.0, 1.0), (0.0, 1.0), (0.0, 1.0)), ((-1.0, 0.0), (0.0, 1.0), (0.0, 1.0))],
         rays=[(True, ("lo", 5.0, 0.5), (-0.0, 1.0, 0.0))], max_t=2.0, packets=[1] * 6)
def test_superblock_flag_covers_every_cluster_a_ray_passes(boxes, rays, max_t, packets):
    """Cluster boxes and their union (as accel/clusters.py builds
    sb_aabb_t): a packet's superblock flag is set whenever an active ray of
    the packet passes some cluster's slab test. Origins on a face are
    drawn on the first cluster's faces; the examples put one on a face
    inside the union with a zero direction component (+0 and -0), whose
    slab test on that cluster is NaN and passes, though the ray misses the
    union on another axis."""
    cl = [_box(bx) for bx in boxes]
    union = [min(c[a] for c in cl) for a in range(3)] + [max(c[a] for c in cl) for a in range(3, 6)]
    act, planes = _rays(rays, cl[0])
    n = len(rays)
    mt = _max_t(max_t, n)
    pk = torch.tensor(packets[:n], dtype=torch.int64)
    flags = tkc.superblock_flags(pk, 3, act, *planes,
                                 torch.tensor([union], dtype=torch.float32).T, max_t=mt)
    assert flags.shape == (3, 1)
    for col in cl:
        passed = _slab(col, *planes, max_t=mt) & act
        for r in torch.nonzero(passed).squeeze(1).tolist():
            assert bool(flags[packets[r], 0]), (col, rays[r])


def test_flags_of_empty_packets_and_padding_columns():
    """A packet with no active ray passes nothing it is tested on through
    traverse (its rays test no cluster), and NaN padding columns pass."""
    planes = [torch.tensor([0.0, 0.0]), torch.tensor([0.0, 0.0]), torch.tensor([-5.0, -5.0]),
              torch.tensor([0.0, 0.0]), torch.tensor([0.0, 0.0]), torch.tensor([1.0, 1.0])]
    act = torch.tensor([True, False])
    hull = tkc.packet_hulls(torch.tensor([0, 1]), 2, act, *planes)
    assert hull["live"].tolist() == [True, False]
    boxes = torch.tensor([[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], [5.0, 5.0, -9.0, 6.0, 6.0, -8.0],
                          [NAN] * 6], dtype=torch.float32).T
    flags = tkc.frustum_flags(hull, boxes)
    assert flags[0].tolist() == [True, False, True]


# ---------------------------------------------------------------------------
# b. The cluster build with an explicit k.


@pytest.fixture(scope="module")
def large_k8():
    """large_mesh's JAX cluster set at k = 8 and the port's, each from its
    own package's scene and triangles."""
    jscene, _ = jgen.CONFIGS["large_mesh"]()
    ref = jcl.build_clusters(jsoa.compile_scene(jscene), k=8)
    scene, settings = tgen.CONFIGS["large_mesh"]()
    mats = np.concatenate(tsoa.materials_host(scene), axis=1)
    port = tcl.build_clusters(extract_triangles(scene), mats, k=8)
    return ref, port, scene, settings


def test_build_clusters_k8_equals_jax(large_k8):
    ref, port, _, _ = large_k8
    for field in ("geom", "aabb_t", "sb_aabb_t", "mats"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, field)),
                                      getattr(port, field).numpy(), err_msg=field)
    assert port.k == 8 and port.num_clusters == 1734 and tuple(port.aabb_t.shape) == (8, 2048)
    assert port.num_triangles == ref.num_triangles
    # Four superblocks of 512: real unions, the rest of the 128 columns NaN.
    sb = port.sb_aabb_t.numpy()
    assert np.isfinite(sb[:6, :4]).all() and np.isnan(sb[:, 4:]).all()


def _soup(v0):
    """Triangles at corners ``v0`` [n, 3], the port's and the JAX package's
    TriangleSoA."""
    n = v0.shape[0]
    z = np.tile(np.array([0, 0, 1], np.float32), (n, 1))  # the faces' own normal
    f = dict(v0=v0, v1=v0 + np.array([0.1, 0, 0], np.float32),
             v2=v0 + np.array([0, 0.1, 0], np.float32), n0=z, n1=z, n2=z,
             material=np.zeros(n, np.int32))
    return TriangleSoA(**f), JTriangleSoA(**f)


@pytest.mark.parametrize("k", [0, -8, 2.0, "8"])
def test_build_clusters_rejects_a_bad_k_as_jax_does(k):
    tris, jtris = _soup(np.zeros((1, 3), np.float32))
    with pytest.raises(ValueError, match="cluster size k"):
        tcl.build_clusters(tris, np.zeros((1, 8), np.float32), k=k)
    with pytest.raises(ValueError, match="cluster size k"):
        jcl.build_clusters(None, tris=jtris, k=k)


@pytest.fixture(scope="module")
def past_superblocks():
    """65,537 triangles in clusters of one (k = 1): one cluster more than
    128 superblocks of 512 cover."""
    n = tcl.MAX_CLUSTERS + 1
    v0 = np.random.default_rng(3).uniform(-50, 50, (n, 3)).astype(np.float32)
    tris, _ = _soup(v0)
    return v0, tcl.build_clusters(tris, np.zeros((1, 8), np.float32), k=1)


def test_more_clusters_than_superblocks_hold_raise(past_superblocks):
    """Past 128 superblocks of 512 (sb_aabb_t's width) the JAX build drops
    the superblocks it cannot hold; the port builds the set, keeps the
    first 128 unions as JAX's build does, and its walks test no
    superblock there: ``superblocks`` is 0 (the kernels pick their flat
    build by the same rule), and the kernels' input checks accept it."""
    assert [tcl.superblocks(c) for c in (1, 512, 513, 1024, 1025, 65536, 65537)] == \
        [0, 0, 2, 2, 3, 128, 0]
    _, cset = past_superblocks
    assert cset.num_clusters == tcl.MAX_CLUSTERS + 1 and cset.k == 1
    assert tcl.superblocks(cset.num_clusters) == 0
    assert np.isfinite(cset.sb_aabb_t.numpy()[:6]).all()
    pk = tkc.prim_table(None, (0, 0), "cpu")
    binding.check_inputs(cset, torch.device("cpu"), *pk)


def test_flat_walk_past_the_superblocks_keeps_its_bits(past_superblocks):
    """On the 65,537-cluster set the traversal with the kernels' blocks
    tests no superblock and returns the flat walk's outputs bit for bit:
    closest hits in frustum mode (the frustum cull still runs and cuts the
    slab tests; the pair tests stay), and any hits in the bounce's mode,
    whose superblock cull is all it has, so its counts are the flat
    walk's."""
    v0, cset = past_superblocks
    # Two blocks of 128 rays from one eye, each aimed inside the triangles
    # nearest one point of the cloud (so every ray hits).
    centres = np.array([[20.0, -10.0, 5.0], [-30.0, 25.0, -15.0]], np.float32)
    picks = np.concatenate([np.argsort(((v0 - c) ** 2).sum(1), kind="stable")[:128]
                            for c in centres])
    target = v0[picks] + np.float32(0.02)
    target[:, 2] = v0[picks, 2]
    eye = np.array([0.0, 0.0, -200.0], np.float32)
    d = target - eye
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = picks.size
    planes = [torch.full((n,), float(e)) for e in eye] + [torch.from_numpy(d[:, a].copy())
                                                          for a in range(3)]
    active = torch.ones(n, dtype=torch.bool)
    packets = tkc.linear_packets(n)

    flat, w_flat = _run(cset, planes, active)
    culled, w_cull = _run(cset, planes, active, packets=packets, frustum=True)
    assert int(flat[0].sum()) == n and _same(flat, culled)
    assert w_cull["pair_tests"] == w_flat["pair_tests"] and w_cull["superblock_tests"] == 0
    assert w_cull["slab_tests"] < w_flat["slab_tests"] and w_cull["frustum_tests"] > 0

    max_t = flat[1] * 0.999  # short of the hit: the other triangles on the way occlude
    occ_flat, w_flat = _run(cset, planes, active, max_t=max_t)
    occ_cull, w_cull = _run(cset, planes, active, max_t=max_t, packets=packets)
    assert _same(occ_flat, occ_cull)
    assert w_cull == w_flat


def test_check_inputs_needs_the_superblock_boxes(large_k8):
    """The kernels read sb_aabb_t [8, 128]: a cluster set without it is
    refused before any launch."""
    from dataclasses import replace

    _, port, _, _ = large_k8
    pk = tkc.prim_table(None, (0, 0), "cpu")
    binding.check_inputs(port, torch.device("cpu"), *pk)
    with pytest.raises(ValueError, match="sb_aabb_t"):
        binding.check_inputs(replace(port, sb_aabb_t=port.sb_aabb_t[:, :4].contiguous()),
                             torch.device("cpu"), *pk)


# ---------------------------------------------------------------------------
# c. The pre-filters change no result.


def _frame(scene, settings, side, depth=2):
    settings = settings.replace(resolution_override=(side, side), max_depth=depth)
    params = tsoa.frame_params(scene, settings)
    cfg = tsoa.static_config(scene, settings)
    return cfg, tkc.build_uniforms(params), tkc.build_lights(params, cfg.multi_light)


def _run(cset, planes, active, max_t=None, **kw):
    tkc.reset_work()
    out = tkc.traverse(cset, *planes, active, max_t=max_t, any_hit=max_t is not None, **kw)
    return out, dict(tkc.WORK)


def _same(a, b):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def test_prefilters_keep_the_flat_walks_bits(large_k8):
    """Camera rays (blocks of 128 consecutive rays, as the primary kernel),
    their shadow rays and their secondary rays on the 1,734-cluster set:
    the traversal with the kernels' pre-filters (frustum and superblock for
    the coherent rays, superblock only for the secondary rays) returns the
    flat walk's outputs bit for bit, with the same pair tests and fewer
    slab tests; the superblock and frustum tests are counted."""
    _, cset, scene, settings = large_k8
    cfg, uni, lights = _frame(scene, settings, 32)
    n = 32 * 32
    px, py, s = ttw._seed_planes(torch.arange(n), cfg, 0.0)
    planes = camera.primary_rays(cfg, [float(x) for x in uni], px, py, s)
    active = torch.ones(n, dtype=torch.bool)
    packets = tkc.linear_packets(n)

    flat, w_flat = _run(cset, planes, active)
    culled, w_cull = _run(cset, planes, active, packets=packets, frustum=True)
    assert _same(flat, culled)
    assert w_cull["pair_tests"] == w_flat["pair_tests"] > 0
    assert w_cull["slab_tests"] < w_flat["slab_tests"] // 2
    assert w_cull["frustum_tests"] > 0 and w_cull["superblock_tests"] == n // 128 * 4
    assert w_flat["frustum_tests"] == w_flat["superblock_tests"] == 0

    hit, t, nx, ny, nz, _ = flat
    assert int(hit.sum()) > n // 2
    hx, hy, hz = (o + t * d for o, d in zip(planes[:3], planes[3:]))
    to_light = [float(lights[0, a]) - h for a, h in enumerate((hx, hy, hz))]
    dist = torch.sqrt(sum(v * v for v in to_light))
    shadow = [hx + nx * 1e-2, hy + ny * 1e-2, hz + nz * 1e-2] + [v / dist for v in to_light]
    occ_flat, w_flat = _run(cset, shadow, hit, max_t=dist)
    occ_cull, w_cull = _run(cset, shadow, hit, max_t=dist, packets=packets, frustum=True)
    assert _same(occ_flat, occ_cull) and 0 < int(occ_flat[0].sum()) < int(hit.sum())
    assert w_cull["pair_tests"] == w_flat["pair_tests"]
    assert w_cull["slab_tests"] < w_flat["slab_tests"]

    # Mirror the camera rays about the normal: incoherent secondary rays,
    # superblock cull only (blocks of 128 as the bounce's list).
    cos = planes[3] * nx + planes[4] * ny + planes[5] * nz
    second = [hx + nx * 1e-2, hy + ny * 1e-2, hz + nz * 1e-2,
              planes[3] - 2 * cos * nx, planes[4] - 2 * cos * ny, planes[5] - 2 * cos * nz]
    sec_flat, w_flat = _run(cset, second, hit)
    sec_cull, w_cull = _run(cset, second, hit, packets=packets)
    assert _same(sec_flat, sec_cull)
    assert w_cull["pair_tests"] == w_flat["pair_tests"]
    assert w_cull["slab_tests"] < w_flat["slab_tests"]
    assert w_cull["frustum_tests"] == 0 and w_cull["superblock_tests"] == int(hit.sum()) * 4


def test_rays_on_faces_with_zero_directions_keep_their_hits(large_k8):
    """Axis-parallel rays whose origins sit on cluster faces (the NaN slabs
    the pre-filters must keep): the walk with the pre-filters, in frustum
    and in superblock mode, gives the flat walk's bits."""
    _, cset, _, _ = large_k8
    box = cset.aabb_t[:6, :cset.num_clusters]
    r = np.random.default_rng(11)
    n = 512
    pick = torch.from_numpy(r.integers(0, cset.num_clusters, n))
    axis = torch.from_numpy(r.integers(0, 3, n))
    o = [box[a, pick] + (box[a + 3, pick] - box[a, pick]) * 0.5 for a in range(3)]
    d = [torch.zeros(n) for _ in range(3)]
    for a in range(3):
        on, travel = axis == a, (a + 1) % 3
        o[a] = torch.where(on, box[a, pick], o[a])  # on the low face of axis a,
        o[travel] = torch.where(on, o[travel] - 30.0, o[travel])  # 30 back along
        d[travel] = torch.where(on, torch.tensor(1.0), d[travel])  # the travel axis
    planes = o + d
    active = torch.ones(n, dtype=torch.bool)
    packets = torch.arange(n) // 128
    flat, _ = _run(cset, planes, active)
    for frustum in (False, True):
        culled, _ = _run(cset, planes, active, packets=packets, frustum=frustum)
        assert _same(flat, culled), frustum


# ---------------------------------------------------------------------------
# d. The slice against the JAX package's culls.


@pytest.fixture(scope="module")
def jax_renders(large_k8):
    """large_mesh 32x32, depth 2, k = 8 through the JAX wavefront and
    megakernel in interpret mode (superblock and frustum culls on)."""
    ref, _, _, _ = large_k8
    jscene, jsettings = jgen.CONFIGS["large_mesh"]()
    jsettings = jsettings.replace(resolution_override=(32, 32), max_depth=2)
    params = jsoa.frame_params(jscene, jsettings)
    cfg = jsoa.static_config(jscene, jsettings)
    assert int(ref.aabb_t.shape[1]) // jcl.CULL_BLOCK == 4  # the blocked cull runs
    wf, wf_rays = jtw.render_wavefront(ref, params, cfg, interpret=True)
    mk, mk_rays = trace_pallas.render_clusters(ref, params, cfg, interpret=True)
    return dict(wavefront=(np.asarray(wf), float(wf_rays)),
                megakernel=(np.asarray(mk), float(mk_rays)))


@pytest.mark.parametrize("path", ["wavefront", "megakernel"])
def test_slice_matches_jax_culls_on_four_superblocks(large_k8, jax_renders, path):
    _, cset, scene, settings = large_k8
    cfg, uni, lights = _frame(scene, settings, 32)
    render = ttw.render_wavefront if path == "wavefront" else ttm.render_clusters
    img, rays = render(cset, uni, lights, cfg)
    img = img.numpy()
    ref, ref_rays = jax_renders[path]
    d = np.abs(img.astype(np.float64) - ref)
    assert np.sqrt((d ** 2).mean()) < 1e-5 and d.max() < 1e-3, (d.max(),)
    assert abs(rays - ref_rays) <= 8
    assert np.isfinite(img).all() and img.mean() > 0.05


def test_megakernel_and_wavefront_plain_agree_with_the_prefilters(large_k8):
    """Both plain paths run the pre-filters on their own blocks (128
    consecutive rays; 16 x 8 pixel tiles): at AA 1 they give the same bits,
    and the debug view's depth equals the primary's closest hit."""
    _, cset, scene, settings = large_k8
    cfg, uni, lights = _frame(scene, settings, 24, depth=3)
    img_w, rays_w = ttw.render_wavefront(cset, uni, lights, cfg)
    img_m, rays_m = ttm.render_clusters(cset, uni, lights, cfg)
    assert torch.equal(img_w, img_m) and rays_w == rays_m
    dcfg = tsoa.static_config(scene, settings.replace(resolution_override=(24, 24),
                                                       debug_mode=1))
    tkc.reset_work()
    img_d, _ = ttm.render_debug(cset, uni, lights, dcfg)
    assert tkc.WORK["frustum_tests"] > 0 and tkc.WORK["superblock_tests"] > 0
    assert np.isfinite(img_d.numpy()).all()
