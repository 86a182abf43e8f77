"""The port's oracle path (``cosig_tpu_torch.ops.trace_xla`` and its
parts) held to the JAX package's on the CPU.

The JAX oracle runs two ways here. Jitted, XLA:CPU fuses it into one
program and contracts multiply-adds, so its float32 results move by ulps
against any IEEE evaluation, and by whole pixels where a scene decides a
tie by ulps. Operation by operation (``jax.disable_jit``, the ``op_by_op``
fixture), each XLA operation rounds on its own, as the port's PyTorch
operations do. The port is held to the op-by-op oracle at the port's
gates (depth 1: max <= 2e-6; depth >= 2: RMSE < 1e-5 and max < 1e-3; rays
within 8) and to the jitted one where the jitted program is stable; the
place where it is not is proven pixel by pixel in numpy float32
(test_coplanar_glass_face_decided_by_contraction)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu
import cosig_tpu_torch
from cosig_tpu.models.soa import compile_scene as jcompile
from cosig_tpu.models.soa import frame_params as jframe_params
from cosig_tpu.models.soa import static_config as jstatic_config
from cosig_tpu.ops import analytic as janalytic
from cosig_tpu.ops import bvh_traverse as jbvh
from cosig_tpu.ops import camera as jcamera
from cosig_tpu.ops import intersect as jintersect
from cosig_tpu.ops import rng as jrng
from cosig_tpu.ops import shade as jshade
from cosig_tpu.ops import trace_xla as jtrace
from cosig_tpu.scene.generate import CONFIGS as JCONFIGS
from cosig_tpu.scene.tessellate import extract_triangles as jextract
from cosig_tpu.utils.png import read_png
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import analytic as tanalytic
from cosig_tpu_torch.ops import bvh_traverse as tbvh
from cosig_tpu_torch.ops import camera as tcamera
from cosig_tpu_torch.ops import intersect as tintersect
from cosig_tpu_torch.ops import rng as trng
from cosig_tpu_torch.ops import shade as tshade
from cosig_tpu_torch.ops import trace_xla as ttrace
from cosig_tpu_torch.scene.generate import CONFIGS as TCONFIGS
from cosig_tpu_torch.scene.tessellate import extract_triangles as textract

F = np.float32
ROOT = pathlib.Path(__file__).resolve().parents[1]
CORNELL = str(ROOT / "scenes" / "demo_cornell.txt")
EFFECTS = dict(aa_samples=4, enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
               surface_roughness=0.05, enable_motion_blur=True, shutter_speed=0.5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these frames are small, and the suite runs
    several test processes at once, where torch's thread pools would
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def op_by_op(monkeypatch):
    """Evaluate the JAX oracle one XLA operation at a time: ``disable_jit``,
    with ``lax.fori_loop`` as a Python loop over int32 depths (the oracle's
    bounce loop reads ``depth.astype``, which a Python int lacks)."""

    def fori_loop(lower, upper, body, carry):
        for i in range(lower, upper):
            carry = body(jnp.int32(i), carry)
        return carry

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    with jax.disable_jit():
        yield


def _scenes(name):
    """(JAX-built scene, port-built scene)."""
    if name == "demo_cornell":
        return cosig_tpu.load_scene(CORNELL), cosig_tpu_torch.load_scene(CORNELL)
    if name == "mixed":
        from test_analytic import _mixed_scene

        return _mixed_scene(), chip_smoke.mixed_scene()
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene(), cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    return JCONFIGS[name]()[0], TCONFIGS[name]()[0]


def _setup(name, **kw):
    """(JAX arrays, params, cfg), (port arrays, params, cfg) of one frame."""
    jscene, tscene = _scenes(name)
    jst, tst = cosig_tpu.RenderSettings(**kw), cosig_tpu_torch.RenderSettings(**kw)
    return ((jcompile(jscene), jframe_params(jscene, jst), jstatic_config(jscene, jst)),
            (tsoa.compile_scene(tscene), tsoa.frame_params(tscene, tst),
             tsoa.static_config(tscene, tst)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


def _fan(n, seed, origin, forward):
    """Seeded unit directions around ``forward`` from one origin."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(F) * F(0.35) + np.asarray(forward, F)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F)
    return np.tile(np.asarray(origin, F), (n, 1)), d


def _camera_fan(name, n=512, seed=0):
    """A fan of rays from the scene's camera toward what it looks at."""
    (ja, jp, jc), _ = _setup(name)
    m = np.asarray(jp.cam_to_obj, F)
    origin = m[:3, :3] @ np.array([0, 0, jp.cam_distance], F) + m[:3, 3]
    return _fan(n, seed, origin, -m[:3, 2])


# ---------------------------------------------------------------------------
# Parts


def test_moller_trumbore_and_brute_force_match_jax():
    """demo_cornell against a seeded fan: the pair grid equal to the JAX
    function's op-by-op bits; closest_hit_brute against the jitted JAX scan
    (test_bvh.py:80-85): hits equal, t within rtol 1e-5, materials equal
    apart from exact-t ties."""
    (ja, _, _), (ta, _, _) = _setup("demo_cornell")
    o, d = _camera_fan("demo_cornell")
    valid, t, u, v = tintersect.moller_trumbore(torch.from_numpy(o[:64]), torch.from_numpy(d[:64]),
                                                ta.tri_v0[:300], ta.tri_v1[:300], ta.tri_v2[:300])
    with jax.disable_jit():
        ref = jintersect.moller_trumbore(jnp.asarray(o[:64]), jnp.asarray(d[:64]),
                                         ja.tri_v0[:300], ja.tri_v1[:300], ja.tri_v2[:300])
    assert valid.any()
    for got, want in zip((valid, t, u, v), ref):
        np.testing.assert_array_equal(_np(got), _np(want))

    h = tintersect.closest_hit_brute(ta, torch.from_numpy(o), torch.from_numpy(d))
    hj = jax.jit(jintersect.closest_hit_brute)(ja, jnp.asarray(o), jnp.asarray(d))
    hit = _np(hj.hit)
    assert 0.2 < hit.mean()
    np.testing.assert_array_equal(_np(h.hit), hit)
    np.testing.assert_allclose(_np(h.t)[hit], _np(hj.t)[hit], rtol=1e-5)
    assert (_np(h.material)[hit] != _np(hj.material)[hit]).mean() < 0.02
    np.testing.assert_array_equal(_np(h.material)[~hit], -1)
    np.testing.assert_array_equal(_np(h.normal)[~hit], np.tile([0.0, 1.0, 0.0], ((~hit).sum(), 1)))


def test_brute_force_ties_go_to_the_first_triangle():
    """Equal t: the first triangle in soup order wins, inside a block of 256
    (first-occurrence argmin) and across blocks (a later block must be
    strictly nearer), as in the JAX scan."""
    _, tscene = _scenes("demo_cornell")
    tris = textract(tscene)
    idx = np.arange(tris.count)
    mat2 = int(tris.material[2])
    for dup in (5, 300):  # same block as triangle 2, and two blocks later
        order = idx.copy()
        order[dup] = 2
        soup = _take(tris, order, relabel=(dup, (mat2 + 1) % 5))
        ta = tsoa.compile_scene(tscene, soup)
        o, d = _camera_fan("demo_cornell", n=256, seed=dup)
        h = tintersect.closest_hit_brute(ta, torch.from_numpy(o), torch.from_numpy(d))
        jt = jax.jit(jintersect.closest_hit_brute)(
            jcompile(_scenes("demo_cornell")[0], soup), jnp.asarray(o), jnp.asarray(d))
        np.testing.assert_array_equal(_np(h.material), _np(jt.material))
        assert (_np(h.material) == mat2).sum() > 0  # rays meet the tied pair
    # Direct: the same triangle three times; the winner is index 0.
    v = torch.tensor([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]])
    scene = tsoa.SceneArrays(tri_v0=v[[0, 0, 0]], tri_v1=v[[1, 1, 1]], tri_v2=v[[2, 2, 2]],
                             tri_n0=torch.zeros(3, 3), tri_n1=torch.zeros(3, 3),
                             tri_n2=torch.zeros(3, 3), tri_mat=torch.tensor([7, 8, 9]),
                             mat_color=torch.ones(10, 3), mat_coeff=torch.ones(10, 5))
    h = tintersect.closest_hit_brute(scene, torch.tensor([[0.0, 0.0, 5.0]]),
                                     torch.tensor([[0.0, 0.0, -1.0]]), chunk=2)
    assert h.material.tolist() == [7] and h.t.tolist() == [5.0]


def _take(tris, order, relabel):
    """The soup in ``order`` as the JAX package's TriangleSoA (both packages
    take it), triangle ``relabel[0]`` given material ``relabel[1]``."""
    from cosig_tpu.scene.tessellate import TriangleSoA

    t = tris.take(order)
    mat = t.material.copy()
    mat[relabel[0]] = relabel[1]
    return TriangleSoA(v0=t.v0, v1=t.v1, v2=t.v2, n0=t.n0, n1=t.n1, n2=t.n2, material=mat)


@pytest.mark.parametrize("ortho", [False, True])
def test_camera_matches_jax(ortho):
    """sample_offsets and generate_rays (perspective and orthographic)
    against the JAX functions: max abs <= 2e-6."""
    (_, jp, jc), (_, tp, tc) = _setup("demo_cornell", resolution_override=(61, 37),
                                      is_orthographic=ortho)
    ys, xs = np.meshgrid(np.arange(37, dtype=F), np.arange(61, dtype=F), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    with jax.disable_jit():
        for count, samples in ((1, [0]), (4, [0, 1, 2, 3]), (3, [2])):
            for s in samples:
                jo = jcamera.sample_offsets(jnp.asarray(px), jnp.asarray(py), s, count)
                to = tcamera.sample_offsets(tpx, tpy, s, count)
                for a, b in zip(to, jo):
                    assert np.abs(_np(a) - _np(b)).max() <= 2e-6
                ray_j = jcamera.generate_rays(jnp.asarray(px), jnp.asarray(py), *jo, 61, 37,
                                              jp.cam_to_obj, jp.cam_distance, jp.fov_deg,
                                              jp.ortho_size, ortho)
                ray_t = tcamera.generate_rays(tpx, tpy, *to, 61, 37, tp.cam_to_obj,
                                              tp.cam_distance, tp.fov_deg, tp.ortho_size, ortho)
                for a, b in zip(ray_t, ray_j):
                    assert a.shape == (61 * 37, 3)
                    assert np.abs(_np(a) - _np(b)).max() <= 2e-6
        ruv_j = jrng.random_unit_vector(jnp.asarray(px), jnp.asarray(py), jnp.asarray(px + py))
    ruv_t = trng.random_unit_vector(tpx, tpy, tpx + tpy)
    assert np.abs(_np(ruv_t) - _np(ruv_j)).max() <= 2e-6


def _shading_inputs(seed, n=2048):
    r = np.random.default_rng(seed)

    def unit(shape):
        v = r.normal(size=shape).astype(F)
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(F)

    mat_idx = r.integers(-1, 5, n).astype(np.int32)
    return dict(mat=mat_idx, normal=unit((n, 3)), light=unit((n, 3)), view=unit((n, 3)),
                pos=r.uniform(-10, 10, (n, 3)).astype(F), lit=r.random(n) < 0.7,
                rgb=r.uniform(0.2, 1.0, 3).astype(F))


@pytest.mark.parametrize("diffuse,specular,refraction", [(True, True, True), (True, False, False),
                                                         (False, True, True)])
def test_shading_matches_jax(diffuse, specular, refraction):
    """fetch_material, lambert_blinn_phong and secondary_ray on seeded
    inputs over demo_cornell's materials (a mirror, a glass with ior 1.5,
    misses): max abs <= 2e-6, continuation flags equal."""
    (ja, _, _), (ta, _, _) = _setup("demo_cornell")
    x = _shading_inputs(int(diffuse) + 2 * int(specular))
    ndl_np = np.maximum(F(0.0), (x["normal"] * x["light"]).sum(1)).astype(F)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    with jax.disable_jit():
        jm = jshade.fetch_material(ja, jnp.asarray(x["mat"]))
        want = jshade.lambert_blinn_phong(jm, x["normal"], x["light"], -x["view"], ndl_np,
                                          x["lit"], x["rgb"], diffuse, specular)
        sec_j = jshade.secondary_ray(jm, x["pos"], x["normal"], x["view"], refraction)
    tm = tshade.fetch_material(ta, t["mat"].long())
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(_np(a), _np(b))
    got = tshade.lambert_blinn_phong(tm, t["normal"], t["light"], -t["view"],
                                     torch.from_numpy(ndl_np), t["lit"], t["rgb"], diffuse, specular)
    assert np.abs(_np(got) - _np(want)).max() <= 2e-6
    sec_t = tshade.secondary_ray(tm, t["pos"], t["normal"], t["view"], refraction)
    np.testing.assert_array_equal(_np(sec_t.continue_ray), _np(sec_j.continue_ray))
    for a, b in zip(sec_t[:3], sec_j[:3]):
        assert np.abs(_np(a) - _np(b)).max() <= 2e-6


@pytest.mark.parametrize("name", ["mixed", "tiny"])
def test_closest_hit_analytic_matches_jax(name):
    """Triangles without the primitives, then the analytic spheres and
    boxes, on a seeded fan: hits and materials equal, t, position and
    normal within 2e-6 of the JAX function."""
    jscene, tscene = _scenes(name)
    ja = jcompile(jscene, jextract(jscene, include_primitives=False))
    ta = tsoa.compile_scene(tscene, textract(tscene, include_primitives=False))
    jp, tp = janalytic.compile_analytic(jscene), tanalytic.compile_analytic(tscene)
    o, d = _camera_fan(name, n=1024, seed=3)
    with jax.disable_jit():
        hj = janalytic.closest_hit_analytic(ja, jp, jnp.asarray(o), jnp.asarray(d))
    ht = tanalytic.closest_hit_analytic(ta, tp, torch.from_numpy(o), torch.from_numpy(d))
    hit = _np(hj.hit)
    tri_only = tintersect.closest_hit_brute(ta, torch.from_numpy(o), torch.from_numpy(d))
    assert 0.1 < hit.mean() < 1.0 and (ht.t < tri_only.t).any()  # primitives win some rays
    np.testing.assert_array_equal(_np(ht.hit), hit)
    np.testing.assert_array_equal(_np(ht.material), _np(hj.material))
    assert np.abs(_np(ht.t)[hit] - _np(hj.t)[hit]).max() <= 2e-6 * max(1.0, _np(hj.t)[hit].max())
    for a, b in ((ht.position, hj.position), (ht.normal, hj.normal)):
        assert np.abs(_np(a) - _np(b)).max() <= 2e-6 * max(1.0, np.abs(_np(b)).max())


# ---------------------------------------------------------------------------
# Whole frames


# Depth 1 at AA 1 is held to the jitted oracle below.
RENDER_CASES = [
    ("d1 aa4", dict(max_depth=1, aa_samples=4), {}),
    ("d3 aa1", dict(max_depth=3), {}),
    ("d3 effects", dict(max_depth=3, **EFFECTS), {}),
    ("d1 ortho", dict(max_depth=1, is_orthographic=True), {}),
    ("d3 ortho", dict(max_depth=3, is_orthographic=True), {}),
    ("d3 band", dict(max_depth=3), dict(rows=13, row_offset=11)),
]


def _hold(img, ref, rays, ref_rays, depth):
    assert np.isfinite(img).all() and img.max() > 0.05
    d = np.abs(img - ref)
    if depth == 1:
        assert d.max() <= 2e-6, d.max()
    else:
        assert _rmse(img, ref) < 1e-5 and d.max() < 1e-3, (_rmse(img, ref), d.max())
    assert abs(rays - int(ref_rays)) <= 8


@pytest.mark.parametrize("label,kw,band", RENDER_CASES, ids=[c[0] for c in RENDER_CASES])
def test_render_image_matches_jax_op_by_op(op_by_op, label, kw, band):
    """demo_cornell 61 x 37 (partial 8192-pixel tiles) through
    ``trace_xla.render_image`` against the JAX oracle evaluated op by op."""
    (ja, jp, jc), (ta, tp, tc) = _setup("demo_cornell", resolution_override=(61, 37), **kw)
    ref, ref_rays = jtrace.render_image(ja, jp, jc, with_rays=True, **band)
    img, rays = ttrace.render_image(ta, tp, tc, with_rays=True, **band)
    assert img.shape == (band.get("rows", 37), 61, 3)
    _hold(img.numpy(), np.asarray(ref), rays, ref_rays, kw["max_depth"])


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_render_image_matches_jitted_jax(mode):
    """Depth 1 and the debug views (one centre ray, perspective even under
    ortho) against the jitted JAX oracle: max <= 2e-6, rays within 8."""
    kw = dict(max_depth=1, debug_mode=mode, is_orthographic=mode == 3)
    (ja, jp, jc), (ta, tp, tc) = _setup("demo_cornell", resolution_override=(61, 37), **kw)
    ref, ref_rays = jtrace.render_jit(ja, jp, jc, with_rays=True)
    img, rays = ttrace.render_image(ta, tp, tc, with_rays=True)
    _hold(img.numpy(), np.asarray(ref), rays, ref_rays, 1)
    if mode:
        assert rays == 61 * 37


def test_coplanar_glass_face_decided_by_contraction():
    """demo_cornell at depth >= 2 is where the jitted JAX oracle and any
    IEEE evaluation part: the glass box's back face lies in the plane of
    the back wall (z = -6), so every ray refracted through the box meets
    two coplanar triangles, and ulps decide which. Pixel (18, 34) at depth
    2: the port and the op-by-op oracle (here: numpy float32, one rounding
    per operation) put the primary hit exactly on the front face, z = 0,
    and the refracted ray reaches the white wall first; the jitted program
    computes o + t d as one fused multiply-add (one rounding of the exact
    product and sum), lands 8.6e-7 behind the face, and meets the glass
    face first."""
    (ja, jp, jc), (ta, tp, tc) = _setup("demo_cornell", resolution_override=(61, 37), max_depth=2)
    img = ttrace.render_image(ta, tp, tc).numpy()
    jit = np.asarray(jtrace.render_jit(ja, jp, jc))
    assert _rmse(img, jit) > 1e-3  # the two programs part on many pixels
    np.testing.assert_array_equal(img[18, 34], np.full(3, F(0.85) * F(0.1) * F(0.9), F))
    np.testing.assert_array_equal(jit[18, 34], np.zeros(3, F))

    # The primary ray of that pixel and its hit on the glass box, port side.
    px, py, half = (torch.tensor([v], dtype=torch.float32) for v in (34.0, 18.0, 0.5))
    o, d = tcamera.generate_rays(px, py, half, half, 61, 37, tp.cam_to_obj, tp.cam_distance,
                                 tp.fov_deg, tp.ortho_size, False)
    h = tintersect.closest_hit_brute(ta, o, d)
    o, d, t = o.numpy()[0], d.numpy()[0], F(h.t.item())
    assert int(h.material) == 4 and o.dtype == d.dtype == F
    ieee = o + t * d  # float32: the product rounds, then the sum
    fused = (o.astype(np.float64) + np.float64(t) * d.astype(np.float64)).astype(F)
    assert ieee[2] == 0.0 and fused[2] == F(-8.5595093e-07)
    np.testing.assert_array_equal(ieee, h.position.numpy()[0])

    # The refracted ray from each origin against the two coplanar candidates.
    def second_hit(pos):
        p = torch.from_numpy(pos[None])
        m = tshade.fetch_material(ta, h.material)
        sec = tshade.secondary_ray(m, p, h.normal, torch.from_numpy(d[None]), True)
        hh = tintersect.closest_hit_brute(ta, sec.next_origin, tintersect.normalize(sec.next_dir))
        return int(hh.material), float(hh.t)

    wall, glass = second_hit(ieee), second_hit(fused)
    assert wall[0] == 0 and glass[0] == 4  # white wall / glass box
    assert abs(wall[1] - glass[1]) < 2e-6 * wall[1]  # the same plane, ulps apart


# ---------------------------------------------------------------------------
# The BVH walk


@pytest.fixture(scope="module")
def large_mesh():
    jscene, tscene = _scenes("large_mesh")
    jt, tt = jextract(jscene), textract(tscene)
    return (jscene, jt, jbvh.build_bvh_device(jt)), (tscene, tt, tbvh.build_bvh_device(tt))


def test_build_bvh_device_equal_to_jax(large_mesh):
    (_, _, jb), (_, _, tb) = large_mesh
    assert tb.max_leaf == jb.max_leaf == 4
    for name in ("node_min", "node_max", "left_or_first", "count", "v0", "v1", "v2", "n0", "n1",
                 "n2", "mat"):
        np.testing.assert_array_equal(_np(getattr(tb, name)), _np(getattr(jb, name)), err_msg=name)
    assert tb.v0.shape[0] == 11970 + 4


def test_closest_hit_bvh_matches_jax_walk_and_brute(large_mesh):
    """A seeded fan at the knot: the port's walk against the JAX walk and the
    port's brute force (test_bvh.py:80-85)."""
    (jscene, jt, jb), (tscene, tt, tb) = large_mesh
    o, d = _camera_fan("large_mesh", n=768, seed=11)
    got = tbvh.closest_hit_bvh(tb, None, torch.from_numpy(o), torch.from_numpy(d))
    want = jax.jit(jbvh.closest_hit_bvh)(jb, None, jnp.asarray(o), jnp.asarray(d))
    brute = tintersect.closest_hit_brute(tsoa.compile_scene(tscene, tt), torch.from_numpy(o),
                                         torch.from_numpy(d))
    hit = _np(want.hit)
    assert 0.2 < hit.mean() < 1.0
    for ref in (want, brute):
        np.testing.assert_array_equal(_np(got.hit), _np(ref.hit))
        np.testing.assert_allclose(_np(got.t)[hit], _np(ref.t)[hit], rtol=1e-5)
        assert (_np(got.material)[hit] != _np(ref.material)[hit]).mean() < 0.02


def test_render_bvh_matches_jax_and_brute(large_mesh):
    """large_mesh at 48 x 32, depth 2: the port's walk against the JAX
    package's (render_jit_bvh) and the port's brute force, at
    test_bvh.py:93-95's bounds; and the Renderer's "xla" takes the walk
    above 4096 triangles, "xla-brute" never does."""
    (jscene, jt, jb), (tscene, tt, tb) = large_mesh
    kw = dict(resolution_override=(48, 32), max_depth=2)
    jst, tst = cosig_tpu.RenderSettings(**kw), cosig_tpu_torch.RenderSettings(**kw)
    ref = np.asarray(jbvh.render_jit_bvh(jcompile(jscene, jt), jb, jframe_params(jscene, jst),
                                         jstatic_config(jscene, jst)))
    r = cosig_tpu_torch.Renderer(device="cpu", backend="xla")
    img = r.render(tscene, tst)
    assert isinstance(r._cached_xla[4], tbvh.BVHDevice)
    brute_r = cosig_tpu_torch.Renderer(device="cpu", backend="xla-brute")
    brute = brute_r.render(tscene, tst)
    assert brute_r._cached_xla[4] is None
    assert r.last_stats.triangles == 11970 and r.last_stats.rays_traced >= 48 * 32
    for other in (ref, brute):
        d = np.abs(img - other).max(axis=2)
        assert (d > 1e-3).mean() < 0.005
        assert _rmse(img, other) < 1e-3
    assert abs(r.last_stats.rays_traced - brute_r.last_stats.rays_traced) <= 8


# ---------------------------------------------------------------------------
# Closed-form shading (tests/test_render.py:55-181) on three backends


def _make_scene(materials, triangles, light_z=66.0, bg=(0.0, 0.0, 1.0)):
    from cosig_tpu_torch.models.scene import (
        CameraSettings,
        CompositeTransformation,
        ImageSettings,
        LightSource,
        SceneData,
        TransformElement,
        TrianglesMesh,
    )

    return SceneData(
        image=ImageSettings(horizontal=32, vertical=32, background=bg),
        transformations=[
            CompositeTransformation(),
            CompositeTransformation([TransformElement.translation((0, 0, light_z))]),
        ],
        camera=CameraSettings(transformation_index=0, distance=10.0, vertical_fov_deg=60.0),
        lights=[LightSource(transformation_index=1, rgb=(1, 1, 1))],
        materials=materials,
        triangle_meshes=[TrianglesMesh(transformation_index=0, triangles=triangles)],
    )


def _closed_form_cases():
    from cosig_tpu_torch.models.scene import ImageSettings, LightSource, SceneData
    from cosig_tpu_torch.models.scene import MaterialDescription as M
    from cosig_tpu_torch.models.scene import Triangle

    big = [Triangle(0, (-50, -50, 0), (50, -50, 0), (0, 50, 0))]
    S = cosig_tpu_torch.RenderSettings
    kA, kD, kS = 0.1, 0.6, 0.25
    two_lights = _make_scene([M(color=(1, 1, 1), ambient=0.0, diffuse=0.5)], big)
    two_lights.lights.append(LightSource(transformation_index=1, rgb=(1.0, 0.0, 0.0)))
    return {
        "empty": (SceneData(image=ImageSettings(16, 16, (0.3, 0.4, 0.5))), S(), None,
                  (0.3, 0.4, 0.5), 1e-6),
        "ambient": (_make_scene([M(color=(1, 0, 0), ambient=0.3, diffuse=0.5)], big),
                    S(enable_diffuse=False, light_intensity_scale=2.0), None, (0.6, 0.0, 0.0), 1e-5),
        "blinn_phong": (_make_scene([M(color=(0.0, 1.0, 0.0), ambient=kA, diffuse=kD, specular=kS)],
                                    big), S(max_depth=1), None, (kS, kA + kD + kS, kS), 2e-3),
        "shadow": (_make_scene([M(color=(1, 1, 1), ambient=0.2, diffuse=0.7),
                                M(color=(1, 1, 1), ambient=0.0, diffuse=0.0)],
                               big + [Triangle(1, (-1, -1, 50), (1, -1, 50), (0, 1, 50))]),
                   S(max_depth=1), None, (0.2, 0.2, 0.2), 1e-4),
        "mirror": (_make_scene([M(color=(1.0, 0.5, 1.0), ambient=0.0, diffuse=0.0, specular=0.5)],
                               big), S(max_depth=2, enable_ambient=False, enable_diffuse=False,
                                       enable_specular=False), None, (0.0, 0.0, 0.5), 1e-5),
        "refraction_ior1": (_make_scene([M(color=(1.0, 1.0, 0.25), refraction=0.8, ior=1.0)], big,
                                        bg=(1.0, 1.0, 1.0)),
                            S(max_depth=2, enable_ambient=False, enable_diffuse=False), None,
                            (0.8, 0.8, 0.2), 1e-5),
        "refraction_off": (_make_scene([M(color=(1, 1, 1), specular=0.25, refraction=0.9, ior=1.2)],
                                       big, bg=(1.0, 0.0, 0.0)),
                           S(max_depth=2, enable_ambient=False, enable_diffuse=False,
                             enable_refraction=False), None, (0.25, 0.0, 0.0), 1e-5),
        "dead_end": (_make_scene([M(color=(0.5, 0.5, 0.5), ambient=1.0)], big, bg=(9.0, 9.0, 9.0)),
                     S(max_depth=5, enable_diffuse=False), None, (0.5, 0.5, 0.5), 1e-5),
        "debug_hit": (_make_scene([M(color=(1, 1, 1), ambient=1.0)], big), S(debug_mode=3), None,
                      (0.0, 1.0, 0.0), 1e-6),
        "debug_miss": (SceneData(image=ImageSettings(16, 16, (0, 0, 0))), S(debug_mode=3), (0, 0),
                       (0.2, 0.2, 0.2), 1e-6),
        "one_light": (two_lights, S(max_depth=1), None, (0.5, 0.5, 0.5), 1e-4),
        "multi_light": (two_lights, S(max_depth=1, multi_light=True), None, (1.0, 0.5, 0.5), 1e-4),
    }


@pytest.mark.parametrize("backend", ["xla", "wavefront", "megakernel"])
@pytest.mark.parametrize("case", sorted(_closed_form_cases()))
def test_closed_form_shading(backend, case):
    scene, settings, pixel, expected, atol = _closed_form_cases()[case]
    img = cosig_tpu_torch.Renderer(device="cpu", backend=backend).render(scene, settings)
    at = pixel or (img.shape[0] // 2, img.shape[1] // 2)
    np.testing.assert_allclose(img[at], expected, atol=atol)
    if case == "shadow":
        assert img[1, 1, 0] > 0.3  # lit off the shadow


@pytest.fixture(scope="module")
def cornell_96_d4():
    """demo_cornell 96 x 96, depth 4 on the port's "xla" and plain
    "wavefront" backends, and the golden image (8-bit)."""
    scene = cosig_tpu_torch.load_scene(CORNELL)
    st = cosig_tpu_torch.RenderSettings(resolution_override=(96, 96), max_depth=4)
    imgs = {b: cosig_tpu_torch.Renderer(device="cpu", backend=b).render(scene, st)
            for b in ("xla", "wavefront")}
    golden = read_png(str(ROOT / "tests" / "goldens" / "demo_cornell_96_d4.png")).astype(F) / 255.0
    return imgs, golden


@pytest.mark.parametrize("backend", ["xla", "wavefront"])
def test_demo_cornell_golden(op_by_op, cornell_96_d4, backend):
    """The golden gate of test_goldens.py:51-54 (RMSE < 2e-3 in 8-bit
    space). The golden is the jitted JAX oracle's image, and 20 of its
    pixels (rows 42-52, the glass box in front of the back wall) are
    coplanar ties its fused multiply-adds decided (see
    test_coplanar_glass_face_decided_by_contraction): the JAX oracle
    evaluated op by op misses the golden there exactly as the port does
    (RMSE 2.28e-3 over the frame). So: every pixel more than one 8-bit
    step off the golden is one the op-by-op JAX oracle renders bit for bit
    as the port does, and the frame without those pixels meets the gate."""
    imgs, golden = cornell_96_d4
    img = imgs[backend]
    q = np.clip(np.round(img * 255.0), 0, 255) / 255.0
    off = np.abs(q - golden).max(axis=2) > 1.5 / 255.0
    rows, cols = np.nonzero(off)
    assert 0 < off.sum() <= 20 and rows.min() >= 42 and rows.max() <= 52
    (ja, jp, jc), _ = _setup("demo_cornell", resolution_override=(96, 96), max_depth=4)
    ref, _ = jtrace.trace_pixels(ja, jp, jc, jnp.asarray(cols, F), jnp.asarray(rows, F))
    np.testing.assert_array_equal(img[off], np.asarray(ref))
    assert _rmse(q[~off], golden[~off]) < 2e-3


def test_analytic_and_debug_on_the_oracle_path():
    """analytic_primitives on "xla" (the triangle scan, then the analytic
    fold) against the plain wavefront at depth 2, and the backend that
    "auto" resolves to on each device."""
    _, scene = _scenes("mixed")
    st = cosig_tpu_torch.RenderSettings(resolution_override=(64, 48), max_depth=2,
                                        analytic_primitives=True)
    x = cosig_tpu_torch.Renderer(device="cpu", backend="auto")
    assert x.resolve_backend() == "xla"
    img = x.render(scene, st)
    w = cosig_tpu_torch.Renderer(device="cpu", backend="wavefront").render(scene, st)
    assert img.max() > 0.2 and _rmse(img, w) < 1e-5 and np.abs(img - w).max() < 1e-3
    dbg = x.render(scene, st.replace(debug_mode=1))
    dbg_w = cosig_tpu_torch.Renderer(device="cpu").render(scene, st.replace(debug_mode=1))
    assert np.abs(dbg - dbg_w).max() <= 2e-6
    with pytest.raises(ValueError, match="debug_mode"):
        x.render(scene, st.replace(debug_mode=4))
