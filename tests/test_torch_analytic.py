"""Analytic spheres and boxes in the port: the host table against the JAX
package's, the plain fold in ``kernel_core.traverse`` bit for bit against a
numpy reference of the same arithmetic, and whole renders of both backends
against the JAX package's Pallas kernels (interpret mode) through its
Renderer."""

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu
import cosig_tpu_torch
from cosig_tpu.ops import analytic as janalytic
from cosig_tpu.render.renderer import Renderer as JaxRenderer
from cosig_tpu.scene.generate import CONFIGS
from cosig_tpu_torch.accel.clusters import build_clusters
from cosig_tpu_torch.ops import analytic as tanalytic
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.scene import generate as tgen
from cosig_tpu_torch.scene.tessellate import TriangleSoA, extract_triangles

F = np.float32
N_RAYS = 4096


def _scenes(name):
    """(JAX-built scene, port-built scene)."""
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene(), cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    if name == "mixed":
        from test_analytic import _mixed_scene

        return _mixed_scene(), chip_smoke.mixed_scene()
    if name == "empty":
        return cosig_tpu.SceneData(), cosig_tpu_torch.SceneData()
    return CONFIGS[name]()[0], tgen.CONFIGS[name]()[0]


@pytest.mark.parametrize("name", ["tiny", "mixed", "cosig_walls", "glass_sphere", "empty"])
def test_pack_prims_host_bit_equal_to_jax(name):
    jscene, tscene = _scenes(name)
    ref, rs, rb = janalytic.pack_prims_host(jscene)
    table, n_sph, n_box = tanalytic.pack_prims_host(tscene)
    assert (n_sph, n_box) == (rs, rb) == (len(tscene.spheres), len(tscene.boxes))
    assert table.dtype == np.float32 and table.shape == (max(1, n_sph + n_box), 22)
    np.testing.assert_array_equal(table, ref)


def _rays(seed, table, n_prims, lo=-12.0, hi=12.0):
    """Seeded origins in a box around the primitives, unit directions aimed
    near a random primitive's centre; one ray in eight has a zero direction
    component (1/d = inf in the box slabs)."""
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (N_RAYS, 3)).astype(F)
    inv = np.zeros((n_prims, 4, 4))
    inv[:, :3, :] = table[:n_prims, :12].reshape(-1, 3, 4)
    inv[:, 3, 3] = 1.0
    centres = np.linalg.inv(inv)[:, :3, 3]
    aim = centres[r.integers(0, n_prims, N_RAYS)] + r.normal(0.0, 1.5, (N_RAYS, 3))
    d = (aim - o).astype(F)
    d[::8, r.integers(0, 3)] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F)
    return o, d


def _numpy_prims(table, n_sph, n_box, o, d):
    """Exact reference of the fold (kernel_core.py:930-1018) in numpy
    float32, which never contracts a multiply-add: closest (t, gid) over the
    primitives -> (hit, t, unit normal, material)."""
    inf = F(tkc.INF)
    eps = F(tkc.EPSILON)
    n = o.shape[0]
    best_t = np.full(n, inf, F)
    best_gid = np.full(n, F(2 ** 24), F)
    nrm = np.zeros((n, 3), F)
    mat = np.full(n, F(-1.0), F)
    ox, oy, oz = o.T
    dx, dy, dz = d.T
    with np.errstate(all="ignore"):
        for p in range(n_sph + n_box):
            m = table[p]
            oxo = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
            oyo = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
            ozo = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
            dxo = m[0] * dx + m[1] * dy + m[2] * dz
            dyo = m[4] * dx + m[5] * dy + m[6] * dz
            dzo = m[8] * dx + m[9] * dy + m[10] * dz
            if p < n_sph:
                a = dxo * dxo + dyo * dyo + dzo * dzo
                b = F(2.0) * (oxo * dxo + oyo * dyo + ozo * dzo)
                c = oxo * oxo + oyo * oyo + ozo * ozo - F(1.0)
                disc = b * b - F(4.0) * a * c
                sq = np.sqrt(np.maximum(disc, F(0.0)))
                t0 = (-b - sq) / (F(2.0) * a)
                t1 = (-b + sq) / (F(2.0) * a)
                tp = np.where(t0 > eps, t0, t1)
                valid = (disc >= 0) & (tp > eps)
                no = np.stack([oxo + tp * dxo, oyo + tp * dyo, ozo + tp * dzo], 1)
            else:
                ix, iy, iz = F(1.0) / dxo, F(1.0) / dyo, F(1.0) / dzo
                t0 = [(F(-0.5) - q) * i for q, i in ((oxo, ix), (oyo, iy), (ozo, iz))]
                t1 = [(F(0.5) - q) * i for q, i in ((oxo, ix), (oyo, iy), (ozo, iz))]
                t_en = np.maximum(np.maximum(np.minimum(t0[0], t1[0]), np.minimum(t0[1], t1[1])),
                                  np.minimum(t0[2], t1[2]))
                t_ex = np.minimum(np.minimum(np.maximum(t0[0], t1[0]), np.maximum(t0[1], t1[1])),
                                  np.maximum(t0[2], t1[2]))
                tp = np.where(t_en > eps, t_en, t_ex)
                valid = (t_en <= t_ex) & (t_ex > eps) & (tp > eps)
                hp = np.stack([oxo + tp * dxo, oyo + tp * dyo, ozo + tp * dzo], 1)
                ah = np.abs(hp)
                is_x = (ah[:, 0] >= ah[:, 1]) & (ah[:, 0] >= ah[:, 2])
                is_y = ~is_x & (ah[:, 1] >= ah[:, 2])
                no = np.zeros((n, 3), F)
                no[:, 0] = np.where(is_x, np.sign(hp[:, 0]), F(0.0))
                no[:, 1] = np.where(is_y, np.sign(hp[:, 1]), F(0.0))
                no[:, 2] = np.where(is_x | is_y, F(0.0), np.sign(hp[:, 2]))
            w = m[12:21].reshape(3, 3)
            wn = np.stack([w[i, 0] * no[:, 0] + w[i, 1] * no[:, 1] + w[i, 2] * no[:, 2]
                           for i in range(3)], 1)
            tm = np.where(valid, tp, inf)
            gid = F(2.0 ** 24 + 2) + F(2.0 * p)
            better = (tm < best_t) | ((tm == best_t) & (gid < best_gid))
            best_t = np.where(better, tm, best_t)
            best_gid = np.where(better, gid, best_gid)
            nrm = np.where(better[:, None], wn, nrm)
            mat = np.where(better, m[21], mat)
        hit = best_t < inf
        inv = F(1.0) / np.sqrt(nrm[:, 0] * nrm[:, 0] + nrm[:, 1] * nrm[:, 1]
                               + nrm[:, 2] * nrm[:, 2])
        nrm = nrm * inv[:, None]
    nrm[~hit] = (0.0, 1.0, 0.0)
    return hit, best_t, nrm, np.where(hit, mat, F(-1.0))


def _planes(o, d):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (o, d) for i in range(3)]


@pytest.mark.parametrize("name", ["tiny", "mixed", "cosig_walls"])
def test_fold_bit_equal_to_exact_reference(name):
    """Primitives alone (an empty cluster set): hit, t, normal and material
    bit for bit, ties and axis-parallel rays included."""
    _, scene = _scenes(name)
    table, n_sph, n_box = tanalytic.pack_prims_host(scene)
    cset = build_clusters(TriangleSoA.empty(), np.zeros((1, 8), F))
    o, d = _rays(n_sph + 7 * n_box, table, n_sph + n_box)
    hit, t, nx, ny, nz, mat = tkc.traverse(
        cset, *_planes(o, d), torch.ones(N_RAYS, dtype=torch.bool),
        prims=torch.from_numpy(table), n_sph=n_sph, n_box=n_box)
    r_hit, r_t, r_n, r_mat = _numpy_prims(table, n_sph, n_box, o, d)
    assert 0.02 < r_hit.mean() < 0.98  # the rays exercise hits and misses
    np.testing.assert_array_equal(hit.numpy(), r_hit)
    np.testing.assert_array_equal(t.numpy(), r_t)
    np.testing.assert_array_equal(torch.stack([nx, ny, nz], 1).numpy(), r_n)
    np.testing.assert_array_equal(mat.numpy(), r_mat)


def test_fold_with_triangles_and_any_hit():
    """Tiny scene, mesh without its primitives plus the fold: the closest
    hit is the (t, gid) minimum of the triangle walk and the fold, a
    primitive losing an equal-t tie; any-hit is t <= max_t of that hit."""
    _, scene = _scenes("tiny")
    table, n_sph, n_box = tanalytic.pack_prims_host(scene)
    cset = build_clusters(extract_triangles(scene, include_primitives=False),
                          np.zeros((2, 8), F))
    o, d = _rays(3, table, n_sph + n_box)
    planes = _planes(o, d)
    active = torch.ones(N_RAYS, dtype=torch.bool)
    pk = dict(prims=torch.from_numpy(table), n_sph=n_sph, n_box=n_box)
    tri = tkc.traverse(cset, *planes, active)
    both = tkc.traverse(cset, *planes, active, **pk)
    p_hit, p_t, p_n, p_mat = _numpy_prims(table, n_sph, n_box, o, d)
    prim_wins = p_t < tri[1].numpy()
    assert prim_wins.any() and (tri[0].numpy() & ~prim_wins).any()
    np.testing.assert_array_equal(both[1].numpy(), np.minimum(tri[1].numpy(), p_t))
    np.testing.assert_array_equal(both[5].numpy(), np.where(prim_wins, p_mat, tri[5].numpy()))
    n_both = torch.stack(both[2:5], 1).numpy()
    np.testing.assert_array_equal(n_both[prim_wins], p_n[prim_wins])
    np.testing.assert_array_equal(n_both[~prim_wins], torch.stack(tri[2:5], 1).numpy()[~prim_wins])

    r = np.random.default_rng(5)
    finite = torch.where(both[1] < tkc.INF, both[1], torch.full_like(both[1], 20.0))
    max_t = finite * torch.from_numpy(r.uniform(0.5, 1.5, N_RAYS).astype(F))
    occ = tkc.traverse(cset, *planes, active, max_t=max_t, any_hit=True, **pk)[0]
    np.testing.assert_array_equal(occ.numpy(), (both[1] <= max_t).numpy())
    half = torch.arange(N_RAYS) % 2 == 0
    occ_half = tkc.traverse(cset, *planes, half, max_t=max_t, any_hit=True, **pk)[0]
    assert not occ_half[~half].any() and torch.equal(occ_half[half], occ[half])


def _jax_render(scene, backend, **kw):
    return JaxRenderer(backend=backend).render(scene, cosig_tpu.RenderSettings(**kw))


def _port_render(scene, backend, **kw):
    r = cosig_tpu_torch.Renderer(device="cpu", backend=backend)
    return r.render(scene, cosig_tpu_torch.RenderSettings(**kw))


def _rmse(a, b):
    return float(np.sqrt(((a - b) ** 2).mean()))


@pytest.mark.parametrize("name", ["mixed", "tiny"])
def test_analytic_renders_match_jax_kernels(name):
    """Both port backends against the JAX wavefront and megakernel
    (interpret mode) at depth 2: RMSE < 1e-5, max < 1e-3.

    64x48 rather than the mixed scene's own 48x48: there, one centre ray
    grazes a box edge, where exact float32 arithmetic (the port, numpy, the
    card) misses by 4e-6 in t and the JAX package's interpret-mode program,
    which XLA compiles with contracted multiply-adds, hits; see
    test_grazing_box_edge_follows_exact_arithmetic."""
    jscene, tscene = _scenes(name)
    kw = dict(resolution_override=(64, 48), max_depth=2, analytic_primitives=True)
    ports = {b: _port_render(tscene, b, **kw) for b in ("wavefront", "megakernel")}
    np.testing.assert_array_equal(ports["wavefront"], ports["megakernel"])
    assert ports["wavefront"].max() > 0.2  # lit content
    for backend in ("wavefront", "pallas"):
        ref = _jax_render(jscene, backend, **kw)
        assert _rmse(ports["wavefront"], ref) < 1e-5, backend
        assert np.abs(ports["wavefront"] - ref).max() < 1e-3, backend


def test_analytic_debug_depth_matches_jax():
    """Debug mode 1 (one centre ray, depth t / 100) with analytic
    primitives: max <= 2e-6."""
    jscene, tscene = _scenes("mixed")
    kw = dict(resolution_override=(64, 48), debug_mode=1, analytic_primitives=True)
    ref = _jax_render(jscene, "wavefront", **kw)
    for backend in ("wavefront", "megakernel"):
        img = _port_render(tscene, backend, **kw)
        assert np.abs(img - ref).max() <= 2e-6
        assert (img[..., 1] > 0).mean() > 0.05  # some pixels hit a primitive


def test_grazing_box_edge_follows_exact_arithmetic():
    """The mixed scene's own 48x48 debug frame differs from the JAX render
    in one pixel, (15, 32): its centre ray meets the box's corner edge,
    where the slab entry t exceeds the exit t by a few ulps in exact float32
    arithmetic (a miss), as the port computes it."""
    _, scene = _scenes("mixed")
    st = cosig_tpu_torch.RenderSettings(debug_mode=3, analytic_primitives=True)
    img = _port_render(scene, "wavefront", debug_mode=3, analytic_primitives=True)
    assert img.shape == (48, 48, 3)
    np.testing.assert_array_equal(img[15, 32], np.full(3, 0.2, F))  # a miss
    assert img[16, 32, 1] == img[15, 33, 1] == 1.0  # neighbours below and right hit
    # The same ray in numpy: entry 15.272612 > exit 15.272608.
    from cosig_tpu_torch.models.soa import frame_params

    u = tkc.build_uniforms(frame_params(scene, st))
    aspect, plane_h, dist = F(1.0), u[tkc.U_PLANE_H], u[tkc.U_DIST]
    uu = (F(32.5) / F(48.0) - F(0.5)) * (plane_h * aspect)
    vv = (F(15.5) / F(48.0) - F(0.5)) * plane_h
    dc = np.array([uu, vv, -dist], F)
    dc = dc * (F(1.0) / np.sqrt(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]))
    cam = u[:12].reshape(3, 4)
    o = np.array([cam[i, 2] * dist + cam[i, 3] for i in range(3)], F)
    d = np.array([cam[i, 0] * dc[0] + cam[i, 1] * dc[1] + cam[i, 2] * dc[2] for i in range(3)], F)
    d = d * (F(1.0) / np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]))
    table, n_sph, n_box = tanalytic.pack_prims_host(scene)
    hit, t, *_ = _numpy_prims(table, n_sph, n_box, o[None], d[None])
    assert not hit[0]
    m = table[n_sph]
    oo = np.array([m[4 * i] * o[0] + m[4 * i + 1] * o[1] + m[4 * i + 2] * o[2] + m[4 * i + 3]
                   for i in range(3)], F)
    do = np.array([m[4 * i] * d[0] + m[4 * i + 1] * d[1] + m[4 * i + 2] * d[2]
                   for i in range(3)], F)
    t0, t1 = (F(-0.5) - oo) * (F(1.0) / do), (F(0.5) - oo) * (F(1.0) / do)
    t_en, t_ex = np.minimum(t0, t1).max(), np.maximum(t0, t1).min()
    assert 0 < t_en - t_ex < 1e-5 * t_en
