"""The port's plain cluster traversal against the JAX package's exact
brute-force oracle (``intersect.closest_hit_brute``) on seeded random rays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosig_tpu
from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import intersect
from cosig_tpu_torch.accel.clusters import cluster_set_from_arrays
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_megakernel as ttm

N_RAYS = 4096


def _scene(name):
    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        return _tiny_scene()
    return cosig_tpu.load_scene("scenes/demo_cornell.txt")


def _rays(arrays, seed):
    """Origins inside the scene's (slightly grown) bounds, unit directions."""
    v = np.concatenate([np.asarray(arrays.tri_v0), np.asarray(arrays.tri_v1),
                        np.asarray(arrays.tri_v2)])
    lo, hi = v.min(axis=0), v.max(axis=0)
    grow = 0.1 * (hi - lo)
    r = np.random.default_rng(seed)
    o = r.uniform(lo - grow, hi + grow, (N_RAYS, 3)).astype(np.float32)
    d = r.normal(size=(N_RAYS, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.fixture(scope="module", params=["demo_cornell", "tiny"])
def case(request):
    scene = _scene(request.param)
    arrays = jsoa.compile_scene(scene)
    ref = jcl.build_clusters(arrays)
    cset = cluster_set_from_arrays(np.asarray(ref.geom), np.asarray(ref.aabb_t),
                                   np.asarray(ref.sb_aabb_t), np.asarray(ref.mats))
    o, d = _rays(arrays, seed=len(request.param))
    brute = intersect.closest_hit_brute(arrays, jnp.asarray(o), jnp.asarray(d))
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (o, d) for i in range(3)]
    return cset, planes, brute


def _numpy_pairs(g, o, d):
    """Every (ray, row) pair test of geometry rows ``g`` [R, 36] in numpy
    float32, the traversal's operation order -> (valid, t, vb, vc, 1/s),
    each [N, R]. numpy never contracts a multiply-add, so this is the
    arithmetic the port and its kernel are built to reproduce bit for bit."""
    F = np.float32
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    wx, wy, wz = oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx

    def vol(c):
        return (dx * g[:, c] + dy * g[:, c + 1] + dz * g[:, c + 2]
                + wx * g[:, c + 3] + wy * g[:, c + 4] + wz * g[:, c + 5])

    va, vb, vc = vol(7), vol(13), vol(19)
    s = dx * g[:, 3] + dy * g[:, 4] + dz * g[:, 5]
    ndo = ox * g[:, 3] + oy * g[:, 4] + oz * g[:, 5]
    with np.errstate(all="ignore"):
        inv_s = F(1.0) / s
        t = (g[:, 6] - ndo) * inv_s
        valid = ((np.abs(s) >= F(1e-4)) & (va * s >= 0) & (vb * s >= 0) & (vc * s >= 0)
                 & (t > F(1e-4)))
    return valid, t, vb, vc, inv_s


def _numpy_closest(cset, o, d):
    """Exact reference: every (ray, triangle) pair of the cluster geometry,
    lexicographic (t, gid) winner."""
    F = np.float32
    g = cset.geom.numpy().reshape(-1, 36)
    g = g[g[:, 35] != F(2 ** 24)]
    valid, t, vb, vc, inv_s = _numpy_pairs(g, o, d)
    inf = F(tkc.INF)
    tm = np.where(valid, t, inf)
    tmin = tm.min(axis=1)
    key = np.where(tm == tmin[:, None], g[:, 35], np.inf)
    j = key.argmin(axis=1)
    rows = np.arange(len(o))
    hit = tmin < inf
    u = vb[rows, j] * inv_s[rows, j]
    v = vc[rows, j] * inv_s[rows, j]
    w = F(1.0) - u - v
    gw = g[j]
    n = [w * gw[:, 25 + a] + u * gw[:, 28 + a] + v * gw[:, 31 + a] for a in range(3)]
    inv = F(1.0) / np.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    n = np.stack([x * inv for x in n], 1)
    n[~hit] = (0.0, 1.0, 0.0)
    return hit, tmin, n, np.where(hit, gw[:, 34], F(-1.0))


def test_closest_hit_bit_equal_to_exact_reference(case):
    cset, planes, _ = case
    hit, t, nx, ny, nz, mat = tkc.traverse(cset, *planes, torch.ones(N_RAYS, dtype=torch.bool))
    o = torch.stack(planes[:3], 1).numpy()
    d = torch.stack(planes[3:], 1).numpy()
    r_hit, r_t, r_n, r_mat = _numpy_closest(cset, o, d)
    np.testing.assert_array_equal(hit.numpy(), r_hit)
    np.testing.assert_array_equal(t.numpy(), r_t)
    np.testing.assert_array_equal(torch.stack([nx, ny, nz], 1).numpy(), r_n)
    np.testing.assert_array_equal(mat.numpy(), r_mat)


def test_closest_hit_matches_brute_force(case):
    """Hit mask and material equal to the oracle. t agrees to 1 ulp on all
    but a few rays: XLA:CPU contracts the oracle's on-the-fly cross
    products (a*b - c*d) into FMAs, so its triangle constants differ from
    the precomputed ones by ulps, which the (n.A - n.o) cancellation
    amplifies for hits close to the origin; the exact arithmetic is
    checked bit for bit above."""
    cset, planes, brute = case
    active = torch.ones(N_RAYS, dtype=torch.bool)
    hit, t, nx, ny, nz, mat = tkc.traverse(cset, *planes, active)
    h = np.asarray(brute.hit)
    assert 0.1 < h.mean() < 1.0  # the rays exercise both hits and misses
    np.testing.assert_array_equal(hit.numpy(), h)
    np.testing.assert_array_equal(mat.numpy()[h], np.asarray(brute.material)[h].astype(np.float32))
    tp, tb = t.numpy()[h], np.asarray(brute.t)[h]
    ulps = np.abs(tp.view(np.int32) - tb.view(np.int32))
    assert (ulps <= 1).mean() >= 0.9, (ulps <= 1).mean()
    np.testing.assert_allclose(tp, tb, rtol=1e-3, atol=0)
    assert (t.numpy()[~h] == np.float32(tkc.INF)).all()
    n = torch.stack([nx, ny, nz], 1).numpy()
    close = np.abs(n[h] - np.asarray(brute.normal)[h]).max(axis=1) <= 1e-6
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_array_equal(n[~h], np.tile([0.0, 1.0, 0.0], (int((~h).sum()), 1)))


def test_any_hit_equals_closest_t_within_max_t(case):
    cset, planes, _ = case
    active = torch.ones(N_RAYS, dtype=torch.bool)
    _, t, *_ = tkc.traverse(cset, *planes, active)
    r = np.random.default_rng(3)
    finite = torch.where(t < tkc.INF, t, torch.full_like(t, 20.0))
    max_t = finite * torch.from_numpy(r.uniform(0.5, 1.5, N_RAYS).astype(np.float32))
    occ = tkc.traverse(cset, *planes, active, max_t=max_t, any_hit=True)[0]
    np.testing.assert_array_equal(occ.numpy(), (t <= max_t).numpy())
    assert 0 < int(occ.sum()) < N_RAYS


def test_inactive_rays_miss(case):
    cset, planes, _ = case
    active = torch.arange(N_RAYS) % 2 == 0
    hit, t, _, ny, _, mat = tkc.traverse(cset, *planes, active)
    full = tkc.traverse(cset, *planes, torch.ones(N_RAYS, dtype=torch.bool))
    assert not hit[~active].any()
    assert (ny[~active] == 1.0).all() and (mat[~active] == -1.0).all()
    assert torch.equal(t[active], full[1][active])


def _numpy_walk_work(cset, o, d, max_t):
    """(slab, pair) tests of csrc/traverse.cuh's walks, ray by ray in numpy:
    closest hit tests every cluster and every real row of an entered one;
    any hit visits clusters and rows in order, skips boxes entered beyond
    max_t, and stops at the first row with a valid t <= max_t. Also the
    (ray, cluster) pairs each walk enters, [N, C] each."""
    geom = cset.geom.numpy()
    C, K = geom.shape[:2]
    b = cset.aabb_t.numpy()[:6, :C]
    real = geom[:, :, 35] != np.float32(2 ** 24)  # [C, K]
    with np.errstate(all="ignore"):
        inv = np.float32(1.0) / d
        t0 = [(b[a][None, :] - o[:, a:a + 1]) * inv[:, a:a + 1] for a in range(3)]
        t1 = [(b[a + 3][None, :] - o[:, a:a + 1]) * inv[:, a:a + 1] for a in range(3)]
    tn = np.maximum(np.maximum(np.minimum(t0[0], t1[0]), np.minimum(t0[1], t1[1])),
                    np.minimum(t0[2], t1[2]))
    tf = np.minimum(np.minimum(np.maximum(t0[0], t1[0]), np.maximum(t0[1], t1[1])),
                    np.maximum(t0[2], t1[2]))
    passed = ~(tn > tf) & ~(tf < 0.0)  # [N, C]
    valid, t, *_ = _numpy_pairs(geom.reshape(-1, 36), o, d)
    occl = (valid & (t <= max_t[:, None])).reshape(-1, C, K) & real[None]
    closest = (len(o) * C, int((passed * real.sum(axis=1)[None]).sum()))
    entered_any = np.zeros_like(passed)
    slabs = pairs = 0
    for n in range(len(o)):
        for c in range(C):
            slabs += 1
            if not passed[n, c] or tn[n, c] > max_t[n]:
                continue
            entered_any[n, c] = True
            rows = np.nonzero(occl[n, c])[0]
            pairs += int(rows[0]) + 1 if rows.size else int(real[c].sum())
            if rows.size:
                break
    return closest, (slabs, pairs), (passed, entered_any)


def test_work_counts_follow_the_kernels_walk(case):
    """The plain traversal's work counters (the kernels' bounds in
    chip_smoke.py) count what the kernel's walk tests: every cluster and
    entered row for a closest hit, and for an any hit only up to the
    first occluder."""
    cset, planes, _ = case
    n = 512
    planes = [p[:n].contiguous() for p in planes]
    active = torch.ones(n, dtype=torch.bool)
    tkc.reset_work()
    _, t, *_ = tkc.traverse(cset, *planes, active)
    closest = (tkc.WORK["slab_tests"], tkc.WORK["pair_tests"])
    r = np.random.default_rng(5)
    finite = torch.where(t < tkc.INF, t, torch.full_like(t, 20.0))
    max_t = finite * torch.from_numpy(r.uniform(0.5, 1.5, n).astype(np.float32))
    tkc.reset_work()
    occ = tkc.traverse(cset, *planes, active, max_t=max_t, any_hit=True)[0]
    any_hit = (tkc.WORK["slab_tests"], tkc.WORK["pair_tests"])
    assert tkc.WORK["prim_tests"] == 0 and 0 < int(occ.sum()) < n
    o = torch.stack(planes[:3], 1).numpy()
    d = torch.stack(planes[3:], 1).numpy()
    ref_closest, ref_any, _ = _numpy_walk_work(cset, o, d, max_t.numpy())
    assert closest == ref_closest
    assert any_hit == ref_any
    assert any_hit[0] < closest[0] and any_hit[1] < closest[1]


# The kernels' thread slot -> ray id maps at 512 rays: the primary kernel
# (and the parent's megakernel) give thread i of the grid ray i, so a warp
# is 32 consecutive ids; the megakernel's warps cover 8 x 4 pixels of a
# 32 x 16 image.
SLOT_MAPS = {
    "primary": lambda n: tkc.linear_slots(n),
    "megakernel 8x4": lambda n: ttm.tile_slots(32, n // 32),
    "megakernel 32x1": lambda n: tkc.linear_slots(n),
}


@pytest.mark.parametrize("name", list(SLOT_MAPS))
def test_warp_slots_follow_a_per_warp_walk(case, name):
    """The plain traversal's pair-loop slot count (chip_smoke.py's model of
    the kernels' pair-loop efficiency) equals a per-warp walk in numpy: 32 x
    the real rows of each cluster, for every warp in which some ray (for an
    any hit, some ray still walking) enters the cluster. Counts are
    integers and must be equal."""
    cset, planes, _ = case
    n = 512
    planes = [p[:n].contiguous() for p in planes]
    active = torch.ones(n, dtype=torch.bool)
    slots = SLOT_MAPS[name](n)
    warps = tkc.warp_of_rays(slots, n)
    tkc.reset_work()
    _, t, *_ = tkc.traverse(cset, *planes, active, warps=warps)
    closest = tkc.WORK["warp_slots"]
    r = np.random.default_rng(5)
    finite = torch.where(t < tkc.INF, t, torch.full_like(t, 20.0))
    max_t = finite * torch.from_numpy(r.uniform(0.5, 1.5, n).astype(np.float32))
    tkc.reset_work()
    tkc.traverse(cset, *planes, active, max_t=max_t, any_hit=True, warps=warps)
    any_hit = tkc.WORK["warp_slots"]

    o = torch.stack(planes[:3], 1).numpy()
    d = torch.stack(planes[3:], 1).numpy()
    _, _, (passed, entered_any) = _numpy_walk_work(cset, o, d, max_t.numpy())
    real = (cset.geom.numpy()[:, :, 35] != np.float32(2 ** 24)).sum(axis=1)
    s = slots.numpy()
    ref = []
    for entered in (passed, entered_any):
        total = 0
        for w in range(len(s) // 32):
            ids = s[32 * w:32 * (w + 1)]
            ids = ids[ids >= 0]
            if ids.size:
                total += int(32 * (entered[ids].any(axis=0) * real).sum())
        ref.append(total)
    assert (closest, any_hit) == tuple(ref)
    pairs = int((passed * real[None]).sum())
    assert pairs <= closest and any_hit < closest


@pytest.mark.parametrize("width,band", [(61, 37), (61, 21)])
@pytest.mark.parametrize("name", ["primary", "megakernel 8x4", "megakernel 32x1", "debug 16x8"])
def test_slot_maps_are_permutations(name, width, band):
    """Each kernel's thread slot -> ray map holds every ray id once on a
    ragged frame (61 x 37) and on a band of it (21 rows, as rendered with
    rows=21, row_offset=9), with -1 only on threads past the image; the
    primary's rays at AA 3. The warps of the megakernel and of the debug
    kernel (the same tiling) lie inside 8 x 4 pixel boxes, their blocks
    inside 16 x 8."""
    if name == "primary":
        n = width * band * 3
        slots = tkc.linear_slots(n)
    elif name in ("megakernel 8x4", "debug 16x8"):
        n = width * band
        slots = ttm.tile_slots(width, band)
    else:
        n = width * band
        slots = tkc.linear_slots(n)
    s = slots.numpy()
    assert len(s) % 128 == 0
    ids = np.sort(s[s >= 0])
    np.testing.assert_array_equal(ids, np.arange(n))
    warps = tkc.warp_of_rays(slots, n).numpy()
    assert warps.max() < len(s) // 32
    if name in ("megakernel 8x4", "debug 16x8"):
        x, y = s % width, s // width
        for group, (bw, bh) in ((32, (8, 4)), (128, (16, 8))):
            for g in range(len(s) // group):
                sel = s[g * group:(g + 1) * group] >= 0
                if sel.any():
                    gx, gy = x[g * group:(g + 1) * group][sel], y[g * group:(g + 1) * group][sel]
                    assert gx.max() - gx.min() < bw and gy.max() - gy.min() < bh
    else:
        np.testing.assert_array_equal(warps, np.arange(n) // 32)
    bad = s.copy()
    bad[0] = bad[1]
    with pytest.raises(ValueError, match="permutation"):
        tkc.warp_of_rays(torch.from_numpy(bad), n)


@pytest.mark.parametrize("ways", [2, 4])
def test_split_clusters_render_bit_equal(ways):
    """large_mesh's 221 clusters of 64 rows cut 2 ways (442 clusters, c_pad
    512) and 4 ways (884 clusters of 16 rows, c_pad 1024, past one
    superblock of 512): every part lies under its whole cluster's box and
    keeps its rows' flat indices and gids, so the plain wavefront's state,
    image and ray count equal the unsplit render's bit for bit."""
    import chip_smoke
    from cosig_tpu_torch.ops import trace_wavefront as ttw

    s = chip_smoke.scene_setup("large_mesh", dict(resolution_override=(40, 30), max_depth=4),
                               "cpu")
    cset = s["cset"]
    split = chip_smoke.split_clusters(cset, ways)
    assert split.num_clusters == ways * cset.num_clusters and split.k == cset.k // ways
    assert split.aabb_t.shape[1] == {2: 512, 4: 1024}[ways]
    args = (s["uni"], s["lights"], s["cfg"])
    whole = ttw.trace_state(cset, *args)
    parts = ttw.trace_state(split, *args)
    assert torch.equal(whole, parts)
    img_w, rays_w = ttw.finalize(whole, s["cfg"], s["cfg"].height)
    img_p, rays_p = ttw.finalize(parts, s["cfg"], s["cfg"].height)
    assert torch.equal(img_w, img_p) and rays_w == rays_p > 0


# The compacted any hit (csrc/traverse_tile.cuh any_pairs, the exact shade
# kernel's walk): cluster cuts of the bench scenes, each piece TRACE_SLOT rows.
ANY_CUTS = {"large_mesh k64": ("large_mesh", None), "large_mesh k128": ("large_mesh", 128),
            "glass_sphere k32": ("glass_sphere", None)}
ANY_RAYS = 384  # three blocks of 128


def _any_cut(name):
    import chip_smoke

    scene, k = ANY_CUTS[name]
    s = chip_smoke.scene_setup(scene, dict(resolution_override=(8, 8)), "cpu")
    return s["cset"] if k is None else chip_smoke.form_sets(s, dict(k=k), "cpu")["k"]


def _any_rays(cset, seed, scale):
    """Seeded rays from inside the scene's (grown) bounds, unit directions,
    max_t a random share of ``scale`` x the bounds' diagonal, every seventh
    ray inactive -> numpy (o [N, 3], d [N, 3], max_t [N], active [N])."""
    F = np.float32
    box = cset.aabb_t[:6, :cset.num_clusters].numpy()
    lo, hi = box[:3].min(axis=1), box[3:].max(axis=1)
    grow = 0.1 * (hi - lo)
    r = np.random.default_rng(seed)
    o = r.uniform(lo - grow, hi + grow, (ANY_RAYS, 3)).astype(F)
    d = r.normal(size=(ANY_RAYS, 3)).astype(F)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(F)
    diag = float(np.linalg.norm(hi - lo))
    max_t = (r.uniform(0.05, 1.0, ANY_RAYS) * scale * diag).astype(F)
    active = np.ones(ANY_RAYS, bool)
    active[::7] = False
    return o, d, max_t, active


def _numpy_any_pairs(cset, o, d, max_t, active, seed):
    """The compacted any hit in numpy: per block of 128 rays, the clusters in
    order, each in pieces of TRACE_SLOT rows; per piece the rays still
    walking whose box test passes (slab, and not entered beyond max_t) and
    the piece's real rows give the (ray, row) pairs, tested in a seeded
    random order, a pair of an occluded ray skipped, an occluding pair
    (valid, t <= max_t) stopping its ray at the end of the piece ->
    (occluded [N], the schedule's slots: 128 x ceil(n r / 128) per block
    and piece, the per-warp walk's slots: 32 x the most rows a lane still
    walking tests per warp and cluster)."""
    F = np.float32
    geom = cset.geom.numpy()
    C, K = geom.shape[:2]
    b = cset.aabb_t.numpy()[:6, :C]
    real = (geom[:, :, 35] != F(2 ** 24)).sum(axis=1)
    with np.errstate(all="ignore"):
        inv = F(1.0) / d
        t0 = [(b[a][None, :] - o[:, a:a + 1]) * inv[:, a:a + 1] for a in range(3)]
        t1 = [(b[a + 3][None, :] - o[:, a:a + 1]) * inv[:, a:a + 1] for a in range(3)]
    tn = np.maximum(np.maximum(np.minimum(t0[0], t1[0]), np.minimum(t0[1], t1[1])),
                    np.minimum(t0[2], t1[2]))
    tf = np.minimum(np.minimum(np.maximum(t0[0], t1[0]), np.maximum(t0[1], t1[1])),
                    np.maximum(t0[2], t1[2]))
    enters = ~(tn > tf) & ~(tf < 0.0) & ~(tn > max_t[:, None])  # [N, C]
    valid, t, *_ = _numpy_pairs(geom.reshape(-1, 36), o, d)
    occl = (valid & (t <= max_t[:, None])).reshape(-1, C, K)
    rng = np.random.default_rng(seed)
    flag = ~active  # occluded, or not walking
    slots = warp_slots = 0
    for b0 in range(0, len(o), tkc.BLOCK_RAYS):
        blk = np.arange(b0, min(b0 + tkc.BLOCK_RAYS, len(o)))
        for c in range(C):
            for w0 in range(b0, blk[-1] + 1, 32):  # the per-warp walk of this cluster
                lanes = [i for i in range(w0, min(w0 + 32, len(o))) if not flag[i] and enters[i, c]]
                if lanes:
                    occ_rows = [np.nonzero(occl[i, c, :real[c]])[0] for i in lanes]
                    warp_slots += 32 * max(int(x[0]) + 1 if x.size else int(real[c])
                                           for x in occ_rows)
            for first in range(0, K, tkc.TRACE_SLOT):
                rows = min(tkc.TRACE_SLOT, max(0, int(real[c]) - first))
                walking = blk[~flag[blk] & enters[blk, c]]
                if rows == 0 or walking.size == 0:
                    continue
                slots += tkc.BLOCK_RAYS * -(-walking.size * rows // tkc.BLOCK_RAYS)
                pairs = [(i, first + j) for i in walking for j in range(rows)]
                hit = set()
                for p in rng.permutation(len(pairs)):
                    i, row = pairs[p]
                    if i not in hit and occl[i, c, row]:
                        hit.add(i)
                flag[list(hit)] = True  # the ray stops after this piece
    return active & flag, slots, warp_slots


def _plain_any(cset, o, d, max_t, active):
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, i])) for a in (o, d) for i in range(3)]
    tkc.reset_work()
    occ = tkc.traverse(cset, *planes, torch.from_numpy(active), max_t=torch.from_numpy(max_t),
                       any_hit=True, warps=torch.arange(len(o)) // 32)[0]
    return occ.numpy(), dict(tkc.WORK)


@pytest.mark.parametrize("scale", [0.15, 2.0])
@pytest.mark.parametrize("cut", list(ANY_CUTS))
def test_compacted_any_hit_gives_the_plain_occlusion(cut, scale):
    """The compacted any hit's schedule (pairs in a random order, rays
    stopped between pieces, a pair of a stopped ray skipped) gives the plain
    traversal's occlusion exactly: a ray is occluded iff some row of a box
    it enters occludes it, whatever the order and however far it walks past
    its first occluder. Short and long max_t, some rays inactive."""
    cset = _any_cut(cut)
    o, d, max_t, active = _any_rays(cset, seed=len(cut) + int(10 * scale), scale=scale)
    occ, _ = _plain_any(cset, o, d, max_t, active)
    model, _, _ = _numpy_any_pairs(cset, o, d, max_t, active, seed=3)
    assert 0 < int(occ.sum()) < int(active.sum())
    assert np.array_equal(occ, model)
    assert not occ[~active].any()


@pytest.mark.parametrize("cut", ["large_mesh k64", "large_mesh k128"])
def test_any_slots_follow_the_compacted_schedule(cut):
    """kernel_core.WORK["any_pair_slots"] (phase 3's model of the shade's
    compacted any hit) and WORK["any_warp_slots"] (its per-warp walk, a warp
    leaving a cluster once none of its lanes still walks) equal the numpy
    schedule's counts on the same rays; both cover the pair tests the walk
    needs, and the per-warp count stays within the flat one
    (WORK["warp_slots"])."""
    cset = _any_cut(cut)
    o, d, max_t, active = _any_rays(cset, seed=11, scale=1.0)
    _, work = _plain_any(cset, o, d, max_t, active)
    _, slots, warp_slots = _numpy_any_pairs(cset, o, d, max_t, active, seed=4)
    assert work["any_pair_slots"] == slots > 0
    assert work["any_warp_slots"] == warp_slots > 0
    assert work["pair_tests"] <= min(slots, warp_slots)
    assert warp_slots <= work["warp_slots"]
