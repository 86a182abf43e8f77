"""The near-first, distance-pruned closest hit of the compacted walk
(``csrc/traverse_tile.cuh`` closest_pairs and near_first,
``csrc/traverse.cuh`` prunes; the plain ``kernel_core.traverse(...,
warps=)``, ``near_first`` and ``prune_flags``): each block walks its entered
clusters near-first and a ray skips a piece of rows whose box it enters
past its key's t by more than the margin. Pruning is exact, so every output
keeps the unpruned walk's bits while the pairs run fall. CPU tests run the
plain versions; the ``gpu``-marked ones hold the trace kernel's pair
counters to the plain count and the Renderer's frames to the plain stages
on the card: ``python -m pytest tests/test_torch_prune.py -m gpu
--noconftest``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.accel.clusters import build_clusters
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.scene.tessellate import TriangleSoA
from cosig_tpu_torch.utils import trace

F32 = np.float32
# large_mesh 48² d4 AA 1 and glass_sphere 48² d6 AA 4 on the CPU, and the
# least share of its pair tests that the pruned walk skips at large_mesh.
SCENES = {"large_mesh": dict(resolution_override=(48, 48), max_depth=4, aa_samples=1),
          "glass_sphere": dict(resolution_override=(48, 48), max_depth=6, aa_samples=4)}


@pytest.fixture(scope="module")
def scenes():
    return {name: chip_smoke.scene_setup(name, kw, "cpu") for name, kw in SCENES.items()}


def _walks(s) -> list:
    """The fission frame's closest hits on the CPU, each walked unpruned
    and pruned -> [(stage, unpruned state, pruned state, WORK unpruned,
    WORK pruned)]: the primary stage in the primary kernel's warps, then
    each depth's trace on the list in its kernel's warps."""
    cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
    mats, pk = cset.mats_host, tkc.prim_table(None, (0, 0), "cpu")
    n = cfg.width * cfg.height * max(1, cfg.aa_samples)
    out = []
    tkc.reset_work()
    plain = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, fission=True)
    w_plain = dict(tkc.WORK)
    tkc.reset_work()
    pruned = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, fission=True,
                               warps=tkc.warp_of_rays(tkc.linear_slots(n), n))
    out.append(("primary", plain.clone(), pruned, w_plain, dict(tkc.WORK)))
    st = plain
    ttw.primary_shade(st, cset, uni, mats, lights, cfg, *pk)
    for d in range(1, cfg.max_depth):
        idx, n_live = ttw.compact_plain(st)
        a, b = st.clone(), st.clone()
        tkc.reset_work()
        ttw.trace_listed_stage(a, idx, n_live, cset, *pk)
        w_plain = dict(tkc.WORK)
        tkc.reset_work()
        ttw.trace_listed_stage(b, idx, n_live, cset, *pk, counts=torch.zeros(3, dtype=torch.int64))
        out.append((f"trace {d}", a.clone(), b, w_plain, dict(tkc.WORK)))
        st = a
        ttw.shade_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, d, *pk)
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_pruned_walk_keeps_the_unpruned_bits(scenes, name):
    """The plain pruned walk (near-first, distance-pruned, in the kernels'
    warps) gives the unpruned walk's state bit for bit at every stage; the
    pairs it runs and prunes add up to the unpruned walk's pair tests, and
    at large_mesh it skips more than a fifth of them."""
    run = pruned = 0
    for stage, plain, got, w_plain, w in _walks(scenes[name]):
        assert torch.equal(plain, got), stage
        assert w["pair_tests"] + w["pairs_pruned"] == w_plain["pair_tests"], stage
        assert w["pair_tests"] <= w["pair_slots"], stage
        run, pruned = run + w["pair_tests"], pruned + w["pairs_pruned"]
    assert run > 0
    if name == "large_mesh":
        assert pruned > 0.2 * (run + pruned), (run, pruned)


# ---- adversarial rays ----

def _quad(x0, x1, y0, y1, z):
    """Two triangles of the rectangle [x0, x1] x [y0, y1] at height z, normal +z."""
    a, b, c, d = (x0, y0, z), (x1, y0, z), (x1, y1, z), (x0, y1, z)
    return [(a, b, c), (a, c, d)]


def _cset(tris, mats, k=8):
    """A cluster set of triangles [(v0, v1, v2)] in soup order, of materials
    ``mats`` [T]."""
    v = np.asarray(tris, F32)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(F32)
    soa = TriangleSoA(v[:, 0], v[:, 1], v[:, 2], n, n, n, np.asarray(mats, np.int32))
    return build_clusters(soa, np.zeros((2, 8), F32), k=k)


def _stack():
    """Eight layers of four unit quads each (z = 0 .. 7 over [0, 2]², one
    layer a cluster at k = 8); at z = 9 four unit quads (material 0) and,
    in part another cluster's, a 4 x 4 quad over [-1, 3]² (material 1)
    whose normal is 16 times theirs, so that a ray down onto [0, 2]² meets
    both at the same t bit for bit (the factor is a power of 2); and a
    ground quad at z = -1 whose normal is 4,096 times a unit quad's."""
    tris = []
    for z in list(range(8)) + [9]:
        for x in (0.0, 1.0):
            for y in (0.0, 1.0):
                tris += _quad(x, x + 1, y, y + 1, float(z))
    tris += _quad(-1.0, 3.0, -1.0, 3.0, 9.0)
    mats = [0] * (len(tris) - 2) + [1, 1]
    tris += _quad(-32.0, 32.0, -32.0, 32.0, -1.0)
    return _cset(tris, mats + [0, 0])


def _rays(gen, n_random=4000):
    """Rays that stress the pruning -> (ox, oy, oz, dx, dy, dz, active): down
    the stack from above (every layer's box entered, all but the first
    pruned), grazing pairs (d.n near EPSILON on the layers and the ground),
    origins inside a layer's box, zero direction components with the
    origin on a box face (NaN slabs), down onto the tied quads, and random
    rays about the stack."""
    o, d = [], []

    def add(oi, di):
        o.append(np.asarray(oi, F32))
        d.append(np.asarray(di, F32))

    for _ in range(600):  # straight down, from above and from between layers
        x, y = gen.uniform(0.01, 1.99, 2)
        add((x, y, gen.uniform(-0.5, 12.0)), (gen.normal() * 0.05, gen.normal() * 0.05, -1.0))
    for s in (1e-4, 1.01e-4, 2e-4, 1e-3, 5e-6, 2.5e-5):  # grazing: |s| about EPSILON
        for _ in range(60):
            x, y = gen.uniform(-0.5, 2.5, 2)
            z = gen.uniform(-0.9, 8.0)
            ang = gen.uniform(0, 2 * np.pi)
            # a layer's |n| is 1 (unit squares): s = d.n = dz; the ground's 4,096.
            add((x, y, z), (np.cos(ang), np.sin(ang), -s * gen.choice([1.0, 1 / 4096])))
    for _ in range(200):  # origins inside a layer's box (tn <= 0)
        x, y = gen.uniform(0.0, 2.0, 2)
        add((x, y, float(gen.integers(0, 8)) + gen.uniform(-1e-4, 1e-4)), gen.normal(size=3))
    for face in (0.0, 1.0, 2.0):  # zero components on a box face: 0 * inf = NaN slabs
        for _ in range(60):
            oi = np.array([face, gen.uniform(0, 2), gen.uniform(0, 8)])
            di = gen.normal(size=3)
            di[0] = gen.choice([0.0, -0.0])
            add(oi, di)
            oi = np.array([gen.uniform(0, 2), gen.uniform(0, 2), float(gen.integers(0, 8))])
            di = gen.normal(size=3)
            di[2] = 0.0
            add(oi, di)
    for _ in range(200):  # onto the tied quads at z = 9
        x, y = gen.uniform(0.01, 1.99, 2)
        add((x, y, gen.uniform(9.5, 12.0)), (gen.normal() * 0.1, gen.normal() * 0.1, -1.0))
    for _ in range(n_random):
        add(gen.uniform(-3, 5, 3) + (0, 0, 3), gen.normal(size=3))
    o, d = np.stack(o), np.stack(d)
    nrm = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(nrm > 0, d / np.where(nrm > 0, nrm, 1), d).astype(F32)
    active = np.ones(len(o), bool)
    active[::11] = False
    return tuple(torch.from_numpy(np.ascontiguousarray(x[:, a])) for x in (o, d)
                 for a in range(3)) + (torch.from_numpy(active),)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) or bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
               for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adversarial_rays_keep_the_winner_and_its_bits(seed):
    """Grazing pairs with |s| near EPSILON, origins inside a box, NaN slabs
    (an infinite 1/d with the origin on a face) and two triangles tied at t
    with different gids in different clusters: the pruned walk's winner (t,
    normal, material) and its bits are the unpruned walk's, in the
    kernels' warps of 32 rays and blocks of 128; the walk prunes, and a
    tied ray keeps the lower gid's triangle (the first copy's)."""
    gen = np.random.default_rng(23 + seed)
    cset = _stack()
    rays = _rays(gen)
    n = rays[0].shape[0]
    tkc.reset_work()
    want = tkc.traverse(cset, *rays)
    tkc.reset_work()
    got = tkc.traverse(cset, *rays, warps=torch.arange(n) // 32)
    assert _equal(want, got)
    assert tkc.WORK["pairs_pruned"] > 0 and tkc.WORK["pair_tests"] > 0
    # The tie: down onto z = 9 meets a unit quad and the 4 x 4 quad at the
    # same t; the unit quads' lower gids win (material 0), also where the
    # two lie in different clusters: the 4 x 4 quad's two triangles (gids
    # 72 and 73) lie in two clusters, each with unit quads of z = 9 (64-71).
    gids = cset.geom[:, :, 35]
    homes = [int(torch.nonzero((gids == g).any(dim=1))[0]) for g in (72, 73)]
    assert homes[0] != homes[1]
    assert all(bool(((gids[h] >= 64) & (gids[h] < 72)).any()) for h in homes)
    hit, t, mat = got[0], got[1], got[5]
    px, py = rays[0] + t * rays[3], rays[1] + t * rays[4]
    down = (rays[5] < -0.99) & (rays[2] > 9.5) & rays[6] & hit
    inside = down & (px > 0.01) & (px < 1.99) & (py > 0.01) & (py < 1.99)
    assert int(inside.sum()) > 50 and bool((mat[inside] == 0.0).all())
    assert bool((mat[down & ~inside] == 1.0).any())  # past [0, 2]², the 4 x 4 quad alone


def test_grazing_ground_pieces_are_never_pruned():
    """The margin scales with a piece's largest |n|_1: a ray whose key lies
    on a layer and whose entry into the ground quad's box is farther keeps
    the ground's piece when the ground's normal is large, and a layer's
    piece farther down is pruned."""
    cset = _stack()
    n1 = tkc.piece_normals(cset.geom)
    big = float(n1.max())
    small = float(n1[n1 > 0].min())
    assert big >= 4096 * small
    t_key = torch.tensor([1.0, 1.0])
    tn = torch.tensor([1.5, 1.5])
    box = torch.tensor([[0.0, 0.0], [0.0, 0.0], [0.0, 0.0], [2.0, 2.0], [2.0, 2.0], [2.0, 2.0]])
    zero = torch.zeros(2)
    flags = tkc.prune_flags(tn, t_key, zero, zero, zero, box, torch.tensor([small, big]))
    assert flags.tolist() == [True, False]
    # No key, a NaN entry and an origin inside the box never prune.
    inf = float(np.finfo(F32).max)
    flags = tkc.prune_flags(torch.tensor([5.0, float("nan"), -0.5]),
                            torch.tensor([inf, 1.0, 1.0]), torch.zeros(3), torch.zeros(3),
                            torch.zeros(3), box[:, :1].expand(6, 3), torch.full((3,), small))
    assert flags.tolist() == [False, False, False]


def test_block_order_is_a_permutation_of_the_ascending_list():
    """near_first ranks each block's entered clusters 0 .. m - 1 once each,
    by the least max(tn, 0) over its entries (NaN as 0), ties by cluster
    index: a permutation of the block's ascending list."""
    gen = torch.Generator().manual_seed(5)
    blocks, clusters = 6, 40
    e_b, e_c = torch.meshgrid(torch.arange(blocks), torch.arange(clusters), indexing="ij")
    keep = torch.rand(blocks, clusters, generator=gen) < 0.4
    e_b, e_c = e_b[keep].repeat(3), e_c[keep].repeat(3)  # three rays an entered box
    tn = torch.randn(e_b.numel(), generator=gen) * 4
    tn[::17] = float("nan")
    tn[::13] = torch.round(tn[::13])  # ties
    pos = tkc.near_first(e_b, e_c, tn, blocks, clusters)
    key = torch.where(tn > 0, tn, 0.0)
    for b in range(blocks):
        cs = sorted(set(e_c[e_b == b].tolist()))
        ranks = {c: int(pos[(e_b == b) & (e_c == c)][0]) for c in cs}
        assert sorted(ranks.values()) == list(range(len(cs)))  # a permutation
        assert all(bool((pos[(e_b == b) & (e_c == c)] == ranks[c]).all()) for c in cs)
        least = {c: float(key[(e_b == b) & (e_c == c)].min()) for c in cs}
        assert [c for c, _ in sorted(ranks.items(), key=lambda x: x[1])] == \
            sorted(cs, key=lambda c: (least[c], c))


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_trace_pair_counters_equal_the_plain_count_on_card(card):
    """large_mesh at 256², depth 4 on the card: each depth's trace kernel
    adds to its counters the pairs it runs and prunes, as the plain trace
    counts them in the kernel's warps, gives the plain trace's state, and
    prunes some."""
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw

    s = chip_smoke.scene_setup("large_mesh", dict(resolution_override=(256, 256)), card)
    cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
    fb = binding.frame_buffer(card, uni, cset.mats_host, lights)
    pk = tkc.prim_table(None, (0, 0), card)
    st = kw.primary(cset, fb, cfg, cfg.height, *pk, fission=True)
    kw.shade(st, None, None, cset, fb, cfg, 0, *pk)
    pruned = 0
    for d in range(1, cfg.max_depth):
        idx, n_live = kw.compact(st)
        got = torch.zeros(3, dtype=torch.int64, device=card)
        want = torch.zeros(3, dtype=torch.int64, device=card)
        plain = st.clone()
        kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk, counts=got)
        ttw.trace_listed_stage(plain, idx, n_live, cset, *pk, counts=want)
        assert torch.equal(st, plain), d
        assert got.tolist() == want.tolist() and int(got[1]) > 0, (d, got.tolist())
        pruned += int(got[2])
        kw.shade(st, idx, n_live, cset, fb, cfg, d, *pk)
    assert pruned > 0


def _plain_frame(cset, scene, st):
    """The plain stages' fission frame, in row bands of at most 2^23 camera
    rays (two at 2048², AA 4) -> (image, rays)."""
    params, cfg = tsoa.frame_params(scene, st), tsoa.static_config(scene, st)
    uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, cfg.multi_light)
    rows = min(cfg.height, 2 ** 23 // (cfg.width * max(1, cfg.aa_samples)))
    imgs, rays = [], 0
    for off in range(0, cfg.height, rows):
        img, r = ttw.render_wavefront(cset, uni, lights, cfg, rows=min(rows, cfg.height - off),
                                      row_offset=off, plain=True, fission=True)
        imgs.append(img)
        rays += r
    return torch.cat(imgs), rays


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", [
    ("large_mesh", dict(resolution_override=(2048, 2048), max_depth=4)),
    ("large_mesh", dict(resolution_override=(2048, 2048), max_depth=4, aa_samples=4)),
    ("glass_sphere", dict(resolution_override=(1024, 1024), max_depth=6, aa_samples=4)),
])
def test_renderer_frames_equal_the_plain_stages_on_card(card, name, kw):
    """The Renderer's frame (the fission graph: its fission primary and
    traces pruned) equals the plain stages' unpruned frame on the card bit
    for bit, image and rays (at AA 4 both in two bands); a traced replay
    records the traces' pairs run and pruned by depth."""
    r = cosig_tpu_torch.Renderer(device=card)
    scene, st = chip_smoke.load(name)
    st = st.replace(**kw)
    r.render_to_device(scene, st)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        img = r.render_to_device(scene, st)
    rec = trace.frames()[-1]
    assert list(rec.pair_tests) == list(rec.live_rays) == list(range(1, st.max_depth))
    assert all(run > 0 for run, _ in rec.pair_tests.values())
    cset = r._geometry_for(scene)[0]
    ref, rays = _plain_frame(cset, scene, st)
    assert torch.equal(img, ref) and r.last_stats.rays_traced == rays
