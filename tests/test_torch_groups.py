"""The two-level cull of incoherent rays (``csrc/traverse.cuh`` group_pass,
``csrc/traverse_tile.cuh`` cull; the plain ``kernel_core.group_flags`` and
``traverse(..., warps=)``): the union box of each CULL_GROUP consecutive
clusters is tested first and its members' slab tests run only for the
warps in which some ray enters it. The group test must pass every ray that
passes some member's slab test, NaN slabs included, so the walks' outputs
keep their bits while the counted box tests fall; the trace kernels count
the box tests they run into ``FrameRecord.box_tests``. CPU tests run the
plain versions; the ``gpu``-marked ones hold the kernels' counter to the
plain count and the Renderer's frames to the plain stages on the card:
``python -m pytest tests/test_torch_groups.py -m gpu --noconftest``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import frame_graph
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.utils import trace

INF, NAN = float("inf"), float("nan")


def _members_pass(boxes, rays, max_t):
    """Whether each ray passes the slab test (and tn <= max_t) of some box
    of ``boxes`` [6, W]: the flat cull's verdict on the group."""
    ox, oy, oz, dx, dy, dz = rays
    inv = [torch.reciprocal(d) for d in (dx, dy, dz)]
    out = torch.zeros_like(ox, dtype=torch.bool)
    for c in range(boxes.shape[1]):
        tn, tf = tkc.slab(boxes[:, c], ox, oy, oz, *inv)
        ok = ~(tn > tf) & ~(tf < 0.0)
        if max_t is not None:
            ok = ok & ~(tn > max_t)
        out |= ok
    return out


def _group_pass(boxes, rays, max_t):
    ox, oy, oz, dx, dy, dz = rays
    inv = [torch.reciprocal(d) for d in (dx, dy, dz)]
    return tkc.group_flags(tkc.union_box(boxes), *rays, *inv, max_t)


def _adversarial(boxes, gen):
    """Rays that stress the group test on ``boxes`` [6, W]: origins on a
    member's face planes with a zero (+0 or -0) direction component there
    (the member's slab is 0 * inf = NaN), rays through the union's and the
    members' corners, axis-parallel rays, rays with NaN or infinite
    direction components, tiny directions whose 1/d overflows, and random
    rays about the group -> (ox, oy, oz, dx, dy, dz), each [N]."""
    lo, hi = boxes[:3].amin(dim=1), boxes[3:].amax(dim=1)
    mid, span = (lo + hi) / 2, (hi - lo).clamp_min(1e-3)
    o, d = [], []
    w = boxes.shape[1]
    for c in range(w):
        for a in range(3):
            for face in (boxes[a, c], boxes[a + 3, c]):
                for zero in (0.0, -0.0):
                    for _ in range(6):
                        oi = mid + span * (torch.rand(3, generator=gen) * 3 - 1.5)
                        oi[a] = face
                        di = torch.randn(3, generator=gen)
                        di[a] = zero
                        o.append(oi)
                        d.append(di)
    corners = [torch.stack([boxes[i, c] if b & (1 << i) == 0 else boxes[i + 3, c]
                            for i in range(3)]) for c in range(w) for b in range(8)]
    corners += [torch.stack([lo[i] if b & (1 << i) == 0 else hi[i] for i in range(3)])
                for b in range(8)]
    for p in corners:
        for _ in range(4):
            oi = mid + span * torch.randn(3, generator=gen) * 2
            o.append(oi)
            d.append(p - oi)
            o.append(p.clone())
            d.append(torch.randn(3, generator=gen))
    for a in range(3):
        for sign in (1.0, -1.0):
            for _ in range(40):
                oi = mid + span * (torch.rand(3, generator=gen) * 3 - 1.5)
                di = torch.zeros(3)
                di[a] = sign
                o.append(oi)
                d.append(di)
    for bad in (NAN, INF, -INF, 1e-40, -1e-40):
        for a in range(3):
            for _ in range(8):
                oi = mid + span * (torch.rand(3, generator=gen) * 3 - 1.5)
                di = torch.randn(3, generator=gen)
                di[a] = bad
                o.append(oi)
                d.append(di)
    n = 4000
    o.extend(mid + span * (torch.rand(n, 3, generator=gen) * 4 - 2))
    d.extend(torch.randn(n, 3, generator=gen))
    o, d = torch.stack(o), torch.stack(d)
    return tuple(o[:, a].contiguous() for a in range(3)) + tuple(d[:, a].contiguous()
                                                                  for a in range(3))


@pytest.mark.parametrize("layout", ["spread", "touching", "nan_bound", "one"])
@pytest.mark.parametrize("clip", [False, True])
def test_group_test_passes_every_ray_a_member_passes(layout, clip):
    """Union box against its members' slab tests on adversarial rays: no
    ray that passes some member is rejected (with ``clip`` the any hit's
    tn <= max_t too), and the test still rejects most rays that pass none."""
    gen = torch.Generator().manual_seed(21)
    lo = torch.rand(3, 8, generator=gen) * 4 - 2
    boxes = torch.cat([lo, lo + torch.rand(3, 8, generator=gen) + 0.05])
    if layout == "touching":  # shared face planes, one flat box
        boxes[3, :4] = boxes[0, 4:]
        boxes[1, 1] = boxes[4, 1]
    elif layout == "nan_bound":
        boxes[2, 3] = NAN
    elif layout == "one":
        boxes = boxes[:, :1]
    rays = _adversarial(boxes, gen)
    max_t = torch.rand(rays[0].shape[0], generator=gen) * 6 if clip else None
    want = _members_pass(boxes, rays, max_t)
    got = _group_pass(boxes, rays, max_t)
    assert not (want & ~got).any(), int((want & ~got).sum())
    if layout != "nan_bound":
        assert int((~got).sum()) > 0.5 * int((~want).sum())


def test_nan_slab_at_a_face_needs_the_origin_rule():
    """A ray whose origin lies on a member's face plane with a zero
    direction component there passes that member (its slab is NaN), while
    the plain slab test of the union, which holds the origin strictly
    inside on that axis, rejects it on another axis: the group test passes
    it by the rule for an infinite 1/d."""
    boxes = torch.tensor([[0.0, 2.0], [0.0, 0.0], [0.0, 0.0],
                          [1.0, 3.0], [1.0, 1.0], [1.0, 1.0]])
    # x = 1 (box 0's max face, inside the union's [0, 3]) at y = 2, moving
    # in +y, away from both boxes; dx = 0.
    rays = tuple(torch.tensor([v]) for v in (1.0, 2.0, 0.5, 0.0, 1.0, 0.0))
    assert bool(_members_pass(boxes, rays, None))
    inv = [torch.reciprocal(d) for d in rays[3:]]
    tn, tf = tkc.slab(tkc.union_box(boxes), *rays[:3], *inv)
    assert not bool(~(tn > tf) & ~(tf < 0.0))  # the union's own slab test rejects it
    assert bool(_group_pass(boxes, rays, None))


@pytest.fixture(scope="module")
def scenes():
    """large_mesh and glass_sphere at 48², depth 3, AA 1, on the CPU
    (chip_smoke.scene_setup)."""
    return {name: chip_smoke.scene_setup(name, dict(resolution_override=(48, 48), max_depth=3,
                                                    aa_samples=1), "cpu")
            for name in ("large_mesh", "glass_sphere")}


def _fission_depth_states(s):
    """The fission frame's state before each trace of the frame ``s`` on
    the CPU -> [(depth, state, idx, n_live)]."""
    cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
    mats, pk = cset.mats_host, tkc.prim_table(None, (0, 0), "cpu")
    st = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, fission=True)
    ttw.primary_shade(st, cset, uni, mats, lights, cfg, *pk)
    out = []
    for d in range(1, cfg.max_depth):
        idx, n_live = ttw.compact_plain(st)
        out.append((d, st.clone(), idx, n_live))
        ttw.trace_listed_stage(st, idx, n_live, cset, *pk)
        ttw.shade_listed_stage(st, idx, n_live, cset, uni, mats, lights, cfg, d, *pk)
    return out


# The most box tests a listed ray may average at depth 1, and the cluster
# count that the flat cull tests.
SCENES = {"large_mesh": (100, 221), "glass_sphere": (60, 82)}


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_trace_in_warps_keeps_its_bits_and_runs_fewer_box_tests(scenes, name):
    """The plain trace in the kernel's warps (the list's order) gives the
    flat walk's state bit for bit at every depth, and counts the box tests
    the kernels run: at depth 1 (most rays leave the scene) well under the
    flat cull's cluster count a listed ray (under 100 of large_mesh's 221,
    60 of glass's 82); the counters' box tests are the WORK count's group
    plus member tests."""
    most, clusters = SCENES[name]
    s = scenes[name]
    states = _fission_depth_states(s)
    cset, pk = s["cset"], tkc.prim_table(None, (0, 0), "cpu")
    assert cset.num_clusters == clusters
    for depth, st, idx, n_live in states:
        flat, grouped = st.clone(), st.clone()
        tkc.reset_work()
        ttw.trace_listed_stage(flat, idx, n_live, cset, *pk)
        assert tkc.WORK["slab_tests"] == int(n_live) * clusters
        assert tkc.WORK["group_tests"] == 0
        tkc.reset_work()
        tests = torch.zeros(3, dtype=torch.int64)
        ttw.trace_listed_stage(grouped, idx, n_live, cset, *pk, counts=tests)
        assert torch.equal(flat, grouped), depth
        work = dict(tkc.WORK)
        groups = -(-clusters // tkc.CULL_GROUP)
        assert work["group_tests"] == int(n_live) * groups
        assert int(tests[0]) == work["group_tests"] + work["slab_tests"]
        if depth == 1:
            assert int(tests[0]) < most * int(n_live), (int(tests[0]), int(n_live))


def test_list_warps_follow_the_list():
    idx = torch.tensor([5, 0, 3, 1, 2, 4], dtype=torch.int32)
    warps = ttw.list_warps(idx, torch.tensor([4], dtype=torch.int32), 6)
    assert warps.tolist() == [0, 0, -1, 0, -1, 0]
    big = torch.arange(70, dtype=torch.int32).flip(0)
    warps = ttw.list_warps(big, torch.tensor([70], dtype=torch.int32), 70)
    assert warps[big[:32].long()].eq(0).all() and warps[big[64:].long()].eq(2).all()


def test_traced_frame_records_the_traces_box_tests(scenes):
    """A traced fission frame on the CPU records, per depth, the box tests
    its plain traces count in the kernels' warps: more than the group tests
    and at most the flat cull's count per listed ray plus them."""
    s = scenes["glass_sphere"]
    args = (s["cset"], s["uni"], s["lights"], s["cfg"], 1)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.frame():
            frame_graph.render_chain("wavefront", *args, fission=True)
    rec = trace.frames()[-1]
    assert list(rec.box_tests) == list(rec.live_rays) == [1, 2]
    for d, tests in rec.box_tests.items():
        live = rec.live_rays[d]
        assert live * 11 < tests <= live * (82 + 11), (d, tests, live)


def test_replay_keys_box_tests_by_the_traces_depths(monkeypatch):
    """A replayed frame reads its traces' counters (one buffer, band after
    band: box tests, pairs run, pairs pruned each) by the depths of the
    plan's trace labels, summed over bands."""
    monkeypatch.setattr(trace, "_frames", trace.collections.deque(maxlen=trace.FRAMES_KEPT))
    cap = trace.Capture(1, "wavefront", ("primary", "shade_all", "compact.1", "trace.1",
                                         "shade.1", "compact.2", "trace.2", "shade.2") * 2,
                        {}, {}, plan_bands=(0,) * 8 + (1,) * 8,
                        count_plan=("trace.1", "trace.2") * 2)
    lives = torch.tensor([50, 7, 40, 3], dtype=torch.int32)
    tests = torch.tensor([[500, 60, 20], [90, 30, 0], [400, 50, 10], [30, 9, 1]],
                         dtype=torch.int64)
    assert trace.live_tensor([(d, tests[i]) for i, d in enumerate((1, 2, 1, 2))]).tolist() \
        == tests.tolist()
    assert trace.live_tensor([(d, lives[i:i + 1]) for i, d in enumerate((1, 2, 1, 2))]).tolist() \
        == [50, 7, 40, 3]
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.frame() as fr:
            fr.replayed(cap, lives, tests)
    rec = trace.frames()[-1]
    assert rec.box_tests == {1: 900, 2: 120} and rec.live_rays == {1: 90, 2: 10}
    assert rec.pair_tests == {1: (110, 30), 2: (39, 1)}


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_kernel_box_tests_equal_the_plain_count_on_card(card):
    """large_mesh at 256², depth 4 on the card: each depth's trace kernel
    adds to its counters the group and member tests (and the pairs run and
    pruned) that the plain trace counts in the kernel's warps, and gives
    the plain trace's state."""
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw

    s = chip_smoke.scene_setup("large_mesh", dict(resolution_override=(256, 256)), card)
    cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
    fb = binding.frame_buffer(card, uni, cset.mats_host, lights)
    pk = tkc.prim_table(None, (0, 0), card)
    st = kw.primary(cset, fb, cfg, cfg.height, *pk, fission=True)
    kw.shade(st, None, None, cset, fb, cfg, 0, *pk)
    for d in range(1, cfg.max_depth):
        idx, n_live = kw.compact(st)
        got = torch.zeros(3, dtype=torch.int64, device=card)
        want = torch.zeros(3, dtype=torch.int64, device=card)
        plain = st.clone()
        kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk, counts=got)
        ttw.trace_listed_stage(plain, idx, n_live, cset, *pk, counts=want)
        assert torch.equal(st, plain), d
        assert got.tolist() == want.tolist() and int(got[0]) > 0, (d, got.tolist(), want.tolist())
        kw.shade(st, idx, n_live, cset, fb, cfg, d, *pk)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", [
    ("large_mesh", dict(resolution_override=(2048, 2048), max_depth=4)),
    ("glass_sphere", dict(resolution_override=(1024, 1024), max_depth=6, aa_samples=4)),
])
def test_renderer_frames_keep_the_plain_bits_on_card(card, name, kw):
    """The Renderer's frame (the fission graph, its traces and listed shades
    culled in two levels) equals the plain stages' frame on the card bit for
    bit, image and rays; a traced replay records the traces' box tests."""
    r = cosig_tpu_torch.Renderer(device=card)
    scene, st = chip_smoke.load(name)
    st = st.replace(**kw)
    r.render_to_device(scene, st)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        img = r.render_to_device(scene, st)
    rec = trace.frames()[-1]
    assert list(rec.box_tests) == list(rec.live_rays) == list(range(1, st.max_depth))
    assert all(0 < t < 300 * rec.live_rays[d] for d, t in rec.box_tests.items())
    cset = r._geometry_for(scene)[0]
    params = tsoa.frame_params(scene, st)
    cfg = tsoa.static_config(scene, st)
    ref, rays = ttw.render_wavefront(cset, tkc.build_uniforms(params),
                                     tkc.build_lights(params, cfg.multi_light), cfg, plain=True,
                                     fission=True)
    assert torch.equal(img, ref) and r.last_stats.rays_traced == rays
