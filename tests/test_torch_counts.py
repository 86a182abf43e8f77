"""The counters of the fission primary's closest hit and of the shade
kernels' any-hit shadow walks (``csrc/traverse_tile.cuh`` add_counts,
add_shadow_counts; the plain ``trace_wavefront.primary_stage``,
``primary_shade`` and ``shade_listed_stage`` with ``counts``), the walks that
the upstream's distributed ray tracing changes: motion blur shakes the camera
rays' origins, soft shadows jitter the shadow rays' light points. CPU tests
hold the plain versions' counts to a count of one ray at a time, with every
effect and without; the ``gpu``-marked ones hold the kernels' counters to
the plain versions' and the Renderer's frames with every effect to the
plain stages on the card: ``python -m pytest tests/test_torch_counts.py -m
gpu --noconftest``."""

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

# The upstream's three effects at the first non-zero entry of each menu
# (models/preset.py; the configuration glass_sphere_drt).
DRT = dict(enable_soft_shadows=True, light_size=5.0, enable_glossy=True, surface_roughness=0.05,
           enable_motion_blur=True, shutter_speed=0.5)
# glass_sphere's 82 clusters of 32 rows (the per-warp walks) and large_mesh's
# 221 of 64 (the compacted walks), at a few hundred camera rays.
SCENES = {"glass_sphere": dict(resolution_override=(16, 12), max_depth=3, aa_samples=2),
          "large_mesh": dict(resolution_override=(16, 16), max_depth=3, aa_samples=1)}
CASES = [(name, drt) for name in SCENES for drt in (False, True)]


def _setup(name, drt, device):
    return chip_smoke.scene_setup(name, dict(SCENES[name], **(DRT if drt else {})), device)


def _one_at_a_time(cset, call: dict, compacted: bool) -> tuple:
    """(box tests, pairs run, rays) of one traversal as the kernels count
    them, ray by ray: a closest hit's rays every pair of the boxes they
    enter (the unpruned walk), an any hit's up to the first occluder in
    cluster order (``compacted``: every row of the occluder's piece of 32),
    its box tests the cull's of the one pass (every scene here has fewer
    than 256 clusters): in frustum mode the candidates its block's hull
    passes, else every box, or with warps, a test of each group's union box
    and its members' where some ray of the warp enters the union."""
    ox, oy, oz, dx, dy, dz = call["rays"]
    active, max_t, any_hit = call["active"], call["max_t"], call["any_hit"]
    packets, warps, frustum = call["packets"], call["warps"], call["frustum"]
    geom, aabb = cset.geom, cset.aabb_t
    n_c = int(geom.shape[0])
    rows_real = (geom[:, :, tkc._GID] != float(tkc.GID_PAD)).sum(dim=1).tolist()
    inv = [torch.reciprocal(x) for x in (dx, dy, dz)]
    rays9 = (ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
    n_blocks = int(packets.max()) + 1
    if frustum:
        hull = tkc.packet_hulls(packets, n_blocks, active, ox, oy, oz, dx, dy, dz,
                                max_t=max_t if any_hit else None)
        cands = tkc.frustum_flags(hull, aabb[:6, :n_c]).sum(dim=1).tolist()
    groups = None
    if not frustum and warps is not None and n_c > tkc.CULL_GROUP:
        n_warps = int(warps.max()) + 1
        groups = []  # per group, the warps in which some active ray enters its union
        for c in range(0, n_c, tkc.CULL_GROUP):
            u = tkc.union_box(aabb[:6, c:min(c + tkc.CULL_GROUP, n_c)])
            g_in = active & tkc.group_flags(u, ox, oy, oz, dx, dy, dz, *inv, max_t)
            groups.append(set(warps[g_in].tolist()) if g_in.any() else set())
        del n_warps
    box = pairs = rays = 0
    for i in torch.nonzero(active).squeeze(1).tolist():
        rays += 1
        if frustum:
            box += cands[int(packets[i])]
        elif groups is not None:
            for g, warps_in in enumerate(groups):
                box += 1 + (min(tkc.CULL_GROUP, n_c - g * tkc.CULL_GROUP)
                            if int(warps[i]) in warps_in else 0)
        else:
            box += n_c
        tn, tf = tkc.slab(aabb[:6, :n_c], ox[i], oy[i], oz[i], inv[0][i], inv[1][i], inv[2][i])
        enters = ~(tn > tf) & ~(tf < 0.0)
        if any_hit:
            enters = enters & ~(tn > max_t[i])
        for c in torch.nonzero(enters).squeeze(1).tolist():
            real = rows_real[c]
            if not any_hit:
                pairs += real
                continue
            valid, t, _, _, _ = tkc._pair_planes(geom[c][None], torch.tensor([i]), rays9)
            occ = (valid & (t <= max_t[i]))[0, :real]
            if not occ.any():
                pairs += real
                continue
            first = int(torch.nonzero(occ)[0])
            pairs += min(real, (first // 32 + 1) * 32) if compacted else first + 1
            break
    return box, pairs, rays


def _recorded_frame(s, monkeypatch) -> tuple:
    """A traced fission frame of ``s`` on the CPU -> (its record, each
    kernel's traversal calls by plan label)."""
    calls, label = {}, [None]
    step, traverse = trace.plan_step, tkc.traverse

    def plan_step(stage, depth=0, n_live=None, counts=None):
        label[0] = f"{stage}.{depth}" if depth else stage
        step(stage, depth, n_live, counts)

    def spy(cset, ox, oy, oz, dx, dy, dz, active, max_t=None, any_hit=False, **kw):
        calls.setdefault(label[0], []).append(dict(
            cset=cset, rays=tuple(x.clone() for x in (ox, oy, oz, dx, dy, dz)),
            active=active.clone(), max_t=None if max_t is None else max_t.clone(),
            any_hit=any_hit, packets=kw.get("packets"), warps=kw.get("warps"),
            frustum=kw.get("frustum", False)))
        return traverse(cset, ox, oy, oz, dx, dy, dz, active, max_t=max_t, any_hit=any_hit, **kw)

    monkeypatch.setattr(trace, "plan_step", plan_step)
    monkeypatch.setattr(tkc, "traverse", spy)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.frame():
            frame_graph.render_chain("wavefront", s["cset"], s["uni"], s["lights"], s["cfg"], 1,
                                     fission=True)
    return trace.frames()[-1], calls


@pytest.mark.parametrize("name,drt", CASES)
def test_plain_counters_count_as_one_ray_at_a_time(name, drt, monkeypatch):
    """A traced fission frame on the CPU records the fission primary's box
    tests and pairs (run and pruned add up to every pair of the boxes its
    rays enter; the per-warp walk at glass prunes none) and, per depth, the
    shades' box tests, pairs run and shadow rays cast, each equal to a count
    of one ray at a time; the effects move them."""
    s = _setup(name, drt, "cpu")
    rec, calls = _recorded_frame(s, monkeypatch)
    cset = s["cset"]
    per_warp = cset.k <= ttw.PER_WARP_ROWS
    (primary,) = calls["primary"]
    box, pairs, rays = _one_at_a_time(cset, primary, False)
    assert rays == s["cfg"].width * s["cfg"].height * s["cfg"].aa_samples
    tests, run, pruned = rec.primary_tests
    assert (tests, run + pruned) == (box, pairs) and box > 0 and run > 0
    assert pruned == 0 if per_warp else pruned > 0
    assert sorted(rec.shadow_tests) == list(range(s["cfg"].max_depth))
    for depth, got in rec.shadow_tests.items():
        label = f"shade.{depth}" if depth else "shade_all"
        want = [0, 0, 0]
        for call in calls[label]:
            counted = _one_at_a_time(cset, call, compacted=depth > 0 or not per_warp)
            want = [a + b for a, b in zip(want, counted)]
        assert list(got) == want, (label, got, want)
        assert got[0] >= got[2], label
    assert all(x > 0 for x in rec.shadow_tests[0])


def test_replay_reads_every_counted_kernels_counters(monkeypatch):
    """A replayed frame reads one counter buffer of three words a kernel in
    the order of the capture's ``count_plan``, band after band: the fission
    primaries' into ``primary_tests``, the traces' into ``box_tests`` and
    ``pair_tests``, the shades' into ``shadow_tests`` by depth (0 the shade
    over every ray), each summed over the bands."""
    monkeypatch.setattr(trace, "_frames", trace.collections.deque(maxlen=trace.FRAMES_KEPT))
    labels = ("primary", "shade_all", "trace.1", "shade.1")
    cap = trace.Capture(1, "wavefront", ("primary", "shade_all", "compact.1", "trace.1",
                                         "shade.1") * 2, {}, {}, plan_bands=(0,) * 5 + (1,) * 5,
                        count_plan=labels * 2)
    tests = torch.tensor([[900, 5000, 70], [300, 800, 60], [500, 60, 20], [90, 30, 10],
                          [800, 4000, 30], [200, 700, 40], [400, 50, 10], [30, 9, 5]],
                         dtype=torch.int64)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.frame() as fr:
            fr.replayed(cap, torch.tensor([50, 40], dtype=torch.int32), tests)
    rec = trace.frames()[-1]
    assert rec.primary_tests == (1700, 9000, 100)
    assert rec.box_tests == {1: 900} and rec.pair_tests == {1: (110, 30)}
    assert rec.shadow_tests == {0: (500, 1500, 100), 1: (120, 39, 15)}


def test_counters_are_the_fission_primarys():
    """Only the fission primary keeps counters, an int64 [3] on its device."""
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw

    s = _setup("glass_sphere", False, "cpu")
    cset, cfg = s["cset"], s["cfg"]
    fb = binding.frame_buffer("cpu", s["uni"], cset.mats_host, s["lights"])
    pk = tkc.prim_table(None, (0, 0), "cpu")
    with pytest.raises(ValueError, match="fission primary keeps counters"):
        kw.primary(cset, fb, cfg, cfg.height, *pk, counts=torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        kw.primary(cset, fb, cfg, cfg.height, *pk, fission=True,
                   counts=torch.zeros(3, dtype=torch.int32))


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("name,drt", CASES)
def test_kernel_counters_equal_the_plain_counts_on_card(card, name, drt):
    """At 128² on the card, with every effect and without: the fission
    primary, the shade over every ray, and each depth's trace and listed
    shade add to their counters what the plain versions count on the same
    rays, and give the plain versions' states bit for bit."""
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw

    s = chip_smoke.scene_setup(name, dict(SCENES[name], resolution_override=(128, 128),
                                          **(DRT if drt else {})), card)
    cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
    fb = binding.frame_buffer(card, uni, cset.mats_host, lights)
    pk = tkc.prim_table(None, (0, 0), card)
    mats = cset.mats_host

    def zeros():
        return torch.zeros(3, dtype=torch.int64, device=card)

    got, want = zeros(), zeros()
    st = kw.primary(cset, fb, cfg, cfg.height, *pk, fission=True, counts=got)
    plain = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, fission=True,
                              counts=want)
    assert torch.equal(st, plain) and got.tolist() == want.tolist(), (got, want)
    assert int(got[0]) > 0 and int(got[1]) > 0
    got, want = zeros(), zeros()
    kw.shade(st, None, None, cset, fb, cfg, 0, *pk, counts=got)
    ttw.primary_shade(plain, cset, uni, mats, lights, cfg, *pk, counts=want)
    assert torch.equal(st, plain) and got.tolist() == want.tolist(), (got, want)
    for d in range(1, cfg.max_depth):
        idx, n_live = kw.compact(st)
        kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk)
        ttw.trace_listed_stage(plain, idx, n_live, cset, *pk)
        got, want = zeros(), zeros()
        kw.shade(st, idx, n_live, cset, fb, cfg, d, *pk, counts=got)
        ttw.shade_listed_stage(plain, idx, n_live, cset, uni, mats, lights, cfg, d, *pk,
                               counts=want)
        assert torch.equal(st, plain), d
        assert got.tolist() == want.tolist(), (d, got.tolist(), want.tolist())


@pytest.mark.gpu
def test_renderer_drt_frames_keep_the_plain_bits_on_card(card):
    """glass_sphere_drt's frame (1024², d6, AA 4, every effect) through the
    Renderer's fission graph equals the plain stages' frame on the card bit
    for bit, image and rays, in one replay (18 launches with the graph's);
    a traced replay records the primary's and every depth's shade counters."""
    from cosig_tpu_torch.kernels import binding

    r = cosig_tpu_torch.Renderer(device=card)
    scene, st = chip_smoke.load("glass_sphere_drt")
    r.render_to_device(scene, st)
    before = dict(binding.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        img = r.render_to_device(scene, st)
    # One replay: the graph and its 17 kernels (benchmark launches_per_frame).
    launched = sum(binding.LAUNCHES[k] - before[k] for k in before)
    assert launched == 18 and binding.LAUNCHES["graph"] - before["graph"] == 1
    assert r.last_capture.form == "fission"
    rec = trace.frames()[-1]
    assert len(rec.primary_tests) == 3 and rec.primary_tests[1] > 0
    assert sorted(rec.shadow_tests) == list(range(st.max_depth))
    cset = r._geometry_for(scene)[0]
    params = tsoa.frame_params(scene, st)
    cfg = tsoa.static_config(scene, st)
    ref, rays = ttw.render_wavefront(cset, tkc.build_uniforms(params),
                                     tkc.build_lights(params, cfg.multi_light), cfg, plain=True,
                                     fission=True)
    assert torch.equal(img, ref) and r.last_stats.rays_traced == rays
