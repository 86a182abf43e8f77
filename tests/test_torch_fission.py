"""The wavefront's fission form (separate trace and shade stages, the hit
record in state rows 15-19) and its separate primary and shadow cluster
sets (``cset_primary``, ``cset_shadow``) in the port, on the CPU.

Each form, and all of them together, gives the port's own fused
single-set plain render bit for bit, image and rays: the (t, gid) winner
and any-hit occlusion do not depend on how the triangles are clustered,
and the record holds the traversal's exact float32 values. Against the
JAX package's ``render_wavefront`` in interpret mode, with the same
``cset_primary``/``cset_shadow`` and its ``_FISSION`` switch
monkeypatched as its own tests do (tests/test_pallas.py:349-386,
:649-672), the port holds ROADMAP's slice tolerances: depth 1 max <=
2e-6, deeper RMSE < 1e-5 and max < 1e-3, rays within 8. The cluster sets
are the JAX package's, carried across with ``cluster_set_from_arrays``.
The kernels themselves run on a card: the ``gpu`` tests (the module
imports JAX only inside the tests that compare with it, so
``python -m pytest tests/test_torch_fission.py -m gpu --noconftest`` runs
where JAX is missing) and chip_smoke.py phase 10."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.accel.clusters import cluster_set_from_arrays
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.kernels import wavefront as kw
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import frame_graph
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_wavefront as ttw

EFFECTS = dict(aa_samples=2, enable_soft_shadows=True, light_size=5.0, enable_glossy=True,
               surface_roughness=0.05)
# (scene, settings, analytic) at a small size; every effect of the shade's
# RNG in the tiny case.
CASES = {
    "cornell_d1": ("demo_cornell", dict(resolution_override=(48, 32), max_depth=1), False),
    "cornell_d3": ("demo_cornell", dict(resolution_override=(48, 32), max_depth=3), False),
    "tiny_effects": ("tiny", dict(resolution_override=(32, 32), max_depth=3, **EFFECTS), False),
    "glass": ("glass_sphere", dict(resolution_override=(48, 48), max_depth=3), False),
    "large_mesh": ("large_mesh", dict(resolution_override=(48, 48), max_depth=3), False),
    "mixed_analytic": ("mixed", dict(resolution_override=(64, 48), max_depth=3), True),
}
FORMS = {
    "fission": dict(fission=True),
    "primary": dict(primary=True),
    "shadow": dict(shadow=True),
    "all": dict(fission=True, primary=True, shadow=True),
}


@pytest.fixture(scope="module")
def frames():
    """Per case: the port's frame inputs, a finer set (k / 4) for the
    primary stage and a coarser one (2 k) for the shadow rays."""
    out = {}
    for key, (name, kw_, analytic) in CASES.items():
        s = chip_smoke.scene_setup(name, kw_, "cpu", analytic)
        k = s["cset"].k
        s.update(chip_smoke.form_sets(s, dict(primary=max(4, k // 4), shadow=2 * k), "cpu"))
        out[key] = s
    return out


def _render(s, form=(), **kw):
    f = dict(form)
    return ttw.render_wavefront(
        s["cset"], s["uni"], s["lights"], s["cfg"], prims=s["prims"],
        prim_counts=s["prim_counts"], fission=f.get("fission", False),
        cset_primary=s["primary"] if f.get("primary") else None,
        cset_shadow=s["shadow"] if f.get("shadow") else None, **kw)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("case", list(CASES))
def test_form_bit_equal_to_fused(frames, case, form):
    """Each form through the kernels' wrappers (the plain versions on the
    CPU) against the fused single-set plain render: image and rays equal."""
    s = frames[case]
    if form in ("shadow", "all"):
        assert s["shadow"].aabb_t.shape[1] <= 512
    img0, rays0 = _render(s, plain=True)
    img, rays = _render(s, FORMS[form].items())
    assert torch.equal(img, img0) and rays == rays0
    assert img.shape == (s["cfg"].height, s["cfg"].width, 3)


# Sets past 128 rows, which the kernels walk in slots (csrc/walk_layout.h):
# large_mesh (k = 64) with its main set at k = 512 (a primary set of 128
# rows and a shadow set of 1024 beside it), or a shadow set at k = 512 or
# 1024 (and a primary set of 16) beside its own k = 64 set; (case, form)
# pairs.
SLOT_SETS = {"main512": dict(main=512, primary=128, shadow=1024),
             "shadow512": dict(primary=16, shadow=512),
             "shadow1024": dict(primary=16, shadow=1024)}
SLOT_CASES = [("main512", f) for f in ("fused", "fission", "primary", "shadow", "all")] + \
    [(c, f) for c in ("shadow512", "shadow1024") for f in ("shadow", "all")]


@pytest.fixture(scope="module")
def slot_frames():
    """large_mesh at 48x48 d3 with the sets of SLOT_SETS, per case."""
    name, kw_, analytic = CASES["large_mesh"]
    out = {}
    for case, ks in SLOT_SETS.items():
        s = chip_smoke.scene_setup(name, kw_, "cpu", analytic)
        sets = chip_smoke.form_sets(s, ks, "cpu")
        s["own"] = s["cset"]
        s["cset"] = sets.pop("main", s["cset"])
        s.update(sets)
        out[case] = s
    return out


@pytest.mark.parametrize("case,form", SLOT_CASES, ids=[f"{c}-{f}" for c, f in SLOT_CASES])
def test_slot_sizes_bit_equal_to_fused(slot_frames, case, form):
    """Cluster sets past 128 rows in every form through the wrappers (the
    plain versions on the CPU), each frame equal to the port's fused
    frame on the scene's own k = 64 set bit for bit: the (t, gid) winner
    and occlusion do not depend on the cut; the shadow sets fit one cull
    block."""
    s = slot_frames[case]
    if "shadow" in s:
        assert int(s["shadow"].aabb_t.shape[1]) <= 512
    img0, rays0 = _render(dict(s, cset=s["own"]), plain=True)
    img, rays = _render(s, FORMS.get(form, {}).items())
    assert torch.equal(img, img0) and rays == rays0


def test_fission_state_rows(frames):
    """The fission state has 24 rows: rows 0-14 equal to the fused state's,
    the record of each ray's last trace in rows 15-19 (hit exactly where
    t < INF, both hits and misses present) and zeros after them."""
    s = frames["cornell_d3"]
    a = dict(cset=s["cset"], uniforms=s["uni"], lights=s["lights"], cfg=s["cfg"])
    fused = ttw.trace_state(**a)
    fiss = ttw.trace_state(**a, fission=True)
    assert fused.shape[0] == tkc.STATE_ROWS and fiss.shape[0] == tkc.FISSION_ROWS
    assert torch.equal(fiss[:15], fused[:15])
    assert torch.equal(fiss[20:], torch.zeros_like(fiss[20:]))
    hit, t = tkc.rec_load(fiss)[:2]
    assert torch.equal(hit, t < tkc.INF) and bool(hit.any()) and bool((~hit).any())


def test_primary_shade_equals_fused_primary(frames):
    """The primary stage as trace, then shade over every ray, equals the
    fused primary stage on rows 0-14, and counts the same slab, pair and
    frustum tests."""
    s = frames["tiny_effects"]
    cset, cfg = s["cset"], s["cfg"]
    mats = cset.mats_host
    prims = (s["prims"], *s["prim_counts"])
    tkc.reset_work()
    fused = ttw.primary_stage(cset, s["uni"], mats, s["lights"], cfg, cfg.height, *prims)
    work_fused = dict(tkc.WORK)
    tkc.reset_work()
    fiss = ttw.primary_stage(cset, s["uni"], mats, s["lights"], cfg, cfg.height, *prims,
                             fission=True)
    ttw.primary_shade(fiss, cset, s["uni"], mats, s["lights"], cfg, *prims)
    assert dict(tkc.WORK) == work_fused
    assert torch.equal(fiss[:15], fused[:15])


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), share=st.floats(0.0, 1.0), depth=st.integers(1, 2))
def test_trace_then_shade_equals_bounce_on_random_lists(seed, share, depth):
    """On a random live list of a primary state (any share of the live
    rays, in any order), the plain trace then the plain shade give rows
    0-14 of the plain fused bounce bit for bit."""
    s = _HYP.get("s")
    if s is None:
        s = _HYP["s"] = chip_smoke.scene_setup(
            "demo_cornell", dict(resolution_override=(24, 16), max_depth=3, **EFFECTS), "cpu")
    cset, cfg, uni, lights = s["cset"], s["cfg"], s["uni"], s["lights"]
    mats = cset.mats_host
    prims = tkc.prim_table(None, (0, 0), "cpu")
    base = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *prims)
    rng = np.random.default_rng(seed)
    live = np.nonzero(base[tkc.ROW_ALIVE].numpy() > 0)[0]
    pick = rng.permutation(live)[: int(round(share * live.size))]
    # Rays left off the list take no part: make them dead, as a list holds exactly the live rays.
    base[tkc.ROW_ALIVE] = 0.0
    base[tkc.ROW_ALIVE, torch.from_numpy(pick)] = 1.0
    idx = torch.zeros(base.shape[1], dtype=torch.int32)
    idx[: pick.size] = torch.from_numpy(pick.astype(np.int32))
    n_live = torch.tensor([pick.size], dtype=torch.int32)
    fused = base.clone()
    ttw.bounce_listed_stage(fused, idx, n_live, cset, uni, mats, lights, cfg, depth, *prims)
    fiss = torch.zeros((tkc.FISSION_ROWS, base.shape[1]), dtype=torch.float32)
    fiss[:16] = base
    ttw.trace_listed_stage(fiss, idx, n_live, cset, *prims)
    ttw.shade_listed_stage(fiss, idx, n_live, cset, uni, mats, lights, cfg, depth, *prims)
    assert torch.equal(fiss[:15], fused[:15])


_HYP = {}


def test_shadow_set_over_one_cull_block_raises(frames):
    """A shadow set wider than one cull block (c_pad > 512) is refused with
    a ValueError naming the limit, at every entry point."""
    s = frames["large_mesh"]
    wide = chip_smoke.form_sets(s, dict(wide=8), "cpu")["wide"]
    assert wide.aabb_t.shape[1] > 512
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    for call in (lambda: ttw.render_wavefront(*a, cset_shadow=wide),
                 lambda: ttw.trace_state(*a, cset_shadow=wide),
                 lambda: ttw.render_chain(*a, 1, cset_shadow=wide),
                 lambda: frame_graph.FrameGraph("wavefront", s["cset"], s["cfg"], s["uni"],
                                                s["lights"], cset_shadow=wide)):
        with pytest.raises(ValueError, match="512"):
            call()
    other = chip_smoke.form_sets(frames["glass"], dict(k=16), "cpu")["k"]
    with pytest.raises(ValueError, match="triangles"):
        ttw.render_wavefront(*a, cset_primary=other)


def test_forms_only_on_the_wavefront(frames):
    s = frames["cornell_d1"]
    for path in ("megakernel", "debug"):
        with pytest.raises(ValueError, match="fission"):
            frame_graph.render_chain(path, s["cset"], s["uni"], s["lights"], s["cfg"], 1,
                                     fission=True)


def test_render_chain_with_forms(frames):
    """render_chain (k plain frames on the CPU) takes the forms: the
    single fused frame's image, k times its rays."""
    s = frames["cornell_d3"]
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    img0, rays0 = ttw.render_wavefront(*a)
    img, rays = ttw.render_chain(*a, 2, fission=True, cset_primary=s["primary"],
                                 cset_shadow=s["shadow"])
    assert torch.equal(img, img0) and rays == 2 * rays0


def test_wrapper_arguments(frames):
    """The wrappers refuse a fission primary with a shadow set (its shade
    walks that set) and a shade whose list does not match its depth."""
    s = frames["cornell_d1"]
    cset, cfg = s["cset"], s["cfg"]
    fb = binding.frame_buffer("cpu", s["uni"], cset.mats_host, s["lights"])
    prims = tkc.prim_table(None, (0, 0), "cpu")
    with pytest.raises(ValueError, match="shadow"):
        kw.primary(cset, fb, cfg, cfg.height, *prims, fission=True, cset_shadow=s["shadow"])
    state = kw.primary(cset, fb, cfg, cfg.height, *prims, fission=True)
    assert state.shape[0] == tkc.FISSION_ROWS
    idx, n_live = kw.compact(state)
    with pytest.raises(ValueError, match="list"):
        kw.shade(state, idx, n_live, cset, fb, cfg, 0, *prims)
    with pytest.raises(ValueError, match="list"):
        kw.shade(state, None, None, cset, fb, cfg, 1, *prims)


# ---- against the JAX package (Pallas in interpret mode) ----


def _jax_setup(name, settings, ks):
    """JAX (arrays, params, cfg, cluster sets by k) and the port's (cluster
    sets carried across, uniforms, lights, cfg)."""
    import cosig_tpu
    from cosig_tpu.accel import clusters as jcl
    from cosig_tpu.models import soa as jsoa
    from cosig_tpu.scene.generate import CONFIGS

    if name == "tiny":
        from __graft_entry__ import _tiny_scene

        scene, port_scene = _tiny_scene(), cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    elif name == "demo_cornell":
        scene = cosig_tpu.load_scene("scenes/demo_cornell.txt")
        port_scene = cosig_tpu_torch.load_scene("scenes/demo_cornell.txt")
    else:
        scene, port_scene = CONFIGS[name]()[0], chip_smoke.load(name)[0]
    arrays = jsoa.compile_scene(scene)
    jsets = {key: jcl.build_clusters(arrays, k=k) for key, k in ks.items()}
    port_settings = cosig_tpu_torch.RenderSettings(**dataclasses.asdict(settings))
    tparams = tsoa.frame_params(port_scene, port_settings)
    tcfg = tsoa.static_config(port_scene, port_settings)
    tsets = {key: cluster_set_from_arrays(np.asarray(c.geom), np.asarray(c.aabb_t),
                                          np.asarray(c.sb_aabb_t), np.asarray(c.mats))
             for key, c in jsets.items()}
    port = (tkc.build_uniforms(tparams), tkc.build_lights(tparams, tcfg.multi_light), tcfg)
    return (jsoa.frame_params(scene, settings), jsoa.static_config(scene, settings), jsets), \
        (tsets, port)


JAX_CASES = [
    # (scene, settings, k of the main set, the primary set, the shadow set)
    ("demo_cornell", dict(resolution_override=(64, 48), max_depth=1), (32, 8, 64)),
    ("glass_sphere", dict(resolution_override=(48, 48), max_depth=3), (32, 8, 64)),
    # AA 2 without soft shadows or glossy: with them JAX's render here is
    # 3.1e-5 RMSE from the port's, because XLA:CPU contracts rng.hash33's
    # multiply-adds into FMAs and the hash's fractional part turns those
    # ulps into jumps. test_torch_effects.py renders the JAX reference
    # without FMA (--xla_cpu_max_isa=AVX) and holds every effect, and this
    # case with every effect, at the slice tolerances.
    ("tiny", dict(resolution_override=(32, 32), max_depth=3, aa_samples=2), (32, 8, 64)),
]


@pytest.mark.parametrize("name,kw_,ks", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_forms_match_jax_interpret(name, kw_, ks, monkeypatch):
    """Fission with both separate sets against the JAX package's
    render_wavefront with the same sets and _FISSION on, at the slice
    tolerances; and bit-equal to the port's own fused single-set render."""
    _match_jax_interpret(name, kw_, ks, monkeypatch)


def test_shadow_set_k512_matches_jax_interpret(monkeypatch):
    """A shadow set past 128 rows (k = 512, which the kernels walk in
    slots) as test_forms_match_jax_interpret holds the others: glass_sphere
    with its main set at k = 32 and a primary set at k = 8."""
    _match_jax_interpret("glass_sphere", dict(resolution_override=(48, 48), max_depth=3),
                         (32, 8, 512), monkeypatch)


def _match_jax_interpret(name, kw_, ks, monkeypatch):
    import cosig_tpu
    from cosig_tpu.ops import trace_wavefront as jtw

    settings_ = cosig_tpu.RenderSettings(**kw_)
    (params, cfg, jsets), (tsets, (uni, lights, tcfg)) = _jax_setup(
        name, settings_, dict(main=ks[0], primary=ks[1], shadow=ks[2]))
    monkeypatch.setattr(jtw, "_FISSION", True)
    ref, jrays = jtw.render_wavefront(jsets["main"], params, cfg, interpret=True,
                                      cset_primary=jsets["primary"],
                                      cset_shadow=jsets["shadow"])
    ref = np.asarray(ref)
    img, rays = ttw.render_wavefront(tsets["main"], uni, lights, tcfg, fission=True,
                                     cset_primary=tsets["primary"], cset_shadow=tsets["shadow"])
    fused, rays0 = ttw.render_wavefront(tsets["main"], uni, lights, tcfg, plain=True)
    assert torch.equal(img, fused) and rays == rays0
    img = img.numpy()
    assert abs(rays - float(jrays)) <= 8
    if tcfg.max_depth == 1:
        assert np.abs(img - ref).max() <= 2e-6
    else:
        assert float(np.sqrt(((img - ref) ** 2).mean())) < 1e-5
        assert np.abs(img - ref).max() < 1e-3


# ---- on a card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(FORMS))
def test_forms_on_card(card, form):
    """On a card the forms launch their kernels (trace and shade with
    fission, the shadow-set builds with a shadow set), and the frame equals
    the plain fused frame bit for bit."""
    s = chip_smoke.scene_setup("tiny", dict(resolution_override=(40, 24), max_depth=3,
                                            **EFFECTS), card)
    s.update(chip_smoke.form_sets(s, dict(primary=8, shadow=64), card))
    binding.reset_counts()
    img, rays = _render(s, FORMS[form].items())
    f = FORMS[form]
    if f.get("fission"):
        assert binding.LAUNCHES["trace"] == binding.LAUNCHES["shade"] - 1 == 2
        assert binding.LAUNCHES["primary_fission"] == 1
    if f.get("shadow") and not f.get("fission"):
        assert binding.LAUNCHES["primary_shadow"] == 1 and binding.LAUNCHES["bounce_shadow"] == 2
    img0, rays0 = _render(s, plain=True)
    assert torch.equal(img, img0) and rays == rays0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["main512", "shadow1024"])
def test_slot_sizes_on_card(card, case):
    """Sets past 128 rows render on a card: large_mesh with its main set at
    k = 512 through the primary, bounce, megakernel and debug kernels, or
    with a shadow set at k = 1024 through the shadow-set primary and
    bounce, each frame bit-equal to its plain version (before the walk had
    slots, the card refused a block walk over clusters of more than 503
    rows)."""
    from cosig_tpu_torch.ops import trace_megakernel as ttm

    name, kw_, _ = CASES["large_mesh"]
    s = chip_smoke.scene_setup(name, kw_, card)
    sets = chip_smoke.form_sets(s, SLOT_SETS[case], card)
    cset = sets.get("main", s["cset"])
    sh = sets["shadow"] if case == "shadow1024" else None
    a = (cset, s["uni"], s["lights"], s["cfg"])
    binding.reset_counts()
    img, rays = ttw.render_wavefront(*a, cset_shadow=sh)
    img0, rays0 = ttw.render_wavefront(s["cset"], *a[1:], plain=True)
    assert torch.equal(img, img0) and rays == rays0
    if sh is None:
        assert binding.LAUNCHES["primary"] == 1 and binding.LAUNCHES["bounce"] == 2
        img_m, rays_m = ttm.render_clusters(*a)
        assert binding.LAUNCHES["megakernel"] == 1
        assert (torch.equal(img_m, ttm.render_clusters(*a, plain=True)[0])
                and rays_m == rays0)
        dcfg = tsoa.static_config(s["scene"], s["settings"].replace(debug_mode=1))
        img_d, _ = ttm.render_debug(cset, s["uni"], s["lights"], dcfg)
        assert binding.LAUNCHES["debug"] == 1
        assert torch.equal(img_d, ttm.render_debug(cset, s["uni"], s["lights"], dcfg,
                                                   plain=True)[0])
    else:
        assert binding.LAUNCHES["primary_shadow"] == 1
        assert binding.LAUNCHES["bounce_shadow"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("k", [32, 64, 512])
def test_compacted_fission_kernels_on_card(card, k):
    """The fission primary and the shade kernel over every ray (past 32
    rows their compacted walks: the closest hit behind the frustum cull and
    the any hit; at 32 rows the per-warp walk) and the shade on each depth's
    list (compacted at every k), bit-equal to their plain versions stage by
    stage on large_mesh at 128x96 d4, its own 64-row clusters and cuts of
    32 and 512 rows: every row of the state, the hit record's included."""
    s = chip_smoke.scene_setup("large_mesh", dict(resolution_override=(128, 96), max_depth=4),
                               card)
    cset = s["cset"] if k == s["cset"].k else chip_smoke.form_sets(s, dict(k=k), card)["k"]
    cfg = s["cfg"]
    uni, lights, mats, prims, n_sph, n_box = ttw.frame_inputs(
        cset, s["uni"], s["lights"], 0, None, s["prims"], s["prim_counts"])
    pk = (prims, n_sph, n_box)
    fb = binding.frame_buffer(card, uni, mats, lights)
    binding.reset_counts()
    st = kw.primary(cset, fb, cfg, cfg.height, *pk, fission=True)
    assert torch.equal(st, ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk,
                                             fission=True))
    ref = st.clone()
    kw.shade(st, None, None, cset, fb, cfg, 0, *pk)
    ttw.primary_shade(ref, cset, uni, mats, lights, cfg, *pk)
    assert torch.equal(st, ref)
    for d in range(1, cfg.max_depth):
        idx, n_live = kw.compact(st)
        kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk)
        ref = st.clone()
        kw.shade(st, idx, n_live, cset, fb, cfg, d, *pk)
        ttw.shade_listed_stage(ref, idx, n_live, cset, uni, mats, lights, cfg, d, *pk)
        assert torch.equal(st, ref), d
    assert binding.LAUNCHES["primary_fission"] == 1
    assert binding.LAUNCHES["shade"] == cfg.max_depth
