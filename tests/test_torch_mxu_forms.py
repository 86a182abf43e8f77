"""The tensor-core form of the pair test (the JAX package's MXU form) in the
wavefront's fission form and with separate primary and shadow cluster
sets, on the CPU.

The JAX package applies its MXU switch per stage whatever the form
(``cosig_tpu/ops/trace_wavefront.py:621-714``): the trace and the fission
primary take it for the closest hit, the shade for its shadow rays in full
mode only (``COSIG_MXU_SHADOW=0`` keeps them exact), and the shadow rays
through a separate shadow set never (``_make_shadow_traverse`` gets no
``geom_mx``). So:

* the plain frames of each form are held to the JAX package's MXU frames
  of the same form in interpret mode, rendered by
  ``test_torch_effects.jax_references`` in a child process without FMA,
  at ``test_torch_mxu.hold_mx``'s gates;
* a pair's planes are a fixed sum of exact limb products whichever rays
  share a tile, and the (t, gid) winner and occlusion do not depend on the
  cut, so every form equals the fused tensor-core frame bit for bit: the
  same mode's, or closest-only with a separate shadow set;
* every entry point takes every combination (``render_wavefront``,
  ``trace_state``, both ``render_chain``s; ``FrameGraph`` on a card).

The kernels run on a card: the ``gpu`` test below and chip_smoke.py
phase 12."""

import pytest
import torch

import chip_smoke
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.ops import frame_graph
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_wavefront as ttw
from test_torch_effects import BLUR, FORM_KS, GLOSSY, SOFT, jax_references
from test_torch_mxu import CARD_FLIP_PIXELS, FLIP_ABS, FLIP_SHARE, MIN_FLIPS, hold_mx

CORNELL = dict(resolution_override=(32, 32), max_depth=3)
# key -> (scene, settings, mode, fission, sets of FORM_KS the render takes)
JAX_CASES = {
    "cornell_fission_full": ("demo_cornell", CORNELL, "full", True, ()),
    "cornell_fission_closest": ("demo_cornell", CORNELL, "closest", True, ()),
    "cornell_fission_sets": ("demo_cornell", CORNELL, "full", True, ("primary", "shadow")),
    "cornell_shadow_set": ("demo_cornell", CORNELL, "full", False, ("shadow",)),
    "tiny_fission_sets_effects": ("tiny", dict(resolution_override=(32, 32), max_depth=3,
                                               aa_samples=2, **SOFT, **GLOSSY, **BLUR),
                                  "full", True, ("primary", "shadow")),
}
MODES = ("full", "closest")


def _forms(s, fission, names):
    sets = chip_smoke.form_sets(s, {n: FORM_KS[n] for n in names}, "cpu")
    return dict(fission=fission, cset_primary=sets.get("primary"),
                cset_shadow=sets.get("shadow"))


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    jobs = [dict(key=key, scene=name, settings=kw, path="wavefront", mxu=True,
                 closest=mode == "closest", fission=fission,
                 ks=dict(main=None, **{n: FORM_KS[n] for n in names}))
            for key, (name, kw, mode, fission, names) in JAX_CASES.items()]
    return jax_references(jobs, tmp_path_factory.mktemp("mxu_forms"))


@pytest.mark.parametrize("key", list(JAX_CASES))
def test_mx_forms_match_jax_mxu(refs, key):
    """Each form's plain tensor-core frame against the JAX package's MXU
    frame of the same form and mode."""
    name, kw, mode, fission, names = JAX_CASES[key]
    s = chip_smoke.scene_setup(name, kw, "cpu")
    img, rays = ttw.render_wavefront(s["cset"], s["uni"], s["lights"], s["cfg"], mxu=mode,
                                     **_forms(s, fission, names))
    hold_mx(img, rays, *refs[key], s["cfg"].max_depth)


@pytest.fixture(scope="module", params=["demo_cornell", "tiny"])
def frames(request):
    """A small frame, its form sets and the fused frames of every mode."""
    kw = dict(resolution_override=(24, 16), max_depth=3)
    if request.param == "tiny":
        kw.update(aa_samples=2, **SOFT, **GLOSSY)
    s = chip_smoke.scene_setup(request.param, kw, "cpu")
    s["sets"] = chip_smoke.form_sets(s, dict(primary=FORM_KS["primary"],
                                             shadow=FORM_KS["shadow"]), "cpu")
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    s["fused"] = {m: ttw.render_wavefront(*a, mxu=m) for m in ("off",) + MODES}
    return s


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", list(chip_smoke.FORMS))
def test_forms_bit_equal_to_the_fused_mx_frame(frames, form, mode):
    """Every form in the tensor-core form equals the fused tensor-core frame
    bit for bit, image and rays: the same mode's, or closest-only with a
    separate shadow set, whose shadow rays take the exact test in either
    mode. ``trace_state`` gives the same final state's image and
    ``render_chain`` (both) k times the rays."""
    s = frames
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    f = chip_smoke.form_kwargs(s["sets"], form)
    want_img, want_rays = s["fused"]["closest" if f["cset_shadow"] is not None else mode]
    img, rays = ttw.render_wavefront(*a, mxu=mode, **f)
    assert torch.equal(img, want_img) and rays == want_rays
    state = ttw.trace_state(*a, mxu=mode, **f)
    assert state.shape[0] == tkc.state_rows(f["fission"])
    assert torch.equal(ttw.finalize(state, s["cfg"], s["cfg"].height)[0], want_img)
    for chain in (lambda: ttw.render_chain(*a, 2, mxu=mode, **f),
                  lambda: frame_graph.render_chain("wavefront", *a, 2, mxu=mode, **f)):
        img, rays = chain()
        assert torch.equal(img, want_img) and rays == 2 * want_rays


def test_mx_forms_differ_from_the_exact_frame(frames):
    """The forms ran the tensor-core test: "full" and "closest" are not the
    exact frame, and they part from each other only through the shadow rays
    (the fission form's shade in "full" takes the tensor-core any hit),
    which occlude alike here but count whole 8-row tiles of pair tests."""
    s = frames
    a = (s["cset"], s["uni"], s["lights"], s["cfg"])
    f = chip_smoke.form_kwargs(s["sets"], "fission")
    pairs = {}
    for mode in MODES:
        tkc.reset_work()
        img, _ = ttw.render_wavefront(*a, mxu=mode, **f)
        pairs[mode] = tkc.WORK["pair_tests"]
        assert not torch.equal(img, s["fused"]["off"][0])
    assert pairs["full"] > pairs["closest"]


def test_shade_and_trace_stages_take_the_mode():
    """The plain stages of the fission form: the trace runs the tensor-core
    closest hit in both modes, the shade's shadow rays only in "full"; the
    fused bounce_core on a separate shadow set keeps them exact (the JAX
    package's shadow traversal has no MXU form). A walk's mode shows in the
    pair tests it counts: the tensor-core any hit counts whole 8-row tiles."""
    s = chip_smoke.scene_setup("demo_cornell", dict(resolution_override=(24, 16), max_depth=2),
                               "cpu")
    cset, cfg = s["cset"], s["cfg"]
    uni, lights, mats, prims, n_sph, n_box = ttw.frame_inputs(cset, s["uni"], s["lights"], 0,
                                                               None, None, (0, 0))
    pk = (prims, n_sph, n_box)
    st = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk, fission=True)
    pairs, recs = {}, {}
    for mode in ("off",) + MODES:
        ref = st.clone()
        tkc.reset_work()
        ttw.primary_shade(ref, cset, uni, mats, lights, cfg, *pk, mxu=mode)
        pairs[mode] = tkc.WORK["pair_tests"]
        idx, n_live = ttw.compact_plain(ref)
        ttw.trace_listed_stage(ref, idx, n_live, cset, *pk, mxu=mode)
        recs[mode] = ref[tkc.REC0:tkc.REC0 + 5].clone()
    assert pairs["closest"] == pairs["off"] < pairs["full"]
    assert torch.equal(recs["full"], recs["closest"])
    assert not torch.equal(recs["full"], recs["off"])
    # The fused bounce with a separate shadow set: "full" counts the pairs
    # of "closest", since its shadow rays take the exact walk.
    shadow = chip_smoke.form_sets(s, dict(shadow=FORM_KS["shadow"]), "cpu")["shadow"]
    st = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk)
    idx, n_live = ttw.compact_plain(st)
    states = {}
    for mode in MODES:
        states[mode] = st.clone()
        tkc.reset_work()
        ttw.bounce_listed_stage(states[mode], idx, n_live, cset, uni, mats, lights, cfg, 1, *pk,
                                cset_shadow=shadow, mxu=mode)
        pairs[mode] = tkc.WORK["pair_tests"]
    assert pairs["full"] == pairs["closest"] and torch.equal(states["full"], states["closest"])
    with pytest.raises(ValueError, match="mxu"):
        ttw.trace_listed_stage(st.clone(), idx, n_live, cset, *pk, mxu="on")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_mx_form_kernels_on_card(card):
    """On a card every new build launches where its form and mode put it;
    each stage holds its plain version on the same input at
    test_mx_kernels_on_card's gates (at most max(MIN_FLIPS, 0.01 %) flips,
    the rest RMSE < 1e-5, rays within 8), and every flipped ray is one of
    the rays whose pixels CARD_FLIP_PIXELS names, which turn on the
    coplanar triangles 0 and 9 (ray 747 turns in the closest hit at depth
    1 on equal inputs, in the fused form too); each form's frame equals the
    fused tensor-core kernels' frame bit for bit, and its CUDA graph
    replays it bit for bit."""
    from cosig_tpu_torch.kernels import wavefront as kw

    s = chip_smoke.scene_setup("demo_cornell", dict(resolution_override=(48, 32), max_depth=3),
                               card)
    sets = chip_smoke.form_sets(s, dict(primary=FORM_KS["primary"], shadow=FORM_KS["shadow"]),
                                card)
    cset, cfg = s["cset"], s["cfg"]
    a = (cset, s["uni"], s["lights"], cfg)
    uni, lights, mats, prims, n_sph, n_box = ttw.frame_inputs(cset, s["uni"], s["lights"], 0,
                                                               None, None, (0, 0))
    pk = (prims, n_sph, n_box)
    fb = binding.frame_buffer(card, uni, mats, lights)
    coplanar = {y * cfg.width + x for x, y in CARD_FLIP_PIXELS}

    def held(tag, st_k, st_p):
        ka, pa = chip_smoke.mx_state_rows(st_k), chip_smoke.mx_state_rows(st_p)
        d = (ka - pa).abs().cpu().double()
        flips = (d > FLIP_ABS).any(dim=0)
        flipped = set(torch.nonzero(flips).squeeze(1).tolist())
        assert flipped <= coplanar and len(flipped) <= max(MIN_FLIPS, FLIP_SHARE * d.shape[1]), \
            (tag, flipped)
        assert float(d[:, ~flips].pow(2).mean().sqrt()) < 1e-5, tag
        assert abs(float(st_k[tkc.ROW_COUNT].sum()) - float(st_p[tkc.ROW_COUNT].sum())) <= 8

    for mode in MODES:
        for form in chip_smoke.FORMS:
            f = chip_smoke.form_kwargs(sets, form)
            fis, css = f["fission"], f["cset_shadow"]
            pcs = f["cset_primary"] or cset
            p_sh, b_sh = css or pcs, css or cset
            sh_mxu = mode if css is None else "off"
            tag = f"{form} {mode}"
            binding.reset_counts()
            prim_sh = None if fis else css
            st = kw.primary(pcs, fb, cfg, cfg.height, *pk, fission=fis, cset_shadow=prim_sh,
                            mxu=mode)
            held(tag, st, ttw.primary_stage(pcs, uni, mats, lights, cfg, cfg.height, *pk,
                                            fission=fis, cset_shadow=prim_sh, mxu=mode))
            if fis:
                ref = st.clone()
                kw.shade(st, None, None, p_sh, fb, cfg, 0, *pk, mxu=sh_mxu)
                ttw.primary_shade(ref, p_sh, uni, mats, lights, cfg, *pk, mxu=sh_mxu)
                held(tag, st, ref)
            for d in range(1, cfg.max_depth):
                idx, n_live = kw.compact(st)
                ref = st.clone()
                if fis:
                    kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk, mxu=mode)
                    ttw.trace_listed_stage(ref, idx, n_live, cset, *pk, mxu=mode)
                    held(tag, st, ref)
                    ref = st.clone()
                    kw.shade(st, idx, n_live, b_sh, fb, cfg, d, *pk, mxu=sh_mxu)
                    ttw.shade_listed_stage(ref, idx, n_live, b_sh, uni, mats, lights, cfg, d,
                                           *pk, mxu=sh_mxu)
                else:
                    kw.bounce(st, idx, n_live, cset, fb, cfg, d, *pk, cset_shadow=css, mxu=mode)
                    ttw.bounce_listed_stage(ref, idx, n_live, cset, uni, mats, lights, cfg, d,
                                            *pk, cset_shadow=css, mxu=mode)
                held(tag, st, ref)
            got = {k: v for k, v in binding.LAUNCHES.items() if v}
            assert got == chip_smoke.mx_form_launches(cfg.max_depth, f, mode), (tag, got)
            img, rays = ttw.finalize(st, cfg, cfg.height)
            fused = ttw.render_wavefront(*a, mxu="closest" if css is not None else mode)
            assert torch.equal(img, fused[0]) and int(rays) == int(fused[1]), tag
            g = frame_graph.FrameGraph("wavefront", cset, cfg, s["uni"], s["lights"], mxu=mode,
                                       **f)
            img_g, rays_g = g.replay(s["uni"], s["lights"])
            assert torch.equal(img_g, img) and int(rays_g) == int(rays), tag
