"""The bounce stage's compaction on the CPU: the plain list against the
JAX package's ``_compact_prefix``, its order as a stable partition, the
listed bounce against the self-skip bounce, and the whole render through
the lists against the JAX wavefront."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import chip_smoke
import cosig_tpu
import cosig_tpu_torch
from cosig_tpu.accel import clusters as jcl
from cosig_tpu.models import soa as jsoa
from cosig_tpu.ops import trace_wavefront as jtw
from cosig_tpu_torch.accel.clusters import cluster_set_from_arrays
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.kernels import wavefront as kw
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_wavefront as ttw

GROUP = 128  # the JAX compaction's group of rays


def _grouped_state(seed: int, groups: int) -> np.ndarray:
    """A state f32 [16, groups * 128] whose 128-ray groups are each uniform
    in liveness and in direction octant (directions of random size, each
    component's sign the group's), so the JAX group order, expanded to ray
    ids, is the per-ray order."""
    r = np.random.default_rng(seed)
    n = groups * GROUP
    state = r.normal(size=(16, n)).astype(np.float32)
    alive = r.random(groups) < 0.6
    octant = r.integers(0, 8, groups)
    for axis in range(3):
        sign = np.where((octant >> axis) & 1, 1.0, -1.0)
        state[3 + axis] = np.abs(state[3 + axis]) * np.repeat(sign, GROUP)
    state[tkc.ROW_ALIVE] = np.repeat(alive, GROUP).astype(np.float32)
    state[tkc.ROW_ID] = np.arange(n, dtype=np.float32)
    return state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_plain_matches_jax_compact_prefix(seed):
    groups = 40
    n = groups * GROUP
    state = _grouped_state(seed, groups)
    _, group_perm, n_groups = jtw._compact_prefix(
        jnp.asarray(state), jnp.arange(groups, dtype=jnp.int32), n, n // GROUP, 16)
    n_groups = int(n_groups)
    ref = (np.asarray(group_perm)[:n_groups, None] * GROUP + np.arange(GROUP)).ravel()
    idx, n_live = ttw.compact_plain(torch.from_numpy(state))
    assert idx.dtype == n_live.dtype == torch.int32
    assert tuple(idx.shape) == (n,) and tuple(n_live.shape) == (1,)
    assert int(n_live) == n_groups * GROUP
    np.testing.assert_array_equal(idx[:int(n_live)].numpy(), ref)


# A component: positive, negative, either zero, or NaN (none of the last
# three counts as > 0, as in the JAX key).
_COMPONENTS = st.sampled_from([1.5, 0.25, -0.5, -2.0, 0.0, -0.0, float("nan")])


@settings(max_examples=60, deadline=None, database=None)
@given(rays=st.lists(st.tuples(st.booleans(), _COMPONENTS, _COMPONENTS, _COMPONENTS),
                     min_size=1, max_size=300))
@example(rays=[(False, 1.0, 1.0, 1.0)] * 200)  # every ray dead
@example(rays=[(True, -1.0, 1.0, -1.0), (True, 1.0, 1.0, 1.0)] * 150)  # every ray alive
def test_compaction_list_is_a_stable_partition_by_octant(rays):
    n = len(rays)
    state = torch.zeros((16, n), dtype=torch.float32)
    state[tkc.ROW_ALIVE] = torch.tensor([float(a) for a, *_ in rays])
    for axis in range(3):
        state[3 + axis] = torch.tensor([d[axis + 1] for d in rays])
    idx, n_live = ttw.compact_plain(state)
    m = int(n_live)
    live = [i for i, (a, *_) in enumerate(rays) if a]
    assert m == len(live)
    assert sorted(idx.tolist()) == list(range(n))  # a permutation of the ray ids

    def key(i):
        _, x, y, z = rays[i]
        return int(x > 0) + 2 * int(y > 0) + 4 * int(z > 0)

    assert idx[:m].tolist() == sorted(live, key=lambda i: (key(i), i))
    assert idx[m:].tolist() == sorted(set(range(n)) - set(live))
    assert kw.compact(state)[0].tolist() == idx.tolist()  # the CPU wrapper runs the plain list


def _keys(state: np.ndarray) -> np.ndarray:
    """The compaction key per ray in numpy: the octant if alive, else 8."""
    octant = ((state[3] > 0).astype(np.int8) + 2 * (state[4] > 0).astype(np.int8)
              + 4 * (state[5] > 0).astype(np.int8))
    return np.where(state[tkc.ROW_ALIVE] > 0, octant, 8).astype(np.int8)


def test_compaction_states_cover_each_case():
    """chip_smoke.compact_states, the card phase's inputs, run on the CPU:
    each state's list (the CPU wrapper, twice, and compact_plain) is the
    numpy stable order of its keys, and the states hold every case the
    card phase claims: N = 1, 31, 2047, 2049, one past the smallest block
    range and 2^24 - 1; every ray dead; every ray alive in one octant and
    in all eight; NaN, +0 and -0 directions."""
    seen = {}
    for name, state in chip_smoke.compact_states("cpu"):
        n = state.shape[1]
        idx, n_live = kw.compact(state)
        idx2, n_live2 = kw.compact(state)
        idx_p, n_live_p = ttw.compact_plain(state)
        m = int(n_live)
        keys = _keys(state.numpy())
        order = np.argsort(keys, kind="stable")
        assert m == int(n_live_p) == int((keys < 8).sum()), name
        np.testing.assert_array_equal(idx[:m].numpy(), order[:m], err_msg=name)
        assert torch.equal(idx, idx_p) and torch.equal(idx, idx2) and int(n_live2) == m
        d = state[3:6][:, state[tkc.ROW_ALIVE] > 0]
        seen[name] = dict(
            n=n, live=m, octants=set(np.unique(keys[keys < 8]).tolist()),
            nan=bool(torch.isnan(d).any()),
            pos_zero=bool(((d == 0) & ~torch.signbit(d)).any()),
            neg_zero=bool(((d == 0) & torch.signbit(d)).any()),
            dead_alive=state[tkc.ROW_ALIVE].numpy()[keys == 8])
        del state, idx, idx2, idx_p
    sizes = {v["n"] for k, v in seen.items() if k.startswith("mixed")}
    assert sizes >= {1, 31, 2047, 2049, chip_smoke.COMPACT_MIN_RANGE + 1,
                     chip_smoke.COMPACT_MAX_N}
    assert chip_smoke.COMPACT_MAX_N == 2**24 - 1
    dead = seen["every ray dead"]
    assert dead["live"] == 0 and dead["n"] > chip_smoke.COMPACT_MIN_RANGE
    a = dead["dead_alive"]  # alive 0, -0, negative and NaN all count as dead
    assert np.isnan(a).any() and (a < 0).any() and (a == 0).any()
    one = seen["every ray alive in one octant"]
    assert one["live"] == one["n"] and len(one["octants"]) == 1
    eight = seen["every ray alive in all eight octants"]
    assert eight["live"] == eight["n"] and eight["octants"] == set(range(8))
    zeros = seen["directions NaN, +0, -0"]
    assert zeros["live"] == zeros["n"] and zeros["nan"] and zeros["pos_zero"] and zeros["neg_zero"]
    big = seen[f"mixed N={chip_smoke.COMPACT_MAX_N}"]
    assert 0 < big["live"] < big["n"] and big["octants"] == set(range(8)) and big["nan"]


def _frame(name, effects):
    scene = (cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE) if name == "tiny"
             else cosig_tpu_torch.load_scene("scenes/demo_cornell.txt"))
    settings_ = cosig_tpu_torch.RenderSettings(resolution_override=(40, 28), max_depth=4,
                                               aa_samples=2)
    if effects:
        settings_ = settings_.replace(enable_soft_shadows=True, light_size=5.0,
                                      enable_glossy=True, surface_roughness=0.05)
    cset = cosig_tpu_torch.Renderer(device="cpu")._geometry_for(scene)[0]
    params = tsoa.frame_params(scene, settings_)
    cfg = tsoa.static_config(scene, settings_)
    return cset, tkc.build_uniforms(params), tkc.build_lights(params, cfg.multi_light), cfg


@pytest.mark.parametrize("effects", [False, True], ids=["plain", "soft+glossy"])
@pytest.mark.parametrize("name", ["tiny", "demo_cornell"])
def test_listed_bounce_bit_equal_to_self_skip(name, effects):
    """At every depth, the bounce on the compaction list equals the bounce
    on every column (dead rays included) bit for bit, with the same counted
    work; the last depth leaves no ray alive."""
    cset, uni, lights, cfg = _frame(name, effects)
    uni, lights, mats, prims, n_sph, n_box = ttw.frame_inputs(cset, uni, lights, 0, None, None,
                                                              (0, 0))
    pk = (prims, n_sph, n_box)
    state = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, *pk)
    lengths = []
    for depth in range(1, cfg.max_depth):
        listed = state.clone()
        idx, n_live = ttw.compact_plain(listed)
        tkc.reset_work()
        ttw.bounce_listed_stage(listed, idx, n_live, cset, uni, mats, lights, cfg, depth, *pk)
        work_listed = dict(tkc.WORK)
        tkc.reset_work()
        ttw.bounce_stage(state, cset, uni, mats, lights, cfg, depth, *pk)
        assert torch.equal(listed, state), depth
        assert work_listed == tkc.WORK
        lengths.append(int(n_live))
    assert 0 < lengths[0] < state.shape[1]
    assert not (state[tkc.ROW_ALIVE] > 0).any()


def test_listed_bounce_on_an_empty_list_changes_nothing():
    cset, uni, lights, cfg = _frame("tiny", False)
    uni, lights, mats, prims, n_sph, n_box = ttw.frame_inputs(cset, uni, lights, 0, None, None,
                                                              (0, 0))
    state = ttw.primary_stage(cset, uni, mats, lights, cfg, cfg.height, prims, n_sph, n_box)
    state[tkc.ROW_ALIVE] = 0.0
    before = state.clone()
    idx, n_live = kw.compact(state)
    assert int(n_live) == 0
    fb = binding.frame_buffer(cset.device, uni, mats, lights)
    kw.bounce(state, idx, n_live, cset, fb, cfg, 1, prims, n_sph, n_box)
    assert torch.equal(state, before)


def test_render_through_lists_matches_jax_wavefront(monkeypatch):
    """The whole wavefront render runs a compaction and a listed bounce per
    depth and still matches the JAX wavefront at test_torch_wavefront.py's
    tolerances; the CPU wrappers count no launch."""
    from __graft_entry__ import _tiny_scene

    st_ = cosig_tpu.RenderSettings(resolution_override=(32, 24), max_depth=3, aa_samples=2)
    scene = _tiny_scene()
    jcs = jcl.build_clusters(jsoa.compile_scene(scene))
    ref, jrays = jtw.render_wavefront(jcs, jsoa.frame_params(scene, st_),
                                      jsoa.static_config(scene, st_), interpret=True)
    ref = np.asarray(ref)
    cset = cluster_set_from_arrays(np.asarray(jcs.geom), np.asarray(jcs.aabb_t),
                                   np.asarray(jcs.sb_aabb_t), np.asarray(jcs.mats))
    port_scene = cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)
    port_st = cosig_tpu_torch.RenderSettings(**dataclasses.asdict(st_))
    params = tsoa.frame_params(port_scene, port_st)
    cfg = tsoa.static_config(port_scene, port_st)
    calls = {"compact": 0, "bounce": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ttw, "compact_plain", spy("compact", ttw.compact_plain))
    monkeypatch.setattr(ttw, "bounce_listed_stage", spy("bounce", ttw.bounce_listed_stage))
    binding.reset_counts()
    img, rays = ttw.render_wavefront(cset, tkc.build_uniforms(params),
                                     tkc.build_lights(params, cfg.multi_light), cfg)
    assert calls == {"compact": 2, "bounce": 2}
    assert not any(binding.LAUNCHES.values())
    img = img.numpy()
    assert float(np.sqrt(((img - ref) ** 2).mean())) < 1e-5
    assert np.abs(img - ref).max() < 1e-3
    assert abs(rays - float(jrays)) <= 8


def test_compact_variants_rewrite_the_kernel_constants():
    """The variant timer (kernels/variants.py, set ``compact``) finds the
    compaction kernel's three grid constants in wavefront.cu and replaces
    each, so its variants differ from the kernel only where they say."""
    import pathlib

    from cosig_tpu_torch.kernels import build as kbuild
    from cosig_tpu_torch.kernels import variants as cv

    text = (pathlib.Path(kbuild.CSRC_DIR) / "wavefront.cu").read_text()
    edits = [(name, value) for _, name, value in cv.VARIANTS["compact"]["1024x1-unroll8"]]
    out = cv.edit_text(text, edits)
    for line in ("constexpr int COMPACT_THREADS = 1024;", "constexpr int COMPACT_UNROLL = 8;",
                 "constexpr int COMPACT_MAX_PER_SM = 1;"):
        assert line in out
    assert "constexpr int COMPACT_THREADS = 512;" not in out
    assert out.count("\n") == text.count("\n")
    assert cv.edit_text(text, [("COMPACT_THREADS", 512), ("COMPACT_UNROLL", 4)]) == text
    assert all(f.endswith("wavefront.cu") for v in cv.VARIANTS["compact"].values()
               for f, _, _ in v)
    with pytest.raises(ValueError, match="does not define"):
        cv.edit_text(text.replace("constexpr int COMPACT_UNROLL = 4;", ""), [("COMPACT_UNROLL", 8)])
