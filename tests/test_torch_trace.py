"""The port's spans and counters (``cosig_tpu_torch.utils.trace``): off
they open no profiler range and keep no frame record; under
torch.profiler a frame's steps are ranges nested in its ``cosig.frame``;
set-up steps, the capture count, the plan of a frame's kernels and the
live rays per depth. CPU tests run the kernels' plain versions; the
``gpu``-marked ones hold the spans to the card's own activity:
``python -m pytest tests/test_torch_trace.py -m gpu --noconftest``."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import frame_graph
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_megakernel as ttm
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.utils import trace

FRAME_STEPS = ("settings", "lookup", "uniforms", "write", "launch", "copy_out", "wait")
FISSION_PLAN = ("primary", "shade_all", "compact.1", "trace.1", "shade.1", "compact.2", "trace.2",
                "shade.2")


def _tiny():
    return cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)


def _settings(**kw):
    return cosig_tpu_torch.RenderSettings(**{"resolution_override": (16, 12), "max_depth": 3,
                                             **kw})


def _cosig_events(prof):
    """(name, start, end) of the ``cosig.*`` ranges on the host, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("cosig.") and e.device_type.name == "CPU"),
                  key=lambda x: x[1])


def test_spans_off_open_no_range_and_keep_no_record(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened with tracing off")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    assert not trace.on()
    assert trace.span("cosig.frame.settings") is trace.span("cosig.frame.wait")  # one shared object
    r = cosig_tpu_torch.Renderer(device="cpu")
    before = len(trace.frames())
    r.render_to_device(_tiny(), _settings())  # builds the geometry too: a set-up span
    r.render_to_device(_tiny(), _settings(camera_fov_override=40.0))
    assert len(trace.frames()) == before


def test_frame_spans_nest_in_order_under_the_profiler():
    r = cosig_tpu_torch.Renderer(device="cpu")
    scene, st = _tiny(), _settings()
    r.render_to_device(scene, st)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_to_device(scene, st)
    events = _cosig_events(prof)
    roots = [e for e in events if e[0] == "cosig.frame"]
    assert len(roots) == 1
    _, r0, r1 = roots[0]
    children = [e for e in events if e[0].startswith("cosig.frame.")]
    names = [n.rsplit(".", 1)[1] for n, _, _ in children]
    # The CPU path has no graph and no output copies: the stages run plain.
    assert names == [s for s in FRAME_STEPS if s != "copy_out"]
    for (_, s, e), (_, s2, _) in zip(children, children[1:] + [("", r1, r1)]):
        assert r0 <= s <= e <= s2 <= r1
    rec = trace.frames()[-1]
    # The Renderer's wavefront form with the exact pair test: fission.
    assert rec.capture is None and rec.plan == FISSION_PLAN


def test_first_frame_records_the_geometry_and_no_capture(monkeypatch):
    """The CPU path has no graph: its first frame times the geometry (the
    kernels, warm-up and capture are the card's) and counts no capture."""
    monkeypatch.setattr(trace, "_pending", {})
    captures = trace.COUNTS["captures"]
    r = cosig_tpu_torch.Renderer(device="cpu")
    r.render_to_device(_tiny(), _settings())
    steps = trace.pending_setup()
    assert steps["cosig.setup.geometry"] > 0
    assert "cosig.setup.capture" not in steps and "cosig.setup.warmup" not in steps
    assert trace.COUNTS["captures"] == captures and r.last_capture is None


@pytest.mark.parametrize("kw", [dict(max_depth=4), dict(max_depth=3, aa_samples=2)])
def test_live_rays_fall_with_depth(kw):
    r = cosig_tpu_torch.Renderer(device="cpu")
    scene, st = _tiny(), _settings(**kw)
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_to_device(scene, st)
    live = trace.frames()[-1].live_rays
    rays = 16 * 12 * max(1, st.aa_samples)
    assert list(live) == list(range(1, st.max_depth))
    counts = list(live.values())
    assert counts == sorted(counts, reverse=True) and 0 < counts[0] <= rays
    assert sum(counts) <= r.last_stats.rays_traced


@pytest.mark.parametrize("form", ["fused", "fission", "megakernel", "debug"])
def test_plan_names_each_kernel_by_stage_and_depth(form):
    scene = _tiny()
    st = _settings(max_depth=3, debug_mode=1 if form == "debug" else 0)
    cfg = tsoa.static_config(scene, st)
    params = tsoa.frame_params(scene, st)
    cset = cosig_tpu_torch.Renderer(device="cpu")._geometry_for(scene)[0]
    args = (cset, tkc.build_uniforms(params), tkc.build_lights(params, False), cfg)
    with trace.recording() as plan:
        if form in ("fused", "fission"):
            ttw.render_wavefront(*args, fission=form == "fission")
        elif form == "megakernel":
            ttm.render_clusters(*args)
        else:
            ttm.render_debug(*args)
    want = {"fused": ["primary", "compact.1", "bounce.1", "compact.2", "bounce.2"],
            "fission": ["primary", "shade_all", "compact.1", "trace.1", "shade.1", "compact.2",
                        "trace.2", "shade.2"],
            "megakernel": ["megakernel"], "debug": ["debug"]}[form]
    assert plan.labels == want
    assert [d for d, _ in plan.n_live] == ([1, 2] if form in ("fused", "fission") else [])


def test_live_tensor_reads_one_buffer():
    lives = torch.tensor([5, 3, 1], dtype=torch.int32)
    view = trace.live_tensor([(d, lives[d - 1:d]) for d in (1, 2, 3)])
    assert view.tolist() == [5, 3, 1]
    lives[1] = 2  # a view: what the kernels write later is read
    assert view.tolist() == [5, 2, 1]
    apart = [(d, torch.tensor([d], dtype=torch.int32)) for d in (1, 2)]
    assert trace.live_tensor(apart) is None and trace.live_tensor([]) is None


def test_banded_frame_records_live_rays_by_band_and_depth(monkeypatch):
    """An eager traced frame in two bands (the cap set low): its plan
    repeats the one-band plan, ``band_live`` keys each list by (band,
    depth) and ``live_rays`` sums the bands by depth, the one-band
    frame's live rays."""
    r = cosig_tpu_torch.Renderer(device="cpu")
    scene, st = _tiny(), _settings(resolution_override=(64, 64), aa_samples=4)
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_to_device(scene, st)
        one = trace.frames()[-1]
        monkeypatch.setattr(ttw, "MAX_RAYS", 16384)
        r.render_to_device(scene, st)
        two = trace.frames()[-1]
    assert one.band_live == {(0, d): n for d, n in one.live_rays.items()}
    assert two.plan == FISSION_PLAN * 2
    assert set(two.band_live) == {(b, d) for b in (0, 1) for d in (1, 2)}
    assert two.live_rays == one.live_rays == {
        d: two.band_live[0, d] + two.band_live[1, d] for d in (1, 2)}


def test_capture_records_bands_and_a_replay_keys_live_rays_by_depth(monkeypatch):
    """A capture record's ``bands`` and ``plan_bands``; a replayed frame
    reads its list lengths (one buffer, band after band) into ``band_live``
    by (band, depth) and ``live_rays`` by depth, summed over the bands,
    not by their order in the buffer."""
    monkeypatch.setattr(trace, "_pending", {})
    monkeypatch.setattr(trace, "COUNTS", {"captures": 0, "frame_inputs_built": 0})
    monkeypatch.setattr(trace, "_last_capture", None)
    monkeypatch.setattr(trace, "_frames", trace.collections.deque(maxlen=trace.FRAMES_KEPT))
    monkeypatch.setattr(ttw, "MAX_RAYS", 16384)
    scene, st = _tiny(), _settings(resolution_override=(64, 64), aa_samples=4)
    cfg = tsoa.static_config(scene, st)
    params = tsoa.frame_params(scene, st)
    cset, prims, counts = cosig_tpu_torch.Renderer(device="cpu")._geometry_for(scene)
    plan_bands = ttw.band_plan(cfg)
    assert plan_bands == ((0, 32), (32, 32))
    with trace.recording() as plan:
        frame_graph.render_chain("wavefront", cset, tkc.build_uniforms(params),
                                 tkc.build_lights(params, False), cfg, 1, prims, counts,
                                 fission=True)
    bands = [(off, n, n * 64 * 4) for off, n in plan_bands]
    cap = trace.captured("wavefront", plan, 0, {"graph": 1}, "fission", bands)
    assert cap.bands == ((0, 32, 8192), (32, 32, 8192))
    assert cap.plan == FISSION_PLAN * 2 and cap.plan_bands == (0,) * 8 + (1,) * 8
    lives = torch.tensor([50, 7, 40, 3], dtype=torch.int32)
    assert trace.live_tensor([(d, lives[i:i + 1]) for i, d in enumerate((1, 2, 1, 2))]).tolist() \
        == [50, 7, 40, 3]
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.frame() as fr:
            fr.replayed(cap, lives)
    rec = trace.frames()[-1]
    assert rec.band_live == {(0, 1): 50, (0, 2): 7, (1, 1): 40, (1, 2): 3}
    assert rec.live_rays == {1: 90, 2: 10}


def test_setup_spans_time_their_step_and_its_parent(monkeypatch):
    monkeypatch.setattr(trace, "_pending", {})
    monkeypatch.setattr(trace, "_parents", {})
    with trace.setup("cosig.setup.warmup") as outer:
        with trace.setup("cosig.setup.kernels") as inner:
            pass
    steps = trace.pending_setup()
    assert steps["cosig.setup.warmup"] == outer.seconds >= inner.seconds
    assert trace._parents["cosig.setup.kernels"] == "cosig.setup.warmup"
    assert trace._parents["cosig.setup.warmup"] is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.setup("cosig.setup.geometry"):
            pass
    assert [n for n, _, _ in _cosig_events(prof)] == ["cosig.setup.geometry"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
def test_setup_and_captures_on_card(card):
    """The first frame records the four set-up steps and one capture; a
    camera change replays it, a resolution change captures again."""
    binding.library.cache_clear()  # load the library again: its set-up step
    r = cosig_tpu_torch.Renderer(device=card)
    scene = _tiny()
    captures = trace.COUNTS["captures"]
    r.render_to_device(scene, _settings())
    cap = r.last_capture
    assert cap is trace.last_capture() and cap.index == captures + 1
    assert set(cap.steps) == {"cosig.setup.geometry", "cosig.setup.kernels",
                              "cosig.setup.warmup", "cosig.setup.capture"}
    assert all(v > 0 for v in cap.steps.values())
    assert cap.parents["cosig.setup.kernels"] == "cosig.setup.warmup"
    assert r._graph[2].capture_s == cap.steps["cosig.setup.capture"] and cap.pool_bytes > 0
    assert cap.form == "fission" and cap.plan == FISSION_PLAN
    r.render_to_device(scene, _settings(camera_rotation_override=(0.0, 0.0, 20.0)))
    assert trace.COUNTS["captures"] == captures + 1 and r.last_capture is cap
    r.render_to_device(scene, _settings(resolution_override=(24, 16)))
    assert trace.COUNTS["captures"] == captures + 2
    # The geometry was cached: the new capture carries its scene's step.
    assert r.last_capture.steps["cosig.setup.geometry"] == cap.steps["cosig.setup.geometry"]


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(), dict(aa_samples=2, max_depth=4)])
def test_spans_hold_the_frames_device_work_on_card(card, kw):
    """Each traced frame's device activities lie inside its ``cosig.frame``,
    its copy to the card starts inside ``cosig.frame.write`` and its first
    port kernel after ``cosig.frame.launch`` starts (the clocks agree); its
    ``cosig::`` kernels are as many as the plan, and its live rays those of
    the eager frame."""
    r = cosig_tpu_torch.Renderer(device=card)
    scene, st = _tiny(), _settings(resolution_override=(40, 24), **kw)
    r.render_to_device(scene, st)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            r.render_to_device(scene, st.replace(camera_rotation_override=(0.0, 0.0, 10.0 * i)))
        torch.cuda.synchronize()
    host = _cosig_events(prof)
    device = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type.name == "CUDA"), key=lambda x: x[1])
    roots = [(s, e) for n, s, e in host if n == "cosig.frame"]
    assert len(roots) == 3 and device
    records = trace.frames()[-3:]
    plan = r.last_capture.plan
    for (r0, r1), rec in zip(roots, records):
        acts = [a for a in device if r0 <= a[1] < r1]
        assert acts and all(a[2] <= r1 for a in acts)

        def inside(name):
            return [(s, e) for n, s, e in host if n == name and r0 <= s < r1]

        (w0, w1), = inside("cosig.frame.write")
        (l0, _), = inside("cosig.frame.launch")
        to_card = [a for a in acts if "HtoD" in a[0]]
        assert to_card and w0 <= to_card[0][1] <= w1
        kernels = [a for a in acts if "cosig::" in a[0]]
        assert len(kernels) == len(plan) and kernels[0][1] >= l0
        assert rec.plan == plan and rec.capture is r.last_capture
    # The live rays of the last traced frame, against the eager frame's.
    last = st.replace(camera_rotation_override=(0.0, 0.0, 20.0))
    params, cfg = tsoa.frame_params(scene, last), tsoa.static_config(scene, last)
    cset = r._geometry_for(scene)[0]
    with trace.recording() as eager:
        ttw.render_wavefront(cset, tkc.build_uniforms(params), tkc.build_lights(params, False),
                             cfg)
    want = {d: int(n.item()) for d, n in eager.n_live}
    assert records[-1].live_rays == want and list(want) == list(range(1, cfg.max_depth))


@pytest.mark.gpu
def test_renderer_replays_the_fission_form_on_card(card):
    """The Renderer's wavefront graph is the fission form: over four orbit
    poses each replay equals a fused FrameGraph of the same key bit for
    bit, image and rays; its capture record names the form, its plan and
    launches the fission kernels and no bounce, and the camera moves
    capture nothing."""
    r = cosig_tpu_torch.Renderer(device=card)
    scene, st = _tiny(), _settings(resolution_override=(40, 24), aa_samples=2)
    r.render_to_device(scene, st)
    cap, captures = r.last_capture, trace.COUNTS["captures"]
    assert r.graph_key(scene, st)[4:] == ("off", "fission")
    assert cap.form == "fission" and cap.plan == FISSION_PLAN
    assert {k: v for k, v in cap.launches.items() if v} == dict(
        primary_fission=1, shade=3, compact=2, trace=2, graph=1)
    cset, prims, counts = r._geometry_for(scene)
    fused = None
    for i in range(4):
        st_i = st.replace(camera_rotation_override=(0.0, 0.0, 10.0 * i))
        img = r.render_to_device(scene, st_i)
        params, cfg = tsoa.frame_params(scene, st_i), tsoa.static_config(scene, st_i)
        uni, lights = tkc.build_uniforms(params), tkc.build_lights(params, cfg.multi_light)
        if fused is None:
            fused = frame_graph.FrameGraph("wavefront", cset, cfg, uni, lights, prims, counts,
                                           fission=False)
        ref, rays = fused.replay(uni, lights)
        assert torch.equal(img, ref) and r.last_stats.rays_traced == int(rays)
    assert fused.capture.form == "fused" and "bounce.1" in fused.capture.plan
    # The fused graph's capture is the one more: the renderer's frames made none.
    assert trace.COUNTS["captures"] == captures + 1 and r.last_capture is cap
