"""Whole frames past 2^24 camera rays in row bands of one frame
(``trace_wavefront.band_plan``, ``banded_frame``, the banded
``FrameGraph``): the plan, and the banded frame against the one-band
frame bit for bit and against the benchmark's plain reference, with the
cap (``trace_wavefront.MAX_RAYS``) set low so that a small frame takes
several bands. CPU tests run the kernels' plain versions; the
``gpu``-marked ones hold the Renderer's banded graph at 2048², AA 4 to
the sharded eager frame on the card:
``python -m pytest tests/test_torch_bands.py -m gpu --noconftest``."""

import gc
import pathlib
import random

import pytest
import torch

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models import soa as tsoa
from cosig_tpu_torch.ops import frame_graph
from cosig_tpu_torch.ops import kernel_core as tkc
from cosig_tpu_torch.ops import trace_wavefront as ttw
from cosig_tpu_torch.parallel import sharding as tsh
from cosig_tpu_torch.utils import trace

ROOT = pathlib.Path(__file__).resolve().parent.parent
FISSION_PLAN = ("primary", "shade_all", "compact.1", "trace.1", "shade.1", "compact.2", "trace.2",
                "shade.2")


def _tiny():
    return cosig_tpu_torch.parse_scene(chip_smoke.TINY_SCENE)


def _settings(**kw):
    return cosig_tpu_torch.RenderSettings(**{"resolution_override": (64, 64), "max_depth": 3,
                                             "aa_samples": 4, **kw})


def _cfg(width, height, aa, depth=4):
    return tsoa.StaticConfig(width=width, height=height, aa_samples=aa, max_depth=depth)


def _frame_inputs(scene, st, cset):
    params, cfg = tsoa.frame_params(scene, st), tsoa.static_config(scene, st)
    return cfg, tkc.build_uniforms(params), tkc.build_lights(params, cfg.multi_light)


@pytest.mark.parametrize("width,height,aa,want", [
    (2048, 2048, 4, ((0, 1024), (1024, 1024))),  # the upstream's AA 4 at 2048²: 2^24 rays
    (2048, 2048, 1, ((0, 2048),)),
    (1024, 1024, 4, ((0, 1024),)),
    (61, 37, 3, ((0, 37),)),  # under the cap: the whole frame, not a block multiple
    (4096, 2048, 4, ((0, 704), (704, 704), (1408, 640))),  # the last band cut at the image
    (2048, 1000, 16, ((0, 336), (336, 336), (672, 328))),
])
def test_band_plan_takes_the_fewest_bands_under_the_cap(width, height, aa, want):
    cfg = _cfg(width, height, aa)
    plan = ttw.band_plan(cfg)
    assert plan == want
    per_row = width * aa
    bh = tsh.primary_block(aa)[0]
    assert all(rows * per_row < ttw.MAX_RAYS for _, rows in plan)
    assert [off for off, _ in plan] == [sum(r for _, r in plan[:i]) for i in range(len(plan))]
    assert sum(rows for _, rows in plan) == height
    if len(plan) > 1:
        assert all(rows % bh == 0 for _, rows in plan[:-1])
        # One band fewer holds too many rays in its widest band.
        fewer = tsh.wavefront_band(cfg, len(plan) - 1)
        assert min(fewer, height) * per_row >= ttw.MAX_RAYS


def test_band_plan_raises_where_one_block_of_rows_is_past_the_cap(monkeypatch):
    monkeypatch.setattr(ttw, "MAX_RAYS", 1000)
    with pytest.raises(ValueError, match="f32-exact"):
        ttw.band_plan(_cfg(64, 64, 4))  # a block of 32 rows holds 8,192 rays
    assert ttw.band_plan(_cfg(4, 64, 1)) == ((0, 64),)


@pytest.mark.parametrize("fission", [True, False], ids=["fission", "fused"])
@pytest.mark.parametrize("height,cap,n_bands", [(64, 16384, 2), (96, 10000, 3)])
def test_banded_frame_equals_the_one_band_frame(monkeypatch, fission, height, cap, n_bands):
    """Both wavefront forms: the frame in 2 or 3 bands is the one-band
    frame bit for bit, image and rays, and its plan repeats the one-band
    plan band after band."""
    scene = _tiny()
    st = _settings(resolution_override=(64, height))
    cset, prims, counts = cosig_tpu_torch.Renderer(device="cpu")._geometry_for(scene)
    cfg, uni, lights = _frame_inputs(scene, st, cset)
    with trace.recording() as whole:
        one, rays_one = frame_graph.render_chain("wavefront", cset, uni, lights, cfg, 1, prims,
                                                 counts, fission=fission)
    monkeypatch.setattr(ttw, "MAX_RAYS", cap)
    assert len(ttw.band_plan(cfg)) == n_bands
    with trace.recording() as banded:
        img, rays = frame_graph.render_chain("wavefront", cset, uni, lights, cfg, 1, prims,
                                             counts, fission=fission)
    assert torch.equal(img, one) and rays == rays_one
    assert banded.labels == whole.labels * n_bands
    assert banded.plan_bands == [b for b in range(n_bands) for _ in whole.labels]


def test_renderer_renders_banded_frames(monkeypatch):
    """The Renderer's frames on the CPU (``render_to_device`` and
    ``render_chain``) take the plan's bands and equal its one-band frames."""
    r = cosig_tpu_torch.Renderer(device="cpu", backend="wavefront")
    scene, st = _tiny(), _settings()
    one = r.render_to_device(scene, st)
    rays_one = r.last_stats.rays_traced
    monkeypatch.setattr(ttw, "MAX_RAYS", 16384)
    assert r.render_to_device(scene, st).equal(one) and r.last_stats.rays_traced == rays_one
    img, rays = r.render_chain(scene, st, 2)
    assert img.equal(one) and rays == 2 * rays_one


def test_band_buffer_sets_the_band_row_offset():
    uni = tkc.build_uniforms(tsoa.frame_params(_tiny(), _settings()))
    fb = binding.frame_buffer("cpu", uni, torch.zeros(2, 8).numpy(), torch.zeros(1, 8).numpy())
    band = fb.band(32)
    band.copy()  # nothing to copy on the CPU
    assert band.uniforms[tkc.U_ROW_OFF] == 32.0 and fb.uniforms[tkc.U_ROW_OFF] == 0.0
    assert (band.uniforms[:tkc.U_ROW_OFF] == fb.uniforms[:tkc.U_ROW_OFF]).all()
    assert band.mats is fb.mats and band.lights is fb.lights and band.data is None
    assert binding.ROW_OFF_BYTES == 4 * tkc.U_ROW_OFF


def test_banded_frame_against_the_reference(monkeypatch):
    """large_mesh at 64², AA 4, depth 4 in two bands against the
    benchmark's plain reference, within the large_mesh cells' limits."""
    from benchmark import check, orbit
    from benchmark.manifest import Cell

    cell = Cell("large_mesh-aa4")
    kw = orbit.pose_settings(cell.config, cell.traffic)[3]
    kw.update(resolution_override=(64, 64))
    monkeypatch.setattr(ttw, "MAX_RAYS", 16384)
    scene = cosig_tpu_torch.load_scene(cell.scene_path())
    r = cosig_tpu_torch.Renderer(device="cpu", backend="wavefront")
    st = cosig_tpu_torch.RenderSettings(**kw)
    assert len(ttw.band_plan(tsoa.static_config(scene, st))) == 2
    img = r.render_to_device(scene, st)
    px, py = check.pick_pixels(random.Random(20), 64, 64, 1024)
    want, want_rays, _ = check.reference_pixels(cell.scene_path(), [kw], [(px, py)], "cpu")
    got = img[torch.as_tensor(py), torch.as_tensor(px)].numpy()
    numbers = check.numbers(got, want[0], (r.last_stats.rays_traced, want_rays[0], 64 * 64))
    for name, lim in cell.limits.items():
        assert numbers[name] <= lim["limit"], (name, numbers[name])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _large_mesh(aa):
    scene = cosig_tpu_torch.load_scene(str(ROOT / "benchmark" / "configs" / "large_mesh.txt"))
    return scene, cosig_tpu_torch.RenderSettings(resolution_override=(2048, 2048), max_depth=4,
                                                 aa_samples=aa)


@pytest.mark.gpu
def test_renderer_bands_equal_the_sharded_frame_on_card(card):
    """large_mesh at 2048², depth 4, AA 4 (2^24 camera rays): the Renderer
    captures two bands of 1,024 rows in one graph; a frame is one replay
    and one read, and equals ``render_sharded_wavefront`` over [card,
    card] bit for bit, image and rays."""
    r = cosig_tpu_torch.Renderer(device=card, backend="auto")
    scene, st = _large_mesh(4)
    r.render_to_device(scene, st)
    cap = r.last_capture
    assert cap.bands == ((0, 1024, 2 ** 23), (1024, 1024, 2 ** 23))
    assert cap.plan_bands == (0,) * 11 + (1,) * 11 and len(cap.plan) == 22
    assert cap.launches["graph"] == 1 and sum(cap.launches.values()) == 23
    # Memory freed since the capture, taken by new tensors: a replay
    # writes none of it (the graph holds its band buffers).
    gc.collect()
    held = [torch.full((64,), -1.0, device=card) for _ in range(512)]
    st = st.replace(camera_rotation_override=(-12.0, 0.0, 30.0))
    before = dict(binding.LAUNCHES)
    img = r.render_to_device(scene, st)
    assert {k: binding.LAUNCHES[k] - before[k] for k in before} == cap.launches
    assert r.last_capture is cap and all(bool((t == -1.0).all()) for t in held)
    cset = r._geometry_for(scene)[0]
    cfg, uni, lights = _frame_inputs(scene, st, cset)
    ref, rays = tsh.render_sharded_wavefront(cset, uni, lights, cfg, [card, card])
    assert torch.equal(img, ref) and r.last_stats.rays_traced == rays


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["tiny", "large_mesh"])
def test_one_band_frame_is_unchanged_on_card(card, which):
    """A frame under the cap: the graph key, plan, bands and launches of
    one band, as before bands (the tiny frame at 40x24, AA 2, depth 3;
    large_mesh at 2048², AA 1, the orbit cell's frame)."""
    r = cosig_tpu_torch.Renderer(device=card)
    if which == "tiny":
        scene, st = _tiny(), _settings(resolution_override=(40, 24), aa_samples=2)
        want = dict(primary_fission=1, shade=3, compact=2, trace=2, graph=1)
    else:
        scene, st = _large_mesh(1)
        want = dict(primary_fission=1, shade=4, compact=3, trace=3, graph=1)
    r.render_to_device(scene, st)
    cap = r.last_capture
    cfg = tsoa.static_config(scene, st)
    assert r.graph_key(scene, st) == (id(scene), False, "wavefront", cfg, "off", "fission")
    assert r._graph[2].plan == ((0, cfg.height),)
    assert cap.bands == ((0, cfg.height, cfg.height * cfg.width * cfg.aa_samples),)
    assert cap.plan_bands == (0,) * len(cap.plan)
    if which == "tiny":
        assert cap.plan == FISSION_PLAN
    assert {k: v for k, v in cap.launches.items() if v} == want
