"""The readers of the port's own spans and records on a made-up trace:
two frames, each the port's ``cosig.frame`` span with its steps, a copy
in, three port kernels, finalize and the copies out, and the frame
records and capture record that ``cosig_tpu_torch.utils.trace`` keeps."""

import collections

import pytest

from benchmark import program, timeline
from benchmark.manifest import reader
from cosig_tpu_torch.utils import trace as port

STEPS = [("cosig.frame.settings", 1, 10), ("cosig.frame.uniforms", 10, 12),
         ("cosig.frame.lookup", 12, 14), ("cosig.frame.write", 14, 20),
         ("cosig.frame.launch", 20, 30), ("cosig.frame.copy_out", 30, 32),
         ("cosig.frame.wait", 32, 98)]
ACTS = [("Memcpy HtoD", 18, 19), ("void cosig::primary_kernel<false>", 25, 50),
        ("cosig::compact_kernel(float const*)", 52, 53),
        ("void cosig::bounce_kernel<false>", 55, 80), ("at::native::reduce_kernel", 81, 85),
        ("Memcpy DtoD", 86, 87), ("Memcpy DtoH", 95, 96)]
PLAN = ("primary", "compact.1", "bounce.1")
CAPTURE = port.Capture(1, "wavefront", PLAN, {"cosig.setup.geometry": 0.1,
                                              "cosig.setup.kernels": 0.5,
                                              "cosig.setup.warmup": 0.7,
                                              "cosig.setup.capture": 0.25},
                       {"cosig.setup.kernels": "cosig.setup.warmup"}, 4096, {"graph": 1})


def _frame(t0):
    host = [("cosig.frame", t0, t0 + 100)] + [(n, t0 + s, t0 + e) for n, s, e in STEPS]
    return host, [(n, t0 + s, t0 + e) for n, s, e in ACTS]


def _trace(extra_kernel=False):
    (h1, d1), (h2, d2) = _frame(0.0), _frame(110.0)
    if extra_kernel:
        d2 = d2 + [("void cosig::bounce_kernel<false>", 190.0, 191.0)]
    return {"frames": 2, "spans": [(0.0, 100.0), (110.0, 210.0)],
            "device": sorted(d1 + d2, key=lambda a: a[1]),
            "host": h1 + h2 + [("cudaGraphLaunch", 21.0, 22.0), ("cudaGraphLaunch", 131.0, 132.0)]}


def _records(trace):
    return {"frames": 10, "window_s": 1.0, "frame_s": [0.1] * 10, "launches": {"graph": 10},
            "first_frame_s": 0.5, "trace": trace, "bound": None}


@pytest.fixture
def kept(monkeypatch):
    """The port's newest frame records: an older frame, then the two traced."""
    frames = [port.FrameRecord(n, PLAN, CAPTURE, {1: 1000}) for n in (1, 2, 3)]
    monkeypatch.setattr(port, "_frames", collections.deque(frames))
    return frames


def read(name, trace):
    return reader(name)(_records(trace))


def test_program_readers(kept):
    trace = _trace()
    assert read("host_prep_ms", trace) == pytest.approx(20 / 1e3)
    assert read("host_prep_ms.preview", trace) == pytest.approx(20 / 1e3)
    # The wait 32..98 (66 us) holds 50 us of device activity.
    assert read("wait_idle_ms", trace) == pytest.approx(16 / 1e3)
    # The compaction (1 us) and the bounce (25 us) over 1000 listed rays.
    assert read("bounce_ns_per_ray", trace) == pytest.approx(26.0)
    assert read("capture_ms", trace) == pytest.approx(250.0)
    assert read("geometry_ms", trace) == pytest.approx(100.0)
    assert [rec.frame for _, rec in program.frames(trace)] == [2, 3]


def test_a_frame_off_its_plan_is_left_out(kept):
    kept[-1].live_rays = {1: 2000}
    assert read("bounce_ns_per_ray", _trace()) == pytest.approx((26.0 + 13.0) / 2)
    # The second frame shows a kernel more than its plan: only the first counts.
    assert read("bounce_ns_per_ray", _trace(extra_kernel=True)) == pytest.approx(26.0)


def test_program_readers_without_the_programs_records(monkeypatch):
    """A program that keeps no records (or a trace without its spans)
    gives nothing, and nothing raises."""
    monkeypatch.setattr(port, "_frames", collections.deque())
    for name in ("bounce_ns_per_ray", "capture_ms", "geometry_ms"):
        assert read(name, _trace()) is None, name
    bare = dict(_trace(), host=[("cudaGraphLaunch", 21.0, 22.0)])
    for name in ("host_prep_ms", "wait_idle_ms", "bounce_ns_per_ray", "capture_ms",
                 "geometry_ms"):
        assert read(name, bare) is None, name
        assert read(name, None) is None, name


def test_idle_gaps_take_the_frames_steps_as_names():
    gaps = dict(timeline.top(timeline.idle_gaps(_trace())))
    # 0..18 and 96..128: a frame's settings open at each middle (9, 112).
    assert gaps["cosig.frame.settings"] == pytest.approx((18 + 32) * 1e-6)
    assert "host: Python in render_to_device" not in gaps


def test_overlap_and_depth():
    busy = [[0.0, 10.0], [20.0, 30.0], [40.0, 50.0]]
    assert program.overlap(busy, 5.0, 45.0) == 5.0 + 10.0 + 5.0
    assert program.overlap(busy, 10.0, 20.0) == 0.0
    assert [program.depth(x) for x in ("primary", "shade_all", "compact.1", "shade.12")] == \
        [0, 0, 1, 12]
