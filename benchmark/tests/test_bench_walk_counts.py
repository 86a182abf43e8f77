"""The readers of the fission primary's and the shade kernels' counters
(``primary_pair_tests_per_ray``, ``shadow_box_tests_per_ray``,
``shadow_pair_tests_per_ray``) on made-up traced frames, and on frame
records that carry no such counter, as a program without them keeps."""

import collections
import dataclasses

import pytest

from benchmark.manifest import reader
from cosig_tpu_torch.utils import trace as port

PLAN = ("primary", "shade_all", "compact.1", "trace.1", "shade.1")
METRICS = ("primary_pair_tests_per_ray", "shadow_box_tests_per_ray", "shadow_pair_tests_per_ray")


def _records():
    trace = {"frames": 2, "spans": [(0.0, 100.0), (110.0, 210.0)], "device": [],
             "host": [("cosig.frame", 0.0, 100.0), ("cosig.frame", 110.0, 210.0)]}
    return {"frames": 10, "window_s": 1.0, "frame_s": [0.1] * 10, "launches": {"graph": 10},
            "first_frame_s": 0.5, "trace": trace, "bound": None}


def _kept(monkeypatch, frames):
    monkeypatch.setattr(port, "_frames", collections.deque(frames))


def _frames():
    # Two bands of 500 and 300 camera rays.
    cap = port.Capture(1, "wavefront", PLAN * 2, {}, {}, bands=((0, 5, 500), (5, 3, 300)))
    return [port.FrameRecord(1, PLAN, cap, {1: 100}, primary_tests=(9000, 4000, 800),
                             shadow_tests={0: (6000, 3000, 400), 1: (900, 500, 100)}),
            port.FrameRecord(2, PLAN, cap, {1: 200}, primary_tests=(8000, 2400, 0),
                             shadow_tests={0: (5000, 2000, 500), 1: (700, 100, 0)})]


@pytest.mark.parametrize("metric,want", [
    ("primary_pair_tests_per_ray", (4000 / 800 + 2400 / 800) / 2),
    ("shadow_box_tests_per_ray", (6900 / 500 + 5700 / 500) / 2),
    ("shadow_pair_tests_per_ray", (3500 / 500 + 2100 / 500) / 2),
])
def test_counts_per_ray_mean_a_frame(monkeypatch, metric, want):
    _kept(monkeypatch, _frames())
    assert reader(metric)(_records()) == pytest.approx(want)


@dataclasses.dataclass
class _Parent:
    """A frame record of a program without the counters."""

    frame: int
    plan: tuple = PLAN
    capture: object = None
    live_rays: dict = dataclasses.field(default_factory=lambda: {1: 100})
    box_tests: dict = dataclasses.field(default_factory=lambda: {1: 4000})
    pair_tests: dict = dataclasses.field(default_factory=lambda: {1: (900, 100)})


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_without_the_counters(monkeypatch, metric):
    _kept(monkeypatch, [_Parent(1), _Parent(2)])
    assert reader(metric)(_records()) is None
    _kept(monkeypatch, [port.FrameRecord(1, PLAN), port.FrameRecord(2, PLAN)])
    assert reader(metric)(_records()) is None
    assert reader(metric)(dict(_records(), trace=None)) is None
