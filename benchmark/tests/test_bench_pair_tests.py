"""The readers of the trace kernels' pair counters
(``trace_pair_tests_per_ray``, ``trace_pairs_pruned_pct``) on made-up
traced frames, and on frame records that carry no such counter, as a
program without it keeps."""

import collections
import dataclasses

import pytest

from benchmark.manifest import reader
from cosig_tpu_torch.utils import trace as port

PLAN = ("primary", "shade_all", "compact.1", "trace.1", "shade.1", "compact.2", "trace.2",
        "shade.2")


def _records():
    trace = {"frames": 2, "spans": [(0.0, 100.0), (110.0, 210.0)], "device": [],
             "host": [("cosig.frame", 0.0, 100.0), ("cosig.frame", 110.0, 210.0)]}
    return {"frames": 10, "window_s": 1.0, "frame_s": [0.1] * 10, "launches": {"graph": 10},
            "first_frame_s": 0.5, "trace": trace, "bound": None}


def _kept(monkeypatch, frames):
    monkeypatch.setattr(port, "_frames", collections.deque(frames))


def _frames():
    return [port.FrameRecord(1, PLAN, None, {1: 100, 2: 10}, pair_tests={1: (3000, 1000),
                                                                         2: (800, 200)}),
            port.FrameRecord(2, PLAN, None, {1: 200, 2: 20}, pair_tests={1: (4000, 4000),
                                                                         2: (1000, 1000)})]


def test_pairs_run_over_listed_rays_mean_a_frame(monkeypatch):
    _kept(monkeypatch, _frames())
    got = reader("trace_pair_tests_per_ray")(_records())
    assert got == pytest.approx((3800 / 110 + 5000 / 220) / 2)


def test_pruned_share_of_the_entered_pairs_mean_a_frame(monkeypatch):
    _kept(monkeypatch, _frames())
    got = reader("trace_pairs_pruned_pct")(_records())
    assert got == pytest.approx((100 * 1200 / 5000 + 100 * 5000 / 10000) / 2)


@dataclasses.dataclass
class _Parent:
    """A frame record of a program without the counter."""

    frame: int
    plan: tuple = PLAN
    capture: object = None
    live_rays: dict = dataclasses.field(default_factory=lambda: {1: 100})
    box_tests: dict = dataclasses.field(default_factory=lambda: {1: 4000})


@pytest.mark.parametrize("metric", ["trace_pair_tests_per_ray", "trace_pairs_pruned_pct"])
def test_nothing_without_the_counter(monkeypatch, metric):
    _kept(monkeypatch, [_Parent(1), _Parent(2)])
    assert reader(metric)(_records()) is None
    _kept(monkeypatch, [port.FrameRecord(1, PLAN), port.FrameRecord(2, PLAN)])
    assert reader(metric)(_records()) is None
    assert reader(metric)(dict(_records(), trace=None)) is None
