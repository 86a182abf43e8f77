"""The reader of the trace kernels' box test counter
(``trace_box_tests_per_ray``) on made-up traced frames, and on frame
records that carry no such counter, as a program without it keeps."""

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


def test_box_tests_over_listed_rays_mean_a_frame(monkeypatch):
    frames = [port.FrameRecord(1, PLAN, None, {1: 100, 2: 10}, box_tests={1: 7000, 2: 2000}),
              port.FrameRecord(2, PLAN, None, {1: 100, 2: 10}, box_tests={1: 7000, 2: 2000}),
              port.FrameRecord(3, PLAN, None, {1: 200, 2: 20}, box_tests={1: 12000, 2: 4000})]
    _kept(monkeypatch, frames)
    got = reader("trace_box_tests_per_ray")(_records())
    assert got == pytest.approx((9000 / 110 + 16000 / 220) / 2)


@dataclasses.dataclass
class _Parent:
    """A frame record of a program without the counter."""

    frame: int
    plan: tuple = PLAN
    capture: object = None
    live_rays: dict = dataclasses.field(default_factory=lambda: {1: 100})


def test_nothing_without_the_counter(monkeypatch):
    _kept(monkeypatch, [_Parent(1), _Parent(2)])
    assert reader("trace_box_tests_per_ray")(_records()) is None
    _kept(monkeypatch, [port.FrameRecord(1, PLAN), port.FrameRecord(2, PLAN)])
    assert reader("trace_box_tests_per_ray")(_records()) is None
    assert reader("trace_box_tests_per_ray")(dict(_records(), trace=None)) is None
