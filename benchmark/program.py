"""What the port records of itself, for the per-layer readers: its spans
in a traced stretch (``cosig.*`` ranges among torch.profiler's host
events, on the clock of the device activity) and the records that
``cosig_tpu_torch.utils.trace`` keeps (a frame's plan of kernels and its
live rays, a capture's set-up steps). A program that records none of
them gives nothing here, and its readers report nothing."""

from __future__ import annotations

import bisect

from benchmark import timeline


def spans(trace: dict, name: str) -> list:
    """(start, end) of the program's spans ``name`` that start inside the
    traced window, by start."""
    w0, w1 = timeline.window(trace)
    return sorted((s, e) for n, s, e in trace["host"] if n == name and w0 <= s < w1)


def frames(trace: dict) -> list:
    """[((start, end) of a traced frame's ``cosig.frame`` span, its frame
    record)]: the window's frame spans in order beside the program's
    newest frame records; [] where the program keeps no such records."""
    try:
        from cosig_tpu_torch.utils import trace as port
    except ImportError:
        return []
    roots = spans(trace, "cosig.frame")
    records = port.frames()
    if not roots or len(records) < len(roots):
        return []
    return list(zip(roots, records[-len(roots):]))


def capture(trace: dict):
    """The capture record of the graph the traced frames replayed, or None."""
    found = frames(trace)
    return found[-1][1].capture if found else None


def overlap(intervals: list, start: float, end: float) -> float:
    """How much of (start, end) the merged, sorted ``intervals`` cover."""
    i = max(0, bisect.bisect_right(intervals, [start]) - 1)
    covered = 0.0
    for s, e in intervals[i:]:
        if s >= end:
            break
        covered += max(0.0, min(e, end) - max(s, start))
    return covered


def depth(label: str) -> int:
    """The depth of a plan label: ``bounce.2`` -> 2, ``primary`` -> 0."""
    _, _, tail = label.rpartition(".")
    return int(tail) if tail.isdigit() else 0
