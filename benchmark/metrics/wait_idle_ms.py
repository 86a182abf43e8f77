"""``wait_idle_ms``: the device's idle time inside each frame's
``cosig.frame.wait`` span (the host only waits for the frame's one
read), mean over the traced frames (torch.profiler's timeline): gaps
the frame's graph leaves between its device work, or the profiler adds.
Layer: device. Moves ``frame_ms``. Nothing where the program has no
such spans."""

from benchmark import program, timeline


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    waits = program.spans(trace, "cosig.frame.wait")
    if not waits:
        return None
    busy = timeline.busy_intervals(trace)
    idle = sum((e - s) - program.overlap(busy, s, e) for s, e in waits)
    return idle / len(waits) / 1e3
