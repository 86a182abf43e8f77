"""``device_idle_pct``: the share of the traced window (from the first
traced frame's call to the last one's return) in which no device
activity ran, in percent (torch.profiler's timeline). Layer: device.
Moves ``frame_ms``."""

from benchmark import timeline


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    w0, w1 = timeline.window(trace)
    busy = sum(e - s for s, e in timeline.busy_intervals(trace))
    return 100.0 * (1.0 - busy / (w1 - w0))
