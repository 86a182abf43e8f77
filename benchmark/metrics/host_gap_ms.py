"""``host_gap_ms``: the device's idle time from the end of one frame's
last device activity to the start of the next frame's first, averaged
over the traced frames (torch.profiler's timeline; a frame's activities
are those that start inside its span). The host's part of a frame:
packing the frame's uniforms, the copy, the replay, the one read. Layer:
frame host path. Moves ``frame_ms``."""

from benchmark import timeline


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    frames = timeline.per_frame(trace)
    gaps = [nxt[0][1] - max(a[2] for a in cur)
            for cur, nxt in zip(frames, frames[1:]) if cur and nxt]
    if not gaps:
        return None
    return sum(gaps) / len(gaps) / 1e3
