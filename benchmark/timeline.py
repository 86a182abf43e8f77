"""torch.profiler's timeline of a traced stretch of frames, and the
sums the per-layer readers and the result's ``device`` fields take from
it.

``capture`` runs frames under the profiler (CPU and CUDA activity) with
each frame inside a ``bench.frame`` span of the benchmark's own, and
keeps three lists, times in microseconds on the profiler's clock:

* ``device``: (name, start, end) of every device activity (kernels,
  copies, sets), by start;
* ``spans``: (start, end) of each frame's ``bench.frame`` span, the host
  from the call into the renderer to its return;
* ``host``: (name, start, end) of every other host event (PyTorch
  operations and CUDA runtime calls; not the profiler's own step).

The profiler now and then returns a trace with no device activity at
all; such a trace is taken again (the port's ``chip_smoke.cuda_activity``
does the same).
"""

from __future__ import annotations

import bisect
import time

TRIES = 3
LOOK_BACK = 256  # host events searched back from a gap for the one open at it


def capture(frame, seconds: float, max_frames: int) -> dict:
    """Run ``frame()`` under torch.profiler for ``seconds`` or
    ``max_frames`` frames, after one untraced warm-up step -> the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    for _ in range(TRIES):
        out = {"device": [], "spans": [], "host": [], "frames": 0}

        def ready(prof):
            for e in prof.events():
                item = (e.time_range.start, e.time_range.end)
                if e.name == "bench.frame":
                    if e.device_type != DeviceType.CUDA:
                        out["spans"].append(item)
                elif e.name.startswith("ProfilerStep"):
                    continue
                elif e.device_type == DeviceType.CUDA:
                    out["device"].append((e.name, *item))
                else:
                    out["host"].append((e.name, *item))
            out["device"].sort(key=lambda a: a[1])
            out["spans"].sort()

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=ready) as prof:
            frame()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            while out["frames"] < max_frames and time.perf_counter() - t0 < seconds:
                with record_function("bench.frame"):
                    frame()
                out["frames"] += 1
            torch.cuda.synchronize()
            prof.step()
        if out["device"] and out["spans"]:
            return out
    raise RuntimeError(f"torch.profiler traced no device activity in {TRIES} traces")


def is_kernel(name: str) -> bool:
    """A kernel, as against a copy or a set."""
    return not name.startswith(("Memcpy", "Memset"))


def window(trace: dict) -> tuple:
    """(start, end) of the traced frames: the first span's start to the last's end."""
    return trace["spans"][0][0], trace["spans"][-1][1]


def busy_intervals(trace: dict) -> list:
    """The union of device activity inside the window, as merged (start, end)."""
    w0, w1 = window(trace)
    merged = []
    for _, s, e in trace["device"]:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def per_frame(trace: dict) -> list:
    """Each frame's device activities: those that start inside its span."""
    frames = [[] for _ in trace["spans"]]
    i = 0
    for act in trace["device"]:
        while i < len(frames) and act[1] >= trace["spans"][i][1]:
            i += 1
        if i == len(frames):
            break
        if act[1] >= trace["spans"][i][0]:
            frames[i].append(act)
    return frames


def idle_gaps(trace: dict) -> list:
    """(name, seconds) of each idle stretch of the device inside the
    window, named by what the host was doing at its middle: the innermost
    host event (a PyTorch operation or a CUDA runtime call) running then;
    else ``host: Python in render_to_device`` inside a frame's span, or
    ``host: between frames`` outside every span (the benchmark's loop)."""
    w0, w1 = window(trace)
    busy = busy_intervals(trace)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host = sorted(trace["host"], key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = []
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        name = None
        # The innermost open event is the latest-starting one still open;
        # a frame's events are few, so look back a bounded way.
        for h in reversed(host[max(0, bisect.bisect_right(starts, mid) - LOOK_BACK):
                               bisect.bisect_right(starts, mid)]):
            if mid < h[2]:
                name = h[0]
                break
        if name is None:
            j = bisect.bisect_right(trace["spans"], (mid, float("inf"))) - 1
            inside = j >= 0 and mid < trace["spans"][j][1]
            name = "host: Python in render_to_device" if inside else "host: between frames"
        gaps.append((name, (e - s) / 1e6))
    return gaps


def kernel_us(trace: dict) -> float:
    """Device time of the kernels that start inside the window, summed."""
    w0, w1 = window(trace)
    return sum(e - s for name, s, e in trace["device"] if is_kernel(name) and w0 <= s < w1)


def top(pairs, n: int = 10) -> list:
    """[[name, seconds], ...] of the n largest totals by name."""
    totals = {}
    for name, sec in pairs:
        totals[name] = totals.get(name, 0.0) + sec
    return [[k[:160], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]
