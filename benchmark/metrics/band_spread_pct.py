"""``band_spread_pct``: how unequal a frame's equal-row bands are in
device time: for each traced frame, each band's time (the sum of its
kernels: the k-th ``cosig::`` kernel that starts inside the frame's
``cosig.frame`` span is the plan's k-th, and the capture's
``plan_bands`` gives its band), then 100 x (slowest - fastest) / mean,
mean over the frames; a frame whose count of kernels is not the plan's
is left out. Across cards the slowest band sets the frame. Layer:
kernels. Moves ``frame_ms``. Nothing where the program records no bands
of its plan."""

from benchmark import program


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    kernels = [(s, e) for n, s, e in trace["device"] if "cosig::" in n]
    spreads = []
    for (r0, r1), rec in program.frames(trace):
        bands = getattr(rec.capture, "plan_bands", None)
        mine = [(s, e) for s, e in kernels if r0 <= s < r1]
        if not bands or len(bands) != len(rec.plan) or len(mine) != len(rec.plan):
            continue
        per_band = {}
        for (s, e), band in zip(mine, bands):
            per_band[band] = per_band.get(band, 0.0) + (e - s)
        times = list(per_band.values())
        mean = sum(times) / len(times)
        if mean > 0:
            spreads.append(100.0 * (max(times) - min(times)) / mean)
    if not spreads:
        return None
    return sum(spreads) / len(spreads)
