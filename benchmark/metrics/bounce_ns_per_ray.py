"""``bounce_ns_per_ray``: the device time of a frame's kernels past the
primary stage (those whose label in the frame's plan has depth >= 1:
the compactions and the bounce, or trace and shade, kernels) over the
rays the compactions listed for depths >= 1 (``live_rays``), in ns,
mean over the traced frames. The k-th ``cosig::`` kernel that starts
inside a frame's ``cosig.frame`` span is the plan's k-th; a frame whose
count of them is not the plan's is left out. Layer: kernels. Moves
``frame_ms``. Nothing where the program keeps no plan or live rays."""

from benchmark import program


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    kernels = [(s, e) for n, s, e in trace["device"] if "cosig::" in n]
    per_ray = []
    for (r0, r1), rec in program.frames(trace):
        mine = [(s, e) for s, e in kernels if r0 <= s < r1]
        rays = sum(n for d, n in rec.live_rays.items() if d >= 1)
        if len(mine) != len(rec.plan) or rays <= 0:
            continue
        us = sum(e - s for (s, e), label in zip(mine, rec.plan) if program.depth(label) >= 1)
        per_ray.append(us * 1e3 / rays)
    if not per_ray:
        return None
    return sum(per_ray) / len(per_ray)
