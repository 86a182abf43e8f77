"""``trace_pair_tests_per_ray``: the (ray, triangle) pairs that the port's
trace kernels run in a traced frame (``FrameRecord.pair_tests``: pairs run
and pairs pruned by the compacted closest hit at each depth, summed over
the bands) over the rays the compactions listed for those depths
(``live_rays``), mean over the traced frames. Layer: kernels. Moves
``frame_ms``. Nothing where the program keeps no such counter: frame
records without ``pair_tests``, or with none filled."""

from benchmark import program


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    per_ray = []
    for _, rec in program.frames(trace):
        pairs = getattr(rec, "pair_tests", None)
        if not pairs:
            continue
        rays = sum(rec.live_rays.get(d, 0) for d in pairs)
        if rays > 0:
            per_ray.append(sum(run for run, _ in pairs.values()) / rays)
    if not per_ray:
        return None
    return sum(per_ray) / len(per_ray)
