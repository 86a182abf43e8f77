"""``primary_pair_tests_per_ray``: the (ray, triangle) pairs that the port's
fission primary kernel runs in a traced frame (``FrameRecord.primary_tests``:
its closest hit's box tests, pairs run and pairs pruned, summed over the
bands) over the frame's camera rays (the camera rays of the replayed
graph's bands, ``Capture.bands``), mean over the traced frames. Motion blur
shakes every camera ray's origin, which widens each block's hull and the
clusters its rays enter. Layer: kernels. Moves ``frame_ms``. Nothing where
the program keeps no such counter: frame records without
``primary_tests``, or with none filled."""

from benchmark import program


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    per_ray = []
    for _, rec in program.frames(trace):
        tests = getattr(rec, "primary_tests", None)
        bands = getattr(rec.capture, "bands", None)
        if not tests or not bands:
            continue
        rays = sum(b[2] for b in bands)
        if rays > 0:
            per_ray.append(tests[1] / rays)
    if not per_ray:
        return None
    return sum(per_ray) / len(per_ray)
