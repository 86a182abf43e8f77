"""``trace_box_tests_per_ray``: the box tests that the port's trace kernels
run in a traced frame (``FrameRecord.box_tests``: a group's union box and a
cluster's box, each once per listed ray of the warp that runs it, summed
over the depths) over the rays the compactions listed for those depths
(``live_rays``), mean over the traced frames. A cull that tests every box
reads the scene's cluster count (221 at large_mesh, 82 at glass_sphere).
Layer: kernels. Moves ``frame_ms``. Nothing where the program keeps no such
counter: frame records without ``box_tests``, or with none filled."""

from benchmark import program


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    per_ray = []
    for _, rec in program.frames(trace):
        tests = getattr(rec, "box_tests", None)
        if not tests:
            continue
        rays = sum(rec.live_rays.get(d, 0) for d in tests)
        if rays > 0:
            per_ray.append(sum(tests.values()) / rays)
    if not per_ray:
        return None
    return sum(per_ray) / len(per_ray)
