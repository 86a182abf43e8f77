"""``shadow_box_tests_per_ray``: the box tests that the port's shade kernels
run for their shadow rays in a traced frame (``FrameRecord.shadow_tests``:
by depth, 0 the shade over every ray, the box tests of the any hits' culls,
the pairs they run and the shadow rays cast, summed over the bands) over
the shadow rays cast, summed over the depths, mean over the traced frames.
Soft shadows jitter each shadow ray's light point, which makes a block's
shadow rays less alike. Layer: kernels. Moves ``frame_ms``. Nothing where
the program keeps no such counter: frame records without ``shadow_tests``,
or with none filled."""

from benchmark import program


def read(records):
    trace = records["trace"]
    if trace is None:
        return None
    per_ray = []
    for _, rec in program.frames(trace):
        tests = getattr(rec, "shadow_tests", None)
        if not tests:
            continue
        rays = sum(t[2] for t in tests.values())
        if rays > 0:
            per_ray.append(sum(t[0] for t in tests.values()) / rays)
    if not per_ray:
        return None
    return sum(per_ray) / len(per_ray)
