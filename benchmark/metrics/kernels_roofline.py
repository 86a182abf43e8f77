"""``kernels_roofline``: the least time a frame's traversal could take
on the card (``benchmark.peaks.frame_bound`` of the work that the
reference counts from the frame's inputs) over ``kernel_ms_per_frame``,
in percent. The work does not depend on how the program walks its own
structure. Layer: kernels. Moves ``frame_ms``. Nothing without a trace
or a work count."""

from benchmark import timeline


def read(records):
    trace, bound = records["trace"], records["bound"]
    if trace is None or bound is None or trace["frames"] == 0:
        return None
    kernel_ms = timeline.kernel_us(trace) / trace["frames"] / 1e3
    if kernel_ms <= 0:
        return None
    return 100.0 * bound["bound_ms"] / kernel_ms
