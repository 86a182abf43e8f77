"""``kernel_ms_per_frame``: the device time of every kernel (the port's
CUDA kernels and the PyTorch operations of the frame's finalize; not the
copies) over the traced frames, per frame (torch.profiler). Layer:
kernels. Moves ``frame_ms``."""

from benchmark import timeline


def read(records):
    trace = records["trace"]
    if trace is None or trace["frames"] == 0:
        return None
    return timeline.kernel_us(trace) / trace["frames"] / 1e3
