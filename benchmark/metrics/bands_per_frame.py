"""``bands_per_frame``: the row bands of the frame graph that the traced
frames replayed (``len(Capture.bands)`` of the capture record that
``cosig_tpu_torch.utils.trace`` keeps): a whole frame of 2^24 camera
rays or more renders as bands, one after another in one graph. Layer:
kernels. Moves ``frame_ms``. Nothing without a trace or where the
program records no bands."""

from benchmark import program


def read(records):
    if records["trace"] is None:
        return None
    bands = getattr(program.capture(records["trace"]), "bands", None)
    if not bands:
        return None
    return float(len(bands))
