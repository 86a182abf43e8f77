"""``capture_ms``: the port's set-up span ``cosig.setup.capture`` (from
``capture_begin`` to ``capture_end``, with the graph's instantiation)
of the graph that the traced frames replayed, from the capture record
``cosig_tpu_torch.utils.trace`` keeps. Layer: scene build and capture.
Moves ``setup_s``. Nothing without a trace or where the program keeps
no such record."""

from benchmark import program


def read(records):
    if records["trace"] is None:
        return None
    cap = program.capture(records["trace"])
    if cap is None or "cosig.setup.capture" not in cap.steps:
        return None
    return cap.steps["cosig.setup.capture"] * 1e3
