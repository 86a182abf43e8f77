"""``geometry_ms``: the port's set-up span ``cosig.setup.geometry`` (the
scene's triangles, the cluster build, the upload and the primitive
table) of the scene whose graph the traced frames replayed, from the
capture record ``cosig_tpu_torch.utils.trace`` keeps. Layer: scene build
and capture. Moves ``setup_s``. Nothing without a trace or where the
program keeps no such record."""

from benchmark import program


def read(records):
    if records["trace"] is None:
        return None
    cap = program.capture(records["trace"])
    if cap is None or "cosig.setup.geometry" not in cap.steps:
        return None
    return cap.steps["cosig.setup.geometry"] * 1e3
