"""The card's peaks and the work a frame needs, for ``kernels_roofline``.

The constants are the port's (``chip_smoke.py``, kept here so the
yardstick does not move with it). The kernels are built with
``--fmad=false``, so every multiply and every add is its own
instruction, and the H100 SXM's fp32 pipes issue at most 132 SMs x 128
lanes x 1.98 GHz = 33.45 T of them a second (NVIDIA's 67 TFLOP/s counts a
fused multiply-add as two). A slab test (a ray against a box) is 24
operations: 6 subtracts, 6 multiplies, 10 min/max and 2 compares. A
triangle test is 55: three 6-term edge volumes, two 3-term dots, a
reciprocal, t and 9 compares. HBM moves 3.35 TB/s.

The work is counted by the reference (:class:`benchmark.reference.bvh.WorkCount`):
the box and triangle tests that a median-split BVH of at most 4
triangles a leaf needs for the rays of the pixels it traces, scaled to
the frame. Ray generation and shading are left out, so the bound is a
floor. The bytes are the frame's inputs read once (each triangle's three
vertices and three normals, 72 B) and its image written once (12 B a
pixel).
"""

from __future__ import annotations

PEAK_F32_OPS = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
OPS_PER_BOX = 24
OPS_PER_TRIANGLE = 55
BYTES_PER_TRIANGLE = 72
BYTES_PER_PIXEL = 12


def frame_bound(box_tests: float, tri_tests: float, triangles: int, pixels: int) -> dict:
    """The least time one frame's traversal could take -> {"ops", "bytes",
    "bound_ms", "bound_by"}."""
    ops = OPS_PER_BOX * box_tests + OPS_PER_TRIANGLE * tri_tests
    nbytes = BYTES_PER_TRIANGLE * triangles + BYTES_PER_PIXEL * pixels
    op_ms = ops / PEAK_F32_OPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" if op_ms >= byte_ms else "bytes"}
