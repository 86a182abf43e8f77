"""Camera helpers (counterpart of :mod:`cosig_tpu.ops.camera`).

The primary stage (:mod:`cosig_tpu_torch.ops.trace_wavefront` and its
kernel) builds the camera rays itself; this module keeps the shared
stratified AA grid rule.
"""

from __future__ import annotations

import math
from typing import Tuple


def aa_grid(sample_count: int) -> Tuple[int, int]:
    """gridW = ceil(sqrt(n)), gridH = ceil(n / gridW) (compute:285-287)."""
    n = max(1, sample_count)
    grid_w = math.ceil(math.sqrt(n))
    grid_h = math.ceil(n / grid_w)
    return grid_w, grid_h
