"""``launches_per_frame``: the increase of the port's launch counters
(``cosig_tpu_torch.kernels.binding.LAUNCHES``: each kernel launch, and
one for each graph replay) over the window, over the window's frames. A
count that repeats exactly. Layer: frame host path. Moves ``frame_ms``.
Nothing where the counters did not move (the plain versions on a CPU)."""


def read(records):
    total = sum(records["launches"].values())
    if total == 0 or records["frames"] == 0:
        return None
    return total / records["frames"]
