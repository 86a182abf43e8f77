"""``first_frame_ms``: the benchmark's span (host clock) around the first
``render_to_device`` of set-up, which tessellates the parsed scene and
builds its clusters, builds the kernels where the checkout has none and
loads them, and captures the frame's CUDA graph. Layer: scene build and
capture. Moves ``setup_s``."""


def read(records):
    return records["first_frame_s"] * 1e3
