"""Rendering over several devices: the framebuffer in row bands
(:mod:`cosig_tpu_torch.parallel.sharding`)."""
