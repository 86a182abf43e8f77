"""The benchmark's plain reference renderer: PyTorch operations only.

It imports nothing of the program under test: scene model, parser,
transforms, tessellation, frame parameters, camera, hash RNG,
intersection, shading and tracer are frozen copies kept here, so a later
change to the program cannot move what the benchmark compares against.
"""
