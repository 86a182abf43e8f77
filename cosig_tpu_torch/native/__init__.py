"""The native (C++) host builders, with the Python versions as fallback.

``src/bvh.cc`` builds the median-split BVH and ``src/gif_lzw.cc`` encodes
a GIF frame's LZW stream; :mod:`.loader` compiles both into one shared
library at first use and loads it with ctypes, and :mod:`.bvh_native` and
:mod:`.gif_native` bind it. Their output equals the Python builders'
(:func:`cosig_tpu_torch.accel.bvh.build_bvh` with ``use_native="python"``,
:func:`cosig_tpu_torch.utils.gif.lzw_compress_py`) bit for bit and byte
for byte; they only take less host time. Importing a module here builds
nothing.
"""
