"""cosig_tpu_torch — the cosig ray tracer on PyTorch and CUDA.

A port of :mod:`cosig_tpu` (JAX/Pallas on a TPU) to PyTorch with
hand-written CUDA kernels for NVIDIA Hopper. It imports ``torch`` and never
``jax`` and nothing of the JAX package: the scene model, settings,
parser, tessellation, BVH builders, GIF encoders and procedural scenes are
the port's own copies of the JAX package's host modules (the C++ ones
included).

Layout mirrors :mod:`cosig_tpu`:

* ``cosig_tpu_torch.models``  — scene data model, render settings,
  StaticConfig / FrameParams builders (numpy)
* ``cosig_tpu_torch.scene``   — scene-file parser, transforms, tessellation,
  procedural bench scenes
* ``cosig_tpu_torch.accel``   — BVH and cluster structure (host build, torch tensors)
* ``cosig_tpu_torch.ops``     — plain PyTorch versions of the device code
  and the wavefront, megakernel (and ``render_chain``) and debug renders, the analytic
  primitives, and the oracle path (``trace_xla``, ``bvh_traverse``,
  ``intersect``, ``shade``, ``camera``)
* ``cosig_tpu_torch.kernels`` — nvcc build, ctypes wrappers, launch counters
* ``cosig_tpu_torch.csrc``    — the CUDA sources
* ``cosig_tpu_torch.render``  — the Renderer front end (backends ``auto``,
  ``xla``, ``xla-brute``, ``wavefront``, ``megakernel``; ``render_chunked``)
* ``cosig_tpu_torch.parallel`` — a frame rendered in row bands over a
  list of devices (``sharding``: oracle, megakernel and wavefront paths)
* ``cosig_tpu_torch.native``  — the C++ BVH builder and GIF LZW encoder
  (g++ at first use, ctypes; the Python builders are their fallback)
* ``cosig_tpu_torch.utils``   — PNG and GIF writers
* ``cosig_tpu_torch.cli``     — the command line (``cosig-tpu-torch``)
"""

__version__ = "0.1.0"

from cosig_tpu_torch.models.preset import ScenePreset
from cosig_tpu_torch.models.scene import SceneData
from cosig_tpu_torch.models.settings import RenderSettings
from cosig_tpu_torch.scene.parser import load_scene, parse_scene
from cosig_tpu_torch.render.renderer import Renderer, RenderStats, estimate_rays

__all__ = [
    "SceneData",
    "RenderSettings",
    "Renderer",
    "RenderStats",
    "ScenePreset",
    "estimate_rays",
    "load_scene",
    "parse_scene",
    "__version__",
]
