"""Wrappers of the megakernel and the debug kernel.

``megakernel`` and ``debug`` take the inputs of one render, the frame's
uniforms, materials and lights in a
:class:`~cosig_tpu_torch.kernels.binding.FrameBuffer`. On a CUDA
cluster set they launch the hand-written kernel (``csrc/megakernel.cu``)
on the current stream, without synchronising, count the launch in
:data:`cosig_tpu_torch.kernels.binding.LAUNCHES`, and raise if the launch
is refused; on the CPU they run the plain PyTorch version
(:mod:`cosig_tpu_torch.ops.trace_megakernel`) and count nothing. There is
no fallback from a CUDA tensor to the plain version. ``megakernel(mxu=
"full")`` launches the build with the tensor-core pair test (counter
``megakernel_mx``) where :func:`kernel_core.mxu_mode` keeps it for the set.
"""

from __future__ import annotations

import torch

from cosig_tpu_torch.accel.clusters import ClusterSet
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import kernel_core, trace_megakernel


def megakernel(cset: ClusterSet, fb: binding.FrameBuffer, cfg: StaticConfig, band: int,
               prims: torch.Tensor, n_sph: int, n_box: int, mxu: str = "off") -> torch.Tensor:
    """Render ``band`` rows -> f32 [4, band * W] (rgb mean, ray count) on the
    cluster set's device. ``prims``: the table of
    :func:`cosig_tpu_torch.ops.kernel_core.prim_table`; ``mxu``: ``"off"``
    or ``"full"``, the pair test's form."""
    dev = cset.device
    trace_megakernel.check_mxu(mxu)
    if dev.type == "cpu":
        return trace_megakernel.megakernel_plain(cset, fb.uniforms, fb.mats, fb.lights, cfg,
                                                 band, prims, n_sph, n_box, mxu=mxu)
    if dev.type != "cuda":
        raise ValueError(f"no megakernel for device {dev}")
    binding.check_inputs(cset, dev, prims, n_sph, n_box)
    binding.check_buffer(fb, dev)
    if cfg.max_depth < 1:
        raise ValueError(f"max_depth must be >= 1, got {cfg.max_depth}")
    n = band * cfg.width
    frame = binding.make_frame(cfg, fb, band, 0, False, n_rays=n)
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    if kernel_core.mxu_mode(cset, mxu) != "off":
        binding.launch("cosig_megakernel_mx_launch", frame, cset, prims, n_sph, n_box, out,
                       cfg.max_depth)
        binding.LAUNCHES["megakernel_mx"] += 1
        return out
    binding.launch("cosig_megakernel_launch", frame, cset, prims, n_sph, n_box, out,
                   cfg.max_depth)
    binding.LAUNCHES["megakernel"] += 1
    return out


def debug(cset: ClusterSet, fb: binding.FrameBuffer, cfg: StaticConfig, prims: torch.Tensor,
          n_sph: int, n_box: int) -> torch.Tensor:
    """Debug view ``cfg.debug_mode`` -> f32 [4, H * W] (rgb, count 1)."""
    dev = cset.device
    if dev.type == "cpu":
        return trace_megakernel.debug_plain(cset, fb.uniforms, fb.mats, fb.lights, cfg, prims,
                                            n_sph, n_box)
    if dev.type != "cuda":
        raise ValueError(f"no debug kernel for device {dev}")
    binding.check_inputs(cset, dev, prims, n_sph, n_box)
    binding.check_buffer(fb, dev)
    if cfg.debug_mode not in (1, 2, 3):
        raise ValueError(f"debug_mode must be 1, 2 or 3, got {cfg.debug_mode}")
    n = cfg.height * cfg.width
    frame = binding.make_frame(cfg, fb, cfg.height, 0, False, n_rays=n)
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    binding.launch("cosig_debug_launch", frame, cset, prims, n_sph, n_box, out,
                   cfg.debug_mode)
    binding.LAUNCHES["debug"] += 1
    return out
