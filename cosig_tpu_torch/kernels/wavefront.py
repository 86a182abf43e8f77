"""Wrappers of the three wavefront kernels.

``primary``, ``compact`` and ``bounce`` take the tensors of one render
stage and the frame's uniforms, materials and lights in a
:class:`~cosig_tpu_torch.kernels.binding.FrameBuffer`. On a CUDA tensor
they launch the hand-written kernel (``csrc/wavefront.cu``) on the
current stream, without synchronising,
count the launch in :data:`cosig_tpu_torch.kernels.binding.LAUNCHES`, and
raise if the launch is refused; on a CPU tensor they run the plain
PyTorch version (:mod:`cosig_tpu_torch.ops.trace_wavefront`) and count
nothing. There is no fallback from a CUDA tensor to the plain version.
A bounce stage is ``compact`` then ``bounce`` on its list: the list and
its length stay on the device, so the host never waits for them.
"""

from __future__ import annotations

import torch

from cosig_tpu_torch.accel.clusters import ClusterSet
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import trace_wavefront
from cosig_tpu_torch.ops.kernel_core import STATE_ROWS


def primary(cset: ClusterSet, fb: binding.FrameBuffer, cfg: StaticConfig, band: int,
            prims: torch.Tensor, n_sph: int, n_box: int) -> torch.Tensor:
    """Primary stage -> state f32 [16, N] on the cluster set's device.
    ``prims``: the table of :func:`cosig_tpu_torch.ops.kernel_core.prim_table`."""
    dev = cset.device
    if dev.type == "cpu":
        return trace_wavefront.primary_stage(cset, fb.uniforms, fb.mats, fb.lights, cfg, band,
                                             prims, n_sph, n_box)
    if dev.type != "cuda":
        raise ValueError(f"no primary kernel for device {dev}")
    binding.check_inputs(cset, dev, prims, n_sph, n_box)
    binding.check_buffer(fb, dev)
    frame = binding.make_frame(cfg, fb, band, 0, cfg.max_depth == 1)
    state = torch.empty((STATE_ROWS, frame.n_rays), dtype=torch.float32, device=dev)
    binding.launch("cosig_primary_launch", frame, cset, prims, n_sph, n_box, state)
    binding.LAUNCHES["primary"] += 1
    return state


def _check_state(state: torch.Tensor, per_row: int) -> None:
    """Raise unless ``state`` is contiguous f32 [16, a multiple of ``per_row``]."""
    if (state.dtype != torch.float32 or not state.is_contiguous() or state.dim() != 2
            or state.shape[0] != STATE_ROWS or state.shape[1] % per_row != 0):
        raise ValueError(
            f"state must be contiguous float32 [{STATE_ROWS}, band * {per_row}], "
            f"got {state.dtype} {tuple(state.shape)}"
        )


def compact(state: torch.Tensor) -> tuple:
    """List the live rays of ``state`` f32 [16, N] -> ``(idx, n_live)``:
    int32 [N] and int32 [1] on the state's device, ``idx[:n_live]`` the ids
    of the rays with alive > 0 by direction octant, then by id (entries
    past ``n_live`` are unspecified)."""
    dev = state.device
    if dev.type == "cpu":
        return trace_wavefront.compact_plain(state)
    if dev.type != "cuda":
        raise ValueError(f"no compaction kernel for device {dev}")
    _check_state(state, 1)
    idx = torch.empty(state.shape[1], dtype=torch.int32, device=dev)
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    binding.launch_compact(state, idx, n_live)
    binding.LAUNCHES["compact"] += 1
    return idx, n_live


def bounce(state: torch.Tensor, idx: torch.Tensor, n_live: torch.Tensor, cset: ClusterSet,
           fb: binding.FrameBuffer, cfg: StaticConfig, depth: int, prims: torch.Tensor,
           n_sph: int, n_box: int) -> None:
    """One bounce stage at ``depth`` (1 .. max_depth-1) on the listed rays
    ``idx[:n_live]`` of ``state``, in place (``idx``, ``n_live``: from
    :func:`compact`)."""
    dev = state.device
    if dev.type == "cpu":
        trace_wavefront.bounce_listed_stage(state, idx, n_live, cset, fb.uniforms, fb.mats,
                                            fb.lights, cfg, depth, prims, n_sph, n_box)
        return
    if dev.type != "cuda":
        raise ValueError(f"no bounce kernel for device {dev}")
    binding.check_inputs(cset, dev, prims, n_sph, n_box)
    binding.check_buffer(fb, dev)
    if not 1 <= depth < cfg.max_depth:
        raise ValueError(f"bounce depth {depth} outside 1..{cfg.max_depth - 1}")
    per_row = cfg.width * max(1, cfg.aa_samples)
    _check_state(state, per_row)
    n = state.shape[1]
    for name, t, shape in (("idx", idx, (n,)), ("n_live", n_live, (1,))):
        if (t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be contiguous int32 {list(shape)} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    frame = binding.make_frame(cfg, fb, n // per_row, depth, depth == cfg.max_depth - 1)
    binding.launch("cosig_bounce_launch", frame, cset, prims, n_sph, n_box, state, idx, n_live)
    binding.LAUNCHES["bounce"] += 1
