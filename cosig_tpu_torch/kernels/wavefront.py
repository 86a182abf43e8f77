"""Wrappers of the five wavefront kernels.

``primary``, ``compact``, ``bounce``, ``trace`` and ``shade`` take the
tensors of one render stage and the frame's uniforms, materials and
lights in a :class:`~cosig_tpu_torch.kernels.binding.FrameBuffer`. On a
CUDA tensor they launch the hand-written kernel (``csrc/wavefront.cu``;
the fission and shadow-set builds ``csrc/forms.cu``)
on the current stream, without synchronising,
count the launch in :data:`cosig_tpu_torch.kernels.binding.LAUNCHES`, and
raise if the launch is refused; on a CPU tensor they run the plain
PyTorch version (:mod:`cosig_tpu_torch.ops.trace_wavefront`) and count
nothing. On either, each names its kernel (and ``compact`` its list's
length) for the plan being recorded
(:func:`cosig_tpu_torch.utils.trace.plan_step`). There is no fallback
from a CUDA tensor to the plain version.
A bounce stage is ``compact`` then ``bounce`` on its list: the list and
its length stay on the device, so the host never waits for them. In the
fission form it is ``compact``, then ``trace`` and ``shade`` on the same
list, on a 24-row state that ``primary(..., fission=True)`` makes and a
``shade`` over every ray finishes. Every wrapper but ``compact`` takes
``mxu`` (``"off"``, ``"full"``, ``"closest"``): the builds with the
tensor-core pair test (``csrc/mx.cu`` for the fused stages, counters
``primary_mx`` and ``bounce_mx``; ``csrc/mx_forms.cu`` for the others,
counters ``primary_fission_mx``, ``primary_shadow_mx``,
``bounce_shadow_mx`` and ``trace_mx`` in both modes, ``shade_mx`` and
``shade_all_mx`` in ``"full"``, since in ``"closest"`` the shade's
shadow rays take the exact builds) where :func:`kernel_core.mxu_mode`
keeps it for the set, else the exact builds. The shadow rays through a
separate shadow set always take the exact test; the caller of ``shade``
passes ``mxu="off"`` for one, as
:func:`~cosig_tpu_torch.ops.trace_wavefront.stages` does.
"""

from __future__ import annotations

import torch

from cosig_tpu_torch.accel.clusters import ClusterSet
from cosig_tpu_torch.kernels import binding
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import kernel_core, trace_wavefront
from cosig_tpu_torch.ops.kernel_core import FISSION_ROWS, STATE_ROWS, state_rows
from cosig_tpu_torch.utils import trace as tracing  # ``trace`` is a wrapper here


def _device(name: str, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")


def _check_counts(counts, dev: torch.device) -> None:
    """Raise unless ``counts`` is None or a contiguous int64 [3] on ``dev``."""
    n_counts = len(trace_wavefront.TRACE_COUNTS)
    if counts is not None and (counts.device != dev or counts.dtype != torch.int64
                               or not counts.is_contiguous()
                               or tuple(counts.shape) != (n_counts,)):
        raise ValueError(f"counts must be contiguous int64 [{n_counts}] on {dev}, got "
                         f"{counts.dtype} {tuple(counts.shape)} on {counts.device}")


def primary(cset: ClusterSet, fb: binding.FrameBuffer, cfg: StaticConfig, band: int,
            prims: torch.Tensor, n_sph: int, n_box: int, fission: bool = False,
            cset_shadow=None, mxu: str = "off", counts=None) -> torch.Tensor:
    """Primary stage -> state f32 [16, N] on the cluster set's device.
    ``prims``: the table of :func:`cosig_tpu_torch.ops.kernel_core.prim_table`.
    ``fission``: the build that stops after the trace -> state f32 [24, N]
    with the hit record in rows 15-19; ``cset_shadow``: the build whose
    shadow rays walk that cluster set; ``mxu``: the pair test's form.
    ``counts`` (``fission`` only): a contiguous int64 [3] on the device that
    the launch adds its closest hit's box tests, pairs run and pairs pruned
    to (``trace_wavefront.TRACE_COUNTS``), or None; the plain version on the
    CPU counts them only while tracing is on."""
    dev = cset.device
    if fission and cset_shadow is not None:
        raise ValueError("the fission primary traces no shadow rays: pass cset_shadow to shade")
    if counts is not None and not fission:
        raise ValueError("only the fission primary keeps counters")
    trace_wavefront.check_mxu(mxu)
    _check_counts(counts, dev)
    tracing.plan_step("primary", counts=counts)
    if dev.type == "cpu":
        return trace_wavefront.primary_stage(cset, fb.uniforms, fb.mats, fb.lights, cfg, band,
                                             prims, n_sph, n_box, fission=fission,
                                             cset_shadow=cset_shadow, mxu=mxu,
                                             counts=counts if tracing.on() else None)
    _device("primary", dev)
    binding.check_inputs(cset, dev, prims, n_sph, n_box)
    binding.check_buffer(fb, dev)
    if cset_shadow is not None:
        binding.check_shadow_set(cset_shadow, dev)
    mxu = kernel_core.mxu_mode(cset, mxu)
    frame = binding.make_frame(cfg, fb, band, 0, cfg.max_depth == 1,
                               mx_shadow=mxu == "full" and cset_shadow is None)
    state = torch.empty((state_rows(fission), frame.n_rays), dtype=torch.float32, device=dev)
    mx = "_mx" if mxu != "off" else ""
    if fission or cset_shadow is not None:
        binding.launch(f"cosig_primary_form{mx}_launch", frame, cset, prims, n_sph, n_box, state,
                       int(fission), *binding.shadow_args(cset_shadow), tail=(counts,))
    else:
        binding.launch(f"cosig_primary{mx}_launch", frame, cset, prims, n_sph, n_box, state)
    name = ("primary_fission" if fission else "primary" if cset_shadow is None
            else "primary_shadow")
    binding.LAUNCHES[name + mx] += 1
    return state


def _check_state(state: torch.Tensor, per_row: int, rows=(STATE_ROWS, FISSION_ROWS)) -> None:
    """Raise unless ``state`` is contiguous f32 [one of ``rows``, a multiple
    of ``per_row``]."""
    if (state.dtype != torch.float32 or not state.is_contiguous() or state.dim() != 2
            or state.shape[0] not in rows or state.shape[1] % per_row != 0):
        raise ValueError(
            f"state must be contiguous float32 [{' or '.join(map(str, rows))}, band * "
            f"{per_row}], got {state.dtype} {tuple(state.shape)}"
        )


def compact(state: torch.Tensor, n_live: torch.Tensor | None = None) -> tuple:
    """List the live rays of ``state`` f32 [16 or 24, N] -> ``(idx, n_live)``:
    int32 [N] and int32 [1] on the state's device, ``idx[:n_live]`` the ids
    of the rays with alive > 0 by direction octant, then by id (entries
    past ``n_live`` are unspecified). ``n_live``: where the kernel writes
    the length (contiguous int32 [1] on the device), else a new tensor."""
    dev = state.device
    if dev.type == "cpu":
        idx, n_live = trace_wavefront.compact_plain(state)
        tracing.plan_step("compact", n_live=n_live)
        return idx, n_live
    _device("compaction", dev)
    _check_state(state, 1)
    idx = torch.empty(state.shape[1], dtype=torch.int32, device=dev)
    if n_live is None:
        n_live = torch.empty(1, dtype=torch.int32, device=dev)
    elif (n_live.device != dev or n_live.dtype != torch.int32 or not n_live.is_contiguous()
          or tuple(n_live.shape) != (1,)):
        raise ValueError(f"n_live must be contiguous int32 [1] on {dev}, got {n_live.dtype} "
                         f"{tuple(n_live.shape)} on {n_live.device}")
    binding.launch_compact(state, idx, n_live)
    binding.LAUNCHES["compact"] += 1
    tracing.plan_step("compact", n_live=n_live)
    return idx, n_live


def _check_stage(name, state, idx, n_live, cset, fb, cfg, depth, prims, n_sph, n_box, rows,
                 mx_shadow=False):
    """The checks of a bounce-stage launch -> its Frame."""
    dev = state.device
    _device(name, dev)
    binding.check_inputs(cset, dev, prims, n_sph, n_box)
    binding.check_buffer(fb, dev)
    if not 1 <= depth < cfg.max_depth:
        raise ValueError(f"{name} depth {depth} outside 1..{cfg.max_depth - 1}")
    per_row = cfg.width * max(1, cfg.aa_samples)
    _check_state(state, per_row, rows)
    n = state.shape[1]
    for what, t, shape in (("idx", idx, (n,)), ("n_live", n_live, (1,))):
        if (t.device != dev or t.dtype != torch.int32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{what} must be contiguous int32 {list(shape)} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return binding.make_frame(cfg, fb, n // per_row, depth, depth == cfg.max_depth - 1,
                              mx_shadow=mx_shadow)


def bounce(state: torch.Tensor, idx: torch.Tensor, n_live: torch.Tensor, cset: ClusterSet,
           fb: binding.FrameBuffer, cfg: StaticConfig, depth: int, prims: torch.Tensor,
           n_sph: int, n_box: int, cset_shadow=None, mxu: str = "off") -> None:
    """One bounce stage at ``depth`` (1 .. max_depth-1) on the listed rays
    ``idx[:n_live]`` of ``state``, in place (``idx``, ``n_live``: from
    :func:`compact`); ``cset_shadow``: the build whose shadow rays walk
    that cluster set; ``mxu``: the pair test's form."""
    dev = state.device
    trace_wavefront.check_mxu(mxu)
    tracing.plan_step("bounce", depth)
    if dev.type == "cpu":
        trace_wavefront.bounce_listed_stage(state, idx, n_live, cset, fb.uniforms, fb.mats,
                                            fb.lights, cfg, depth, prims, n_sph, n_box,
                                            cset_shadow=cset_shadow, mxu=mxu)
        return
    mxu = kernel_core.mxu_mode(cset, mxu)
    frame = _check_stage("bounce", state, idx, n_live, cset, fb, cfg, depth, prims, n_sph,
                         n_box, (STATE_ROWS,), mx_shadow=mxu == "full" and cset_shadow is None)
    mx = "_mx" if mxu != "off" else ""
    if cset_shadow is None:
        binding.launch(f"cosig_bounce{mx}_launch", frame, cset, prims, n_sph, n_box, state, idx,
                       n_live)
        binding.LAUNCHES["bounce" + mx] += 1
        return
    binding.check_shadow_set(cset_shadow, dev)
    binding.launch(f"cosig_bounce_shadow{mx}_launch", frame, cset, prims, n_sph, n_box, state,
                   *binding.shadow_args(cset_shadow), idx, n_live)
    binding.LAUNCHES["bounce_shadow" + mx] += 1


def trace(state: torch.Tensor, idx: torch.Tensor, n_live: torch.Tensor, cset: ClusterSet,
          fb: binding.FrameBuffer, cfg: StaticConfig, depth: int, prims: torch.Tensor,
          n_sph: int, n_box: int, mxu: str = "off", counts=None) -> None:
    """The trace half of the bounce stage at ``depth`` on the listed rays
    ``idx[:n_live]`` of a 24-row ``state``, in place: each listed ray's
    count, and its hit record in rows 15-19; ``mxu``: the closest hit's
    form (the tensor-core build in both modes). ``counts``: a contiguous
    int64 [3] on the device that the launch adds its walk's box tests
    (group and cluster, per listed ray), pairs run and pairs pruned to
    (``trace_wavefront.TRACE_COUNTS``), or None; the plain version on the
    CPU counts them only while tracing is on."""
    dev = state.device
    trace_wavefront.check_mxu(mxu)
    _check_counts(counts, dev)
    tracing.plan_step("trace", depth, counts=counts)
    if dev.type == "cpu":
        trace_wavefront.trace_listed_stage(state, idx, n_live, cset, prims, n_sph, n_box,
                                           mxu=mxu, counts=counts if tracing.on() else None)
        return
    frame = _check_stage("trace", state, idx, n_live, cset, fb, cfg, depth, prims, n_sph,
                         n_box, (FISSION_ROWS,))
    mx = "_mx" if kernel_core.mxu_mode(cset, mxu) != "off" else ""
    binding.launch(f"cosig_trace{mx}_launch", frame, cset, prims, n_sph, n_box, state, idx,
                   n_live, tail=(counts,))
    binding.LAUNCHES["trace" + mx] += 1


def shade(state: torch.Tensor, idx, n_live, cset: ClusterSet, fb: binding.FrameBuffer,
          cfg: StaticConfig, depth: int, prims: torch.Tensor, n_sph: int, n_box: int,
          mxu: str = "off", counts=None) -> None:
    """The shade half of a stage on a 24-row ``state`` in place, its shadow
    rays through ``cset`` (the shadow set where there is one): with ``idx``
    and ``n_live`` (None both) on the listed rays of the bounce stage at
    ``depth``, the list its trace took; without them on every ray of the
    primary stage (``depth`` 0), on the primary kernel's blocks with the
    frustum cull. ``mxu``: the shadow rays take the tensor-core build in
    ``"full"`` (counters ``shade_mx`` on a list, ``shade_all_mx`` over
    every ray); pass ``"off"`` for a separate shadow set. ``counts``: a
    contiguous int64 [3] on the device that the launch adds its shadow
    rays' box tests, the pairs their any hits run and the shadow rays cast
    to (``trace_wavefront.SHADE_COUNTS``), or None; the plain version on
    the CPU counts them only while tracing is on."""
    dev = state.device
    if (idx is None) != (n_live is None) or (idx is None) != (depth == 0):
        raise ValueError("shade takes a list at depth >= 1 and none at depth 0")
    trace_wavefront.check_mxu(mxu)
    _check_counts(counts, dev)
    tracing.plan_step("shade" if depth else "shade_all", depth, counts=counts)
    if dev.type == "cpu":
        counts = counts if tracing.on() else None
        if idx is None:
            trace_wavefront.primary_shade(state, cset, fb.uniforms, fb.mats, fb.lights, cfg,
                                          prims, n_sph, n_box, mxu=mxu, counts=counts)
        else:
            trace_wavefront.shade_listed_stage(state, idx, n_live, cset, fb.uniforms, fb.mats,
                                               fb.lights, cfg, depth, prims, n_sph, n_box,
                                               mxu=mxu, counts=counts)
        return
    full = kernel_core.mxu_mode(cset, mxu) == "full"
    if idx is None:
        _device("shade", dev)
        binding.check_inputs(cset, dev, prims, n_sph, n_box)
        binding.check_buffer(fb, dev)
        per_row = cfg.width * max(1, cfg.aa_samples)
        _check_state(state, per_row, (FISSION_ROWS,))
        frame = binding.make_frame(cfg, fb, state.shape[1] // per_row, 0, cfg.max_depth == 1,
                                   mx_shadow=full)
    else:
        frame = _check_stage("shade", state, idx, n_live, cset, fb, cfg, depth, prims, n_sph,
                             n_box, (FISSION_ROWS,), mx_shadow=full)
    binding.launch("cosig_shade_mx_launch" if full else "cosig_shade_launch", frame, cset, prims,
                   n_sph, n_box, state, idx, n_live, tail=(counts,))
    if not full:
        binding.LAUNCHES["shade"] += 1
    else:
        binding.LAUNCHES["shade_mx" if idx is not None else "shade_all_mx"] += 1
