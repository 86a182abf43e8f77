"""Wavefront render: one primary stage, then one bounce stage per depth.

Counterpart of :func:`cosig_tpu.ops.trace_wavefront.render_wavefront`
(``trace_wavefront.py:756-1172``); its images are those of the shipped
self-skip dispatch (``:955-1012``), its bounce dispatch the compaction
form (``:1013-1129``), which gives the same bits there:

1. the **primary stage** (``:317-434``) makes a camera ray for every
   (pixel, AA sample), writes the 16-row ray state and runs bounce 0;
2. ``max_depth - 1`` **bounce stages** each list the live rays
   (:func:`compact_plain`, the per-ray form of ``_compact_prefix``,
   ``:576-617``) and run one bounce on each listed ray, writing it back in
   place, so the state stays in pixel order (:func:`bounce_listed_stage`);
3. **finalize** (``:1136-1172``) averages the AA samples into the image and
   sums the ray count.

Two forms of the JAX package's kernels are keywords of every entry point
here (``render_wavefront(cset_primary=, cset_shadow=)`` and its
``_FISSION`` switch, ``:767-888``); both give the fused single-set bits:

* ``fission=True`` splits each stage in two (``:115-135``): a **trace**
  (closest hit only; the hit record t, nx, ny, nz, mat rides state rows
  15-19 of a 24-row state) and a **shade** (the record, then shadow rays,
  shading and the secondary ray). The primary stage stops after its trace
  and a shade over every ray finishes it; a bounce stage traces and shades
  the same compaction list, since a ray that misses in the trace is live
  until its shade adds the background;
* ``cset_primary``: the primary stage traces (closest hit and shadow rays)
  on this cut of the same triangles, the bounces on ``cset``;
* ``cset_shadow``: every shadow ray of every stage walks this cut, which
  must fit one cull block (c_pad <= 512, ``:716-753``).

``mxu`` picks the pair test's form in every stage, the counterpart of the
JAX package's ``COSIG_MXU`` and ``COSIG_MXU_SHADOW`` switches, which
``_stage_resources`` applies per stage whatever the form (``:621-714``):
``"off"`` (the default) the exact test, ``"full"`` the tensor-core form
(:func:`kernel_core.traverse` ``mx``) for the closest hit and the shadow
rays, ``"closest"`` for the closest hit only. In the fission form the
trace takes it in both modes and the shade (the shadow rays) in
``"full"``; the shadow rays through a separate ``cset_shadow`` always take
the exact test, as JAX's shadow traversal does (``:247-267``, no
``geom_mx``). A stage whose set is past ``STREAM_THRESHOLD_BYTES`` keeps
the exact test, as the JAX package's streamed stages do
(:func:`kernel_core.mxu_mode`).

Rays are enumerated in plain order, ``id = (py_local * W + px) * aa + s``
with N = band * W * aa and no tile padding. The RNG seeds (px, py, s) are
the JAX package's, so images agree; finalize is the exact inverse of the
enumeration.

The stage functions here are the plain PyTorch versions of the three
CUDA kernels (``csrc/wavefront.cu``); :mod:`cosig_tpu_torch.kernels.wavefront`
dispatches between them by the device the state lives on.
"""

from __future__ import annotations

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import CULL_BLOCK, ClusterSet
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import camera, kernel_core
from cosig_tpu_torch.ops.kernel_core import (
    ROW_ALIVE,
    ROW_COUNT,
    ROW_ID,
    U_ROW_OFF,
    state_rows,
)
from cosig_tpu_torch.ops.intersect import _div

F32 = np.float32


def num_rays(cfg: StaticConfig, band: int) -> int:
    """Rays in a band of ``band`` rows; ray ids must stay f32-exact."""
    n = band * cfg.width * max(1, cfg.aa_samples)
    if n >= 2 ** 24:
        raise ValueError(
            f"{n} rays exceed f32-exact ray ids; render in row bands (rows/row_offset)"
        )
    return n


def _seed_planes(rid: torch.Tensor, cfg: StaticConfig, row_offset: float):
    """(px, py, s) RNG seed planes from integer ray ids (inverse of the
    enumeration); py is global (band offset added)."""
    aa = max(1, cfg.aa_samples)
    s_i = rid % aa
    p_i = rid // aa
    px = (p_i % cfg.width).to(torch.float32)
    py = (p_i // cfg.width).to(torch.float32) + row_offset
    return px, py, s_i.to(torch.float32)


def check_mxu(mxu: str) -> None:
    """Raise on an unknown ``mxu``."""
    if mxu not in kernel_core.MXU_MODES:
        raise ValueError(f"mxu must be one of {kernel_core.MXU_MODES}, got {mxu!r}")


def check_forms(cset: ClusterSet, cset_primary=None, cset_shadow=None,
                mxu: str = "off") -> None:
    """Raise unless the optional cluster sets can stand in for ``cset``:
    on its device, over as many triangles, and a shadow set within one cull
    block (c_pad <= 512, as cosig_tpu/ops/trace_wavefront.py:733 asserts);
    a wider shadow set is refused, never clipped; and unless ``mxu`` is a
    known mode (:func:`check_mxu`): every form takes every mode."""
    check_mxu(mxu)
    for name, other in (("cset_primary", cset_primary), ("cset_shadow", cset_shadow)):
        if other is None:
            continue
        if other.device != cset.device:
            raise ValueError(f"{name} lives on {other.device}, not {cset.device}")
        if other.num_triangles != cset.num_triangles:
            raise ValueError(f"{name} holds {other.num_triangles} triangles, the scene "
                             f"{cset.num_triangles}: it must cut the same triangles")
    if cset_shadow is not None and int(cset_shadow.aabb_t.shape[1]) > CULL_BLOCK:
        raise ValueError(
            f"cset_shadow must fit one cull block of {CULL_BLOCK} clusters (c_pad <= "
            f"{CULL_BLOCK}); got c_pad {int(cset_shadow.aabb_t.shape[1])}: use a larger k"
        )


def primary_stage(cset: ClusterSet, uniforms: np.ndarray, mats: np.ndarray,
                  lights: np.ndarray, cfg: StaticConfig, band: int,
                  prims: torch.Tensor, n_sph: int, n_box: int,
                  warps=None, fission: bool = False, cset_shadow=None,
                  mxu: str = "off") -> torch.Tensor:
    """Plain version of the primary kernel -> state f32 [16, N] ([24, N]
    with ``fission``) on the cluster set's device (trace_wavefront.py:317-434). ``prims`` is the
    table of :func:`kernel_core.prim_table`; ``warps`` an optional ray ->
    warp map whose pair-loop slots the traversals count
    (:func:`kernel_core.traverse`). Both traversals run the kernel's
    pre-filters on its blocks of 128 consecutive rays, the frustum cull
    among them (JAX: trace_wavefront.py:412-424). ``fission``: the state
    has 24 rows and the stage stops after the trace, with the hit record
    in rows 15-19 (:func:`primary_shade` finishes it); ``cset_shadow``: the
    cluster set the shadow rays walk; ``mxu``: the pair test's form (module
    docstring)."""
    check_mxu(mxu)
    mxu = kernel_core.mxu_mode(cset, mxu)
    dev = cset.device
    n = num_rays(cfg, band)
    u = [float(x) for x in uniforms]
    row_off = u[U_ROW_OFF]

    rid = torch.arange(n, device=dev, dtype=torch.int64)
    px, py, s = _seed_planes(rid, cfg, row_off)
    in_image = py < float(cfg.height)

    ox, oy, oz, dx, dy, dz = camera.primary_rays(cfg, u, px, py, s)

    state = torch.zeros((state_rows(fission), n), dtype=torch.float32, device=dev)
    state[0], state[1], state[2] = ox, oy, oz
    state[3], state[4], state[5] = dx, dy, dz
    state[6:9] = 1.0
    state[ROW_ALIVE] = in_image.to(torch.float32)
    state[ROW_ID] = rid.to(torch.float32)
    pk = dict(prims=prims, n_sph=n_sph, n_box=n_box, warps=warps,
              packets=kernel_core.linear_packets(n).to(dev), frustum=True)
    if fission:
        kernel_core.rec_store(state, kernel_core.bounce_trace(cset, state, mx=mxu != "off",
                                                              **pk))
        return state
    kernel_core.bounce_core(cfg, uniforms, mats, lights, cset, state,
                            px, py, s, depth=0, is_last=cfg.max_depth == 1,
                            cset_shadow=cset_shadow, mxu=mxu, **pk)
    return state


def _seeds_of(state: torch.Tensor, cfg: StaticConfig, uniforms: np.ndarray):
    """RNG seed planes from the ray-id row, or Nones when no effect reads them."""
    if cfg.enable_soft_shadows or cfg.enable_glossy:
        rid = state[ROW_ID].to(torch.int64)
        return _seed_planes(rid, cfg, float(uniforms[U_ROW_OFF]))
    return None, None, None  # unread without the stochastic effects


def bounce_stage(state: torch.Tensor, cset: ClusterSet, uniforms: np.ndarray,
                 mats: np.ndarray, lights: np.ndarray, cfg: StaticConfig,
                 depth: int, prims: torch.Tensor, n_sph: int, n_box: int,
                 warps=None, packets=None, cset_shadow=None, mxu: str = "off") -> None:
    """One bounce at ``depth`` on every column of ``state`` in place
    (trace_wavefront.py:466-507), the self-skip form: a dead ray's bounce
    changes nothing. ``warps``: an optional ray -> warp map of the
    columns, whose pair-loop slots the traversals count; ``packets``: an
    optional ray -> block map, whose superblock cull the traversals run
    (bounce rays are incoherent: no frustum cull, as
    trace_wavefront.py:459); ``cset_shadow``: the cluster set the shadow
    rays walk; ``mxu``: the pair test's form (module docstring)."""
    check_mxu(mxu)
    mxu = kernel_core.mxu_mode(cset, mxu)
    px, py, s = _seeds_of(state, cfg, uniforms)
    kernel_core.bounce_core(cfg, uniforms, mats, lights, cset, state,
                            px, py, s, depth=depth,
                            is_last=depth == cfg.max_depth - 1,
                            prims=prims, n_sph=n_sph, n_box=n_box, warps=warps,
                            packets=packets, cset_shadow=cset_shadow, mxu=mxu)


def shade_stage(state: torch.Tensor, cset: ClusterSet, uniforms: np.ndarray,
                mats: np.ndarray, lights: np.ndarray, cfg: StaticConfig, depth: int,
                prims: torch.Tensor, n_sph: int, n_box: int, warps=None, packets=None,
                frustum: bool = False, mxu: str = "off") -> None:
    """The shade half of a bounce at ``depth`` on every column of a 24-row
    ``state`` in place (``mode="shade"``, trace_wavefront.py:439-507): the
    hit record of rows 15-19, then ambient, per light a shadow ray through
    ``cset`` (the shadow set where there is one), Lambert and Blinn-Phong,
    and the secondary ray. The primary stage's shade is depth 0 over every
    ray, with ``packets`` its kernel's blocks and the frustum cull on.
    ``mxu``: the shadow rays take the tensor-core form in ``"full"`` (the
    caller passes ``"off"`` for a separate shadow set, whose walk is always
    exact)."""
    check_mxu(mxu)
    mxu = kernel_core.mxu_mode(cset, mxu)
    px, py, s = _seeds_of(state, cfg, uniforms)
    kernel_core.bounce_core(cfg, uniforms, mats, lights, cset, state, px, py, s, depth=depth,
                            is_last=depth == cfg.max_depth - 1, prims=prims, n_sph=n_sph,
                            n_box=n_box, warps=warps, packets=packets, frustum=frustum,
                            rec=kernel_core.rec_load(state), mxu=mxu)


def primary_shade(state: torch.Tensor, cset: ClusterSet, uniforms: np.ndarray,
                  mats: np.ndarray, lights: np.ndarray, cfg: StaticConfig,
                  prims: torch.Tensor, n_sph: int, n_box: int, warps=None,
                  mxu: str = "off") -> None:
    """Plain version of the shade kernel over every ray of a fission
    primary stage: depth 0 on the primary kernel's blocks, frustum cull on
    (the fused primary's shadow rays); ``mxu`` as in :func:`shade_stage`."""
    shade_stage(state, cset, uniforms, mats, lights, cfg, 0, prims, n_sph, n_box, warps=warps,
                packets=kernel_core.linear_packets(state.shape[1]).to(state.device),
                frustum=True, mxu=mxu)


def compact_plain(state: torch.Tensor):
    """Plain version of the compaction kernel -> ``(idx, n_live)``: int32
    [N] and int32 [1] on the state's device. ``idx[:n_live]`` lists the
    rays with alive > 0 by the key ``(dx > 0) + 2 (dy > 0) + 4 (dz > 0)``
    (``_compact_prefix``'s, trace_wavefront.py:603-607, taken per ray), then
    by id; the dead rays follow by id."""
    alive = state[ROW_ALIVE] > 0.0
    octant = ((state[3] > 0.0).to(torch.int32) + 2 * (state[4] > 0.0).to(torch.int32)
              + 4 * (state[5] > 0.0).to(torch.int32))
    keys = torch.where(alive, octant, 8)
    idx = torch.argsort(keys, stable=True).to(torch.int32)
    return idx, alive.sum().to(torch.int32).reshape(1)


def _on_list(state: torch.Tensor, idx: torch.Tensor, n_live: torch.Tensor, warps, run) -> None:
    """Gather the listed rays ``idx[:n_live]`` of ``state``, run ``run(listed,
    warps=, packets=)`` on them in place and write them back: the kernels'
    blocks are 128 consecutive entries of the list, whose superblock cull
    the traversals run."""
    ids = idx[:int(n_live.reshape(-1)[0])].to(torch.int64)
    listed = state[:, ids]
    run(listed, warps=None if warps is None else warps[ids],
        packets=kernel_core.linear_packets(ids.numel()).to(state.device))
    state[:, ids] = listed


def bounce_listed_stage(state: torch.Tensor, idx: torch.Tensor, n_live: torch.Tensor,
                        cset: ClusterSet, uniforms: np.ndarray, mats: np.ndarray,
                        lights: np.ndarray, cfg: StaticConfig, depth: int,
                        prims: torch.Tensor, n_sph: int, n_box: int, warps=None,
                        cset_shadow=None, mxu: str = "off") -> None:
    """Plain version of the bounce kernel: one bounce at ``depth`` on the
    listed rays ``idx[:n_live]`` of ``state`` (from :func:`compact_plain`),
    gathered, bounced and written back in place. Every live ray is listed
    and a dead ray's bounce changes nothing, so this equals
    :func:`bounce_stage` on the whole state bit for bit. ``warps``: an
    optional ray id -> warp map [N] (:func:`kernel_core.traverse`).
    ``cset_shadow``: the cluster set the shadow rays walk; ``mxu``: the
    pair test's form."""
    _on_list(state, idx, n_live, warps, lambda st, **kw: bounce_stage(
        st, cset, uniforms, mats, lights, cfg, depth, prims, n_sph, n_box,
        cset_shadow=cset_shadow, mxu=mxu, **kw))


def trace_listed_stage(state: torch.Tensor, idx: torch.Tensor, n_live: torch.Tensor,
                       cset: ClusterSet, prims: torch.Tensor, n_sph: int, n_box: int,
                       warps=None, mxu: str = "off") -> None:
    """Plain version of the trace kernel (``_make_bounce_kernel(mode="trace")``,
    trace_wavefront.py:439-499) on the listed rays of a 24-row ``state``,
    in place: count and trace them, store the hit record in rows 15-19;
    ``mxu``: the closest hit takes the tensor-core form in either mode."""
    check_mxu(mxu)
    mx = kernel_core.mxu_mode(cset, mxu) != "off"
    _on_list(state, idx, n_live, warps, lambda st, **kw: kernel_core.rec_store(
        st, kernel_core.bounce_trace(cset, st, prims=prims, n_sph=n_sph, n_box=n_box, mx=mx,
                                     **kw)))


def shade_listed_stage(state: torch.Tensor, idx: torch.Tensor, n_live: torch.Tensor,
                       cset: ClusterSet, uniforms: np.ndarray, mats: np.ndarray,
                       lights: np.ndarray, cfg: StaticConfig, depth: int,
                       prims: torch.Tensor, n_sph: int, n_box: int, warps=None,
                       mxu: str = "off") -> None:
    """Plain version of the shade kernel on a bounce's list: :func:`shade_stage`
    on the listed rays, the same list the depth's trace took (``cset``: the
    set the shadow rays walk; ``mxu`` as there)."""
    _on_list(state, idx, n_live, warps, lambda st, **kw: shade_stage(
        st, cset, uniforms, mats, lights, cfg, depth, prims, n_sph, n_box, mxu=mxu, **kw))


def finalize(state: torch.Tensor, cfg: StaticConfig, band: int, rays_on_device: bool = False):
    """AA mean and untile -> (image [band, W, 3], rays traced).

    The samples of a pixel are consecutive ids; they are summed in sample
    order and divided by aa. The ray count is summed in int64 (a float32
    sum drops integers above 2^24): an int, or with ``rays_on_device`` an
    int64 tensor on the state's device, which the host does not wait for."""
    aa = max(1, cfg.aa_samples)
    colors = state[9:12].reshape(3, band, cfg.width, aa)
    acc = colors[..., 0]
    for k in range(1, aa):
        acc = acc + colors[..., k]
    if aa > 1:
        acc = _div(acc, float(aa))
    img = acc.permute(1, 2, 0).contiguous()
    rays = state[ROW_COUNT].to(torch.int64).sum()
    return img, (rays if rays_on_device else int(rays))


def frame_inputs(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                 row_offset, device, prims, prim_counts):
    """Check the device and put a render's inputs in the form the stages
    take -> (uniforms with the row offset, lights, mats as numpy, prims
    table, n_sph, n_box). Shared by the wavefront, megakernel and debug
    renders. The materials are the cluster set's host copy, so nothing
    is read back from the device."""
    dev = cset.device if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if cset.device != dev:
        raise ValueError(f"cluster set lives on {cset.device}, not {dev}")
    uniforms = np.array(uniforms, F32)
    uniforms[U_ROW_OFF] = F32(row_offset)
    lights = np.ascontiguousarray(lights, F32)
    prims, n_sph, n_box = kernel_core.prim_table(prims, prim_counts, dev)
    return uniforms, lights, cset.mats_host, prims, n_sph, n_box


def stages(cset: ClusterSet, fb, cfg: StaticConfig, band: int, prims: torch.Tensor,
           n_sph: int, n_box: int, plain: bool = False, cset_primary=None, cset_shadow=None,
           fission: bool = False, mxu: str = "off") -> torch.Tensor:
    """The primary stage and the ``max_depth - 1`` bounce stages of the
    frame in ``fb`` (a written
    :class:`~cosig_tpu_torch.kernels.binding.FrameBuffer`) -> the final
    ray state f32 [16, N] (24 rows with ``fission``). ``plain``: the plain
    versions on the cluster set's device, else the kernels' wrappers, which
    dispatch by device. ``fission``, ``cset_primary``, ``cset_shadow``: the
    forms of the module docstring; with ``fission`` a frame is primary
    trace, shade, then per depth compaction, trace and shade; ``mxu``: the
    pair test's form of every stage (the shade's shadow rays exact on a
    separate shadow set). Nothing here
    reads the device from the host, so a stream capture can record it
    (:mod:`cosig_tpu_torch.ops.frame_graph`)."""
    from cosig_tpu_torch.kernels import wavefront as kw

    pcs = cset if cset_primary is None else cset_primary
    # The sets the shadow rays walk: in the primary stage, and in the bounces.
    p_sh = pcs if cset_shadow is None else cset_shadow
    b_sh = cset if cset_shadow is None else cset_shadow
    pk = (prims, n_sph, n_box)
    # The fission primary traces no shadow rays: its shade walks p_sh.
    primary_shadow = None if fission else cset_shadow
    # The shade's shadow rays: exact on a separate shadow set.
    sh_mxu = mxu if cset_shadow is None else "off"
    if plain:
        u, m, li = fb.uniforms, fb.mats, fb.lights
        state = primary_stage(pcs, u, m, li, cfg, band, *pk, fission=fission,
                              cset_shadow=primary_shadow, mxu=mxu)
        if fission:
            primary_shade(state, p_sh, u, m, li, cfg, *pk, mxu=sh_mxu)
        for depth in range(1, cfg.max_depth):
            idx, n_live = compact_plain(state)
            if fission:
                trace_listed_stage(state, idx, n_live, cset, *pk, mxu=mxu)
                shade_listed_stage(state, idx, n_live, b_sh, u, m, li, cfg, depth, *pk,
                                   mxu=sh_mxu)
            else:
                bounce_listed_stage(state, idx, n_live, cset, u, m, li, cfg, depth, *pk,
                                    cset_shadow=cset_shadow, mxu=mxu)
        return state
    state = kw.primary(pcs, fb, cfg, band, *pk, fission=fission, cset_shadow=primary_shadow,
                       mxu=mxu)
    if fission:
        kw.shade(state, None, None, p_sh, fb, cfg, 0, *pk, mxu=sh_mxu)
    # The list lengths side by side, so a traced frame reads them with one copy.
    lives = torch.empty(max(0, cfg.max_depth - 1), dtype=torch.int32, device=state.device)
    for depth in range(1, cfg.max_depth):
        idx, n_live = kw.compact(state, lives[depth - 1:depth])
        if fission:
            kw.trace(state, idx, n_live, cset, fb, cfg, depth, *pk, mxu=mxu)
            kw.shade(state, idx, n_live, b_sh, fb, cfg, depth, *pk, mxu=sh_mxu)
        else:
            kw.bounce(state, idx, n_live, cset, fb, cfg, depth, *pk, cset_shadow=cset_shadow,
                      mxu=mxu)
    return state


def one_frame(cset: ClusterSet, fb, cfg: StaticConfig, band: int, row_offset: int,
              prims: torch.Tensor, n_sph: int, n_box: int, plain: bool = False,
              cset_primary=None, cset_shadow=None, fission: bool = False, mxu: str = "off"):
    """One wavefront frame of ``band`` rows -> ``(img [band, W, 3], rays as
    an int64 tensor)`` on the cluster set's device, with no host read."""
    del row_offset  # in fb's uniforms; rows past the image start dead
    state = stages(cset, fb, cfg, band, prims, n_sph, n_box, plain, cset_primary, cset_shadow,
                   fission, mxu)
    return finalize(state, cfg, band, rays_on_device=True)


def trace_state(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                cfg: StaticConfig, rows: int | None = None, row_offset: int = 0,
                device=None, plain: bool = False, prims=None,
                prim_counts=(0, 0), cset_primary=None, cset_shadow=None,
                fission: bool = False, mxu: str = "off") -> torch.Tensor:
    """Run the primary stage and the ``max_depth - 1`` bounce stages ->
    the final ray state f32 [16, N], [24, N] with ``fission`` (arguments
    as in :func:`render_wavefront`)."""
    from cosig_tpu_torch.kernels import binding

    check_forms(cset, cset_primary, cset_shadow, mxu)
    band = cfg.height if rows is None else int(rows)
    uniforms, lights, mats, prims, n_sph, n_box = frame_inputs(
        cset, uniforms, lights, row_offset, device, prims, prim_counts)
    fb = binding.frame_buffer("cpu" if plain else cset.device, uniforms, mats, lights)
    return stages(cset, fb, cfg, band, prims, n_sph, n_box, plain, cset_primary, cset_shadow,
                  fission, mxu)


def render_wavefront(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                     cfg: StaticConfig, rows: int | None = None,
                     row_offset: int = 0, device=None, plain: bool = False,
                     prims=None, prim_counts=(0, 0), rays_on_device: bool = False,
                     cset_primary=None, cset_shadow=None, fission: bool = False,
                     mxu: str = "off"):
    """Render -> ``(img [rows, W, 3] f32 on device, rays traced)``.

    ``uniforms``/``lights`` come from :func:`kernel_core.build_uniforms` /
    :func:`kernel_core.build_lights`. ``rows``/``row_offset`` restrict the
    render to a band of global rows (projection and RNG seeds stay
    global). ``device`` must be where ``cset`` lives (default: there).
    ``plain=True`` runs the plain PyTorch stages on any device instead of
    dispatching by device (the kernels' reference on the card).
    ``prims``/``prim_counts``: the analytic sphere/box table of
    :func:`cosig_tpu_torch.ops.analytic.pack_prims_host` and its
    (n_sph, n_box), folded into every traversal. ``rays_on_device``: the
    ray count as an int64 tensor on the device, so that the host can queue
    more work before it reads the count (:func:`finalize`). Rows of a band
    past the image start dead: they are traced by no ray and count none.

    ``cset_primary`` (a finer cut of the same triangles for the primary
    stage), ``cset_shadow`` (a coarser cut, within one cull block, for
    every shadow ray) and ``fission`` (separate trace and shade stages):
    the JAX package's kernel forms (module docstring), each giving the
    fused single-set bits; defaults off, as there. ``mxu``: the pair test's
    form (``"off"``, ``"full"``, ``"closest"``; module docstring).

    This is the eager frame, one launch per stage from the host; a
    :class:`~cosig_tpu_torch.ops.frame_graph.FrameGraph` captures the
    same launches once and replays them (the Renderer's frames on the
    card)."""
    state = trace_state(cset, uniforms, lights, cfg, rows, row_offset, device, plain,
                        prims, prim_counts, cset_primary, cset_shadow, fission, mxu)
    return finalize(state, cfg, state.shape[1] // (cfg.width * max(1, cfg.aa_samples)),
                    rays_on_device)


def render_chain(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                 cfg: StaticConfig, k: int, prims=None, prim_counts=(0, 0),
                 cset_primary=None, cset_shadow=None, fission: bool = False,
                 mxu: str = "off"):
    """Render the same frame ``k`` times through the wavefront on the
    cluster set's device, queued with no host read in between -> ``(last
    image [H, W, 3], total rays of the k frames as an int)``; the
    wavefront's counterpart of ``trace_megakernel.render_chain`` and of
    the JAX package's wavefront chain (``bench.py:121-140``). On the card
    the frame is captured once as a CUDA graph and replayed k times; on
    the CPU the plain stages run k times. Timing two chain lengths and
    taking the slope gives the device time per frame. ``cset_primary``,
    ``cset_shadow``, ``fission``, ``mxu``: as in :func:`render_wavefront`."""
    from cosig_tpu_torch.ops import frame_graph

    return frame_graph.render_chain("wavefront", cset, uniforms, lights, cfg, k, prims,
                                    prim_counts, cset_primary=cset_primary,
                                    cset_shadow=cset_shadow, fission=fission, mxu=mxu)
