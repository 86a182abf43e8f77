"""Megakernel render and debug render: the second path of the renderer.

Counterpart of :mod:`cosig_tpu.ops.trace_pallas` (the JAX package's
``backend="pallas"``); nothing here is Pallas, so the module is named for
what it does.

* :func:`render_clusters` renders each pixel in one pass: every AA sample
  in order, each through up to ``max_depth`` bounces, then the colour mean
  and the pixel's ray count (``trace_pallas.py:132-288``). The mean is
  ``acc * float32(1/aa)`` as on the TPU (``:282-285``), where the
  wavefront divides by aa; so the two renders give the same bits when aa
  is a power of two, and differ by that one rounding otherwise.
* :func:`render_chain` queues the same frame k times, the counterpart of
  ``trace_pallas.render_chain``: on the card, k replays of one CUDA graph.
* :func:`render_debug` shoots one perspective centre ray per pixel, even
  under the orthographic toggle, and shows depth (mode 1), normals (mode
  2) or hit/miss (mode 3) (``trace_pallas.py:438-513``).

``mxu="full"`` runs the megakernel's closest hits and shadow rays with the
tensor-core form of the pair test (:func:`kernel_core.traverse` ``mx``),
the JAX package's megakernel under ``COSIG_MXU`` (``trace_pallas.py:88-106``),
which has full mode only: ``"closest"`` is refused (:func:`check_mxu`).
The debug view keeps the exact test, as there.

Both dispatch by device as :mod:`cosig_tpu_torch.ops.trace_wavefront`
does: on a CUDA cluster set they launch the kernels of ``csrc/megakernel.cu``
through :mod:`cosig_tpu_torch.kernels.megakernel`, on the CPU they run the
plain versions below, which reuse the wavefront's camera rays and
``kernel_core.bounce_core``/``traverse``.
"""

from __future__ import annotations

import numpy as np
import torch

from cosig_tpu_torch.accel.clusters import ClusterSet
from cosig_tpu_torch.models.soa import StaticConfig
from cosig_tpu_torch.ops import camera, kernel_core
from cosig_tpu_torch.ops.kernel_core import (
    ROW_ALIVE,
    ROW_COUNT,
    STATE_ROWS,
    U_CAM,
    U_DIST,
    U_PLANE_H,
    U_ROW_OFF,
    _rsqrt3,
)
from cosig_tpu_torch.ops.intersect import _div
from cosig_tpu_torch.ops.trace_wavefront import frame_inputs

F32 = np.float32


def _pixel_planes(cfg: StaticConfig, band: int, row_offset: float, dev):
    """(px, py) float32 planes of the band's pixels in order py_local * W + px;
    py is global."""
    pid = torch.arange(band * cfg.width, device=dev, dtype=torch.int64)
    px = (pid % cfg.width).to(torch.float32)
    py = (pid // cfg.width).to(torch.float32) + row_offset
    return px, py


# The tiles of the megakernel and the debug kernel (csrc/megakernel.cu): a
# block of 16 x 8 pixels, four warps of 8 x 4.
TILE_W, TILE_H, WARP_W, WARP_H = 16, 8, 8, 4


def tile_slots(width: int, band: int) -> torch.Tensor:
    """Thread slot -> pixel id (py_local * W + px) of the megakernel and the
    debug kernel, the index math of csrc/megakernel.cu: block b covers tile (b % tiles_x,
    b // tiles_x), warp w of it the 8 x 4 pixels at (w % 2, w // 2), lane
    l pixel (l % 8, l // 8); -1 on threads outside the width or the band."""
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-band // TILE_H)
    t = torch.arange(tiles_x * tiles_y * 128, dtype=torch.int64)
    b, w, lane = t // 128, (t % 128) // 32, t % 32
    x = (b % tiles_x) * TILE_W + (w % 2) * WARP_W + lane % WARP_W
    y = (b // tiles_x) * TILE_H + (w // 2) * WARP_H + lane // WARP_W
    return torch.where((x < width) & (y < band), y * width + x, -1)


def tile_packets(width: int, band: int) -> torch.Tensor:
    """Block id [band * W] of each pixel of the megakernel and the debug
    kernel (:func:`tile_slots`)."""
    return kernel_core.warp_of_rays(tile_slots(width, band), band * width) // 4


def check_mxu(mxu: str) -> None:
    """Raise unless ``mxu`` is a mode of the megakernel: ``"off"`` or
    ``"full"`` (the JAX megakernel has no closest-only mode)."""
    if mxu not in ("off", "full"):
        raise ValueError(f"the megakernel takes mxu 'off' or 'full', got {mxu!r} (the JAX "
                         "package's megakernel runs the MXU form in full mode only)")


def megakernel_plain(cset: ClusterSet, uniforms: np.ndarray, mats: np.ndarray,
                     lights: np.ndarray, cfg: StaticConfig, band: int,
                     prims: torch.Tensor, n_sph: int, n_box: int,
                     warps=None, mxu: str = "off") -> torch.Tensor:
    """Plain version of the megakernel -> f32 [4, band * W] (rgb mean, ray
    count) on the cluster set's device. ``warps``: an optional pixel ->
    warp map whose pair-loop slots the traversals count
    (:func:`kernel_core.traverse`). The traversals run the kernel's
    pre-filters on its 16 x 8 pixel blocks, the frustum cull at depth 0
    (JAX: trace_pallas.py:187-198,272). ``mxu``: ``"off"`` or ``"full"``
    (:func:`check_mxu`, then :func:`kernel_core.mxu_mode`)."""
    check_mxu(mxu)
    mxu = kernel_core.mxu_mode(cset, mxu)
    dev = cset.device
    u = [float(x) for x in uniforms]
    px, py = _pixel_planes(cfg, band, u[U_ROW_OFF], dev)
    packets = tile_packets(cfg.width, band).to(dev)
    aa = max(1, cfg.aa_samples)
    acc_r = torch.zeros_like(px)
    acc_g = torch.zeros_like(px)
    acc_b = torch.zeros_like(px)
    state = torch.zeros((STATE_ROWS, px.shape[0]), dtype=torch.float32, device=dev)
    for s in range(aa):
        s_plane = torch.full_like(px, float(s))
        for row, plane in enumerate(camera.primary_rays(cfg, u, px, py, s_plane)):
            state[row] = plane
        state[6:9] = 1.0
        state[9:12] = 0.0
        state[ROW_ALIVE] = 1.0  # as on the TPU, every row of the band is traced
        for depth in range(cfg.max_depth):
            if not bool((state[ROW_ALIVE] > 0.0).any()):
                break  # a bounce on dead rays changes nothing
            kernel_core.bounce_core(cfg, uniforms, mats, lights, cset, state,
                                    px, py, s_plane, depth=depth,
                                    is_last=depth == cfg.max_depth - 1,
                                    prims=prims, n_sph=n_sph, n_box=n_box, warps=warps,
                                    packets=packets, frustum=depth == 0, mxu=mxu)
        acc_r = acc_r + state[9]
        acc_g = acc_g + state[10]
        acc_b = acc_b + state[11]
    inv_aa = float(F32(1.0 / aa))
    return torch.stack([acc_r * inv_aa, acc_g * inv_aa, acc_b * inv_aa, state[ROW_COUNT]])


def debug_plain(cset: ClusterSet, uniforms: np.ndarray, mats: np.ndarray,
                lights: np.ndarray, cfg: StaticConfig, prims: torch.Tensor,
                n_sph: int, n_box: int) -> torch.Tensor:
    """Plain version of the debug kernel -> f32 [4, H * W] (rgb, count 1),
    its traversal with the kernel's pre-filters on 16 x 8 pixel blocks, the
    frustum cull among them (JAX: trace_pallas.py:480-490)."""
    del mats, lights  # the debug views read geometry only
    dev = cset.device
    u = [float(x) for x in uniforms]
    px, py = _pixel_planes(cfg, cfg.height, u[U_ROW_OFF], dev)
    cam = u[U_CAM:U_CAM + 12]
    plane_h = u[U_PLANE_H]
    plane_w = float(F32(plane_h) * F32(cfg.width / cfg.height))
    ocz = torch.full_like(px, u[U_DIST])
    # trace_pallas.py:469-480, operation for operation.
    uu = (_div(px + 0.5, float(cfg.width)) - 0.5) * plane_w
    vv = (_div(py + 0.5, float(cfg.height)) - 0.5) * plane_h
    dcx, dcy, dcz = _rsqrt3(uu, vv, -ocz)
    ox = cam[2] * ocz + cam[3]
    oy = cam[6] * ocz + cam[7]
    oz = cam[10] * ocz + cam[11]
    dx = cam[0] * dcx + cam[1] * dcy + cam[2] * dcz
    dy = cam[4] * dcx + cam[5] * dcy + cam[6] * dcz
    dz = cam[8] * dcx + cam[9] * dcy + cam[10] * dcz
    dx, dy, dz = _rsqrt3(dx, dy, dz)
    hit, t, nx, ny, nz, _ = kernel_core.traverse(
        cset, ox, oy, oz, dx, dy, dz, torch.ones_like(px, dtype=torch.bool),
        prims=prims, n_sph=n_sph, n_box=n_box,
        packets=tile_packets(cfg.width, cfg.height).to(dev), frustum=True,
    )
    if cfg.debug_mode == 1:
        d = _div(t, 100.0)
        rgb = (torch.where(hit, d, 1.0), torch.where(hit, d, 0.0), torch.where(hit, d, 0.0))
    elif cfg.debug_mode == 2:
        rgb = (torch.where(hit, nx * 0.5 + 0.5, 0.0), torch.where(hit, ny * 0.5 + 0.5, 0.0),
               torch.where(hit, nz * 0.5 + 0.5, 1.0))
    else:
        rgb = (torch.where(hit, 0.0, 0.2), torch.where(hit, 1.0, 0.2),
               torch.where(hit, 0.0, 0.2))
    return torch.stack([*rgb, torch.ones_like(px)])


def _image(out: torch.Tensor, width: int, band: int, counted: int, rays_on_device: bool):
    """[4, band * W] kernel output -> (image [band, W, 3], rays of the first
    ``counted`` rows summed in int64: an int, or with ``rays_on_device``
    an int64 tensor on the output's device)."""
    img = out[:3].reshape(3, band, width).permute(1, 2, 0).contiguous()
    rays = out[3, :counted * width].to(torch.int64).sum()
    return img, (rays if rays_on_device else int(rays))


def one_frame(cset: ClusterSet, fb, cfg: StaticConfig, band: int, row_offset: int,
              prims: torch.Tensor, n_sph: int, n_box: int, plain: bool = False,
              mxu: str = "off"):
    """One megakernel frame of ``band`` rows at global row ``row_offset``
    from the frame in ``fb`` (a written
    :class:`~cosig_tpu_torch.kernels.binding.FrameBuffer`) -> ``(img [band,
    W, 3], rays of the rows inside the image as an int64 tensor)`` on the
    cluster set's device, with no host read. ``plain``: the plain version;
    ``mxu``: the pair test's form."""
    from cosig_tpu_torch.kernels import megakernel as km

    if plain:
        out = megakernel_plain(cset, fb.uniforms, fb.mats, fb.lights, cfg, band, prims, n_sph,
                               n_box, mxu=mxu)
    else:
        out = km.megakernel(cset, fb, cfg, band, prims, n_sph, n_box, mxu=mxu)
    counted = max(0, min(band, cfg.height - int(row_offset)))
    return _image(out, cfg.width, band, counted, True)


def debug_frame(cset: ClusterSet, fb, cfg: StaticConfig, band: int, row_offset: int,
                prims: torch.Tensor, n_sph: int, n_box: int, plain: bool = False):
    """One debug view of the whole frame (``band`` must be the height, at
    row 0) -> ``(img [H, W, 3], rays = H * W as an int64 tensor)``, with
    no host read. ``plain``: the plain version."""
    from cosig_tpu_torch.kernels import megakernel as km

    if band != cfg.height or row_offset != 0:
        raise ValueError("the debug view renders whole frames only")
    if cfg.debug_mode not in (1, 2, 3):
        raise ValueError(f"debug_mode must be 1, 2 or 3, got {cfg.debug_mode}")
    if plain:
        out = debug_plain(cset, fb.uniforms, fb.mats, fb.lights, cfg, prims, n_sph, n_box)
    else:
        out = km.debug(cset, fb, cfg, prims, n_sph, n_box)
    return _image(out, cfg.width, cfg.height, cfg.height, True)


def render_clusters(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                    cfg: StaticConfig, rows: int | None = None, row_offset: int = 0,
                    device=None, plain: bool = False, prims=None, prim_counts=(0, 0),
                    rays_on_device: bool = False, mxu: str = "off"):
    """Render through the megakernel -> ``(img [rows, W, 3] f32 on device,
    rays traced)``. Arguments as in
    :func:`cosig_tpu_torch.ops.trace_wavefront.render_wavefront`: a band of
    global rows, ``plain=True`` for the plain version on any device, the
    analytic primitives, the ray count as a device tensor, and ``mxu``
    (``"off"`` or ``"full"``, :func:`check_mxu`). Unlike the
    wavefront, rows of a band past the image are traced like the others,
    as on the TPU; their rays are not counted, so a frame cut into bands
    counts the rays of the frame (the TPU's sharded render counts them,
    ``trace_pallas.py:597-598`` summing a band's rows up to the global
    height). This is the eager frame; the Renderer's frames on the card
    replay it as a CUDA graph (:mod:`cosig_tpu_torch.ops.frame_graph`)."""
    from cosig_tpu_torch.kernels import binding

    check_mxu(mxu)
    band = cfg.height if rows is None else int(rows)
    uniforms, lights, mats, prims, n_sph, n_box = frame_inputs(
        cset, uniforms, lights, row_offset, device, prims, prim_counts)
    fb = binding.frame_buffer("cpu" if plain else cset.device, uniforms, mats, lights)
    img, rays = one_frame(cset, fb, cfg, band, row_offset, prims, n_sph, n_box, plain, mxu)
    return img, (rays if rays_on_device else int(rays))


def render_chain(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                 cfg: StaticConfig, k: int, prims=None, prim_counts=(0, 0), mxu: str = "off"):
    """Render the same frame ``k`` times through the megakernel on the
    cluster set's device, queued with no host read in between -> ``(last
    image [H, W, 3], total rays of the k frames as an int)``; the
    counterpart of ``trace_pallas.py:612-636``. On the card the frame is
    captured once as a CUDA graph and replayed k times, as the JAX
    version runs its k frames in one dispatch; on the CPU the plain
    version runs k times.

    Timing two chain lengths and taking the slope gives the device time
    per frame without the host's wait at the end. The JAX version threads
    a zero that depends on the previous image into each frame, so that XLA
    cannot hoist the loop-invariant render out of its scan; PyTorch runs
    each replay as it comes, so nothing of the kind is needed here.
    ``mxu``: as in :func:`render_clusters`."""
    from cosig_tpu_torch.ops import frame_graph

    return frame_graph.render_chain("megakernel", cset, uniforms, lights, cfg, k, prims,
                                    prim_counts, mxu=mxu)


def render_debug(cset: ClusterSet, uniforms: np.ndarray, lights: np.ndarray,
                 cfg: StaticConfig, device=None, plain: bool = False, prims=None,
                 prim_counts=(0, 0)):
    """Debug view ``cfg.debug_mode`` (1, 2 or 3) -> ``(img [H, W, 3] f32 on
    device, rays = H * W)``; arguments as in :func:`render_clusters`."""
    from cosig_tpu_torch.kernels import binding

    if cfg.debug_mode not in (1, 2, 3):
        raise ValueError(f"debug_mode must be 1, 2 or 3, got {cfg.debug_mode}")
    uniforms, lights, mats, prims, n_sph, n_box = frame_inputs(
        cset, uniforms, lights, 0, device, prims, prim_counts)
    fb = binding.frame_buffer("cpu" if plain else cset.device, uniforms, mats, lights)
    img, rays = debug_frame(cset, fb, cfg, cfg.height, 0, prims, n_sph, n_box, plain)
    return img, int(rays)
