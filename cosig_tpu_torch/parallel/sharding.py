"""Render a frame in row bands, one band per device in a list.

Counterpart of :mod:`cosig_tpu.parallel.sharding` (``sharding.py:33-172``):

* geometry is small (a cluster set or a triangle soup of a few MB) and is
  **replicated**: one copy per distinct device of the list, made with
  ``ClusterSet.to`` (or the soup's ``Tensor.to``) when the call starts;
* the framebuffer is **sharded in row bands**: device ``i`` renders rows
  ``[i * band, (i + 1) * band)`` at their global pixel coordinates
  (``rows=``/``row_offset=``), so the projection and the RNG seeds are the
  single frame's and every band is the single frame's rows bit for bit;
* no collective runs during the frame: the bands are gathered onto the
  first device with ``torch.cat`` and cut to the image's height.

The band heights follow the JAX package's formulas, so each device gets
the rows it gets on the TPU: ``ceil(H / n)`` on the oracle path, a
multiple of the megakernel's tile rows on the megakernel (32, or 16 past
one cull superblock of clusters) and of the wavefront's primary block
rows on the wavefront. A band that lies wholly below the image is not
rendered.

Every band is queued on its device before any ray count is read: the
counts stay int64 tensors on their devices until all bands are queued, so
on several cards the bands run at once. (Each render still copies the
scene's material table, at most 2 KB, from its own device to the host,
which waits for that device's earlier work only.) Only rows inside the image count
rays, so a sharded frame counts the rays of the single frame; the JAX
package's ``render_sharded_pallas`` also counts the megakernel's padding
rows past the image. A band of the wavefront must hold fewer than 2^24
rays (``trace_wavefront.MAX_RAYS``: its ray ids ride a float32 row): when
``n`` is too small for that, the call raises before it queues any work.
The Renderer's frame on one device cuts itself into such bands with
:func:`wavefront_band` (``trace_wavefront.band_plan``), inside one graph.

The list of devices may repeat a device (``[cuda:0] * 4`` renders four
bands on one card, one after another) and may hold ``cpu``, where the
kernels' plain versions run. The kernel paths take ``mxu``, the pair
test's form, as their single renders do (the JAX package's sharded frames
run the MXU form whenever its stages do): a pair's planes do not depend on
which rays share a tile, so the banded tensor-core frame is the single
one bit for bit, as the exact one is. There is no ``render_sharded_jit``: PyTorch
runs eagerly, so there is nothing to compile.
"""

from __future__ import annotations

import dataclasses

import torch

from cosig_tpu_torch.accel.clusters import CULL_BLOCK, ClusterSet
from cosig_tpu_torch.models.soa import SceneArrays, StaticConfig
from cosig_tpu_torch.ops import trace_megakernel, trace_wavefront, trace_xla

# The JAX package's tile shapes that set its band heights
# (cosig_tpu/ops/trace_pallas.py:81-82, cosig_tpu/ops/trace_wavefront.py:131).
MEGAKERNEL_TILE_H = 32
MEGAKERNEL_TILE_H_PAST_CULL_BLOCK = 16
WAVEFRONT_TILE_RAYS = 4096


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """The devices to render on -> a list of ``torch.device``: ``devices``
    (default: every CUDA device), the first ``n_devices`` of them if
    given. Repeats and ``cpu`` are allowed."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if n_devices is not None:
        if not 1 <= n_devices <= len(out):
            raise ValueError(f"asked for {n_devices} devices, {len(out)} available")
        out = out[:n_devices]
    if not out:
        raise ValueError("no devices to render on")
    return out


def band_offsets(height: int, band: int, n: int) -> list:
    """Row offsets of the bands of ``band`` rows that hold a row of the
    image (of the ``n`` bands, those wholly below it are left out)."""
    return [i * band for i in range(n) if i * band < height]


def xla_band(height: int, n: int) -> int:
    """The oracle path's band height over ``n`` devices (sharding.py:59-60)."""
    return -(-height // n)


def megakernel_band(cset: ClusterSet, height: int, n: int, tile=None) -> int:
    """The megakernel's band height over ``n`` devices, a multiple of the
    tile rows (sharding.py:94-109)."""
    if tile is None:
        th = (MEGAKERNEL_TILE_H if int(cset.aabb_t.shape[1]) <= CULL_BLOCK
              else MEGAKERNEL_TILE_H_PAST_CULL_BLOCK)
    else:
        th = int(tile[0])
    return -(-height // (n * th)) * th


def primary_block(aa: int, tile_rays: int = WAVEFRONT_TILE_RAYS) -> tuple:
    """The JAX wavefront's pixel block (bh, bw), bh * bw * aa = tile_rays,
    both powers of two with bh <= bw (``trace_wavefront.py:281-290``)."""
    pixels = tile_rays // aa
    h = 1
    while h * h * 4 <= pixels:
        h *= 2
    return h, pixels // h


def wavefront_band(cfg: StaticConfig, n: int) -> int:
    """The wavefront's band height over ``n`` devices, a multiple of the
    primary block's rows (sharding.py:147-149)."""
    bh, _ = primary_block(max(1, cfg.aa_samples))
    return -(-cfg.height // (n * bh)) * bh


def _replicas(obj, devices: list, to) -> dict:
    """One copy of ``obj`` per distinct device, made with ``to(obj, device)``."""
    out = {}
    for d in devices:
        if d not in out:
            out[d] = to(obj, d)
    return out


def _arrays_to(arrays: SceneArrays, device) -> SceneArrays:
    return dataclasses.replace(arrays, **{
        f.name: getattr(arrays, f.name).to(device) for f in dataclasses.fields(arrays)})


def _gather(images: list, devices: list, height: int) -> torch.Tensor:
    return torch.cat([img.to(devices[0]) for img in images])[:height]


def render_sharded(arrays: SceneArrays, params, cfg: StaticConfig,
                   devices: list) -> torch.Tensor:
    """The oracle path (:func:`cosig_tpu_torch.ops.trace_xla.render_image`)
    in bands of ``ceil(H / n)`` rows -> image [H, W, 3] on ``devices[0]``;
    the image only, as the JAX function returns."""
    devices = make_mesh(devices=devices)
    band = xla_band(cfg.height, len(devices))
    copies = _replicas(arrays, devices, _arrays_to)
    images = [trace_xla.render_image(copies[dev], params, cfg, row_offset=off,
                                     rows=min(band, cfg.height - off))
              for dev, off in zip(devices, band_offsets(cfg.height, band, len(devices)))]
    return _gather(images, devices, cfg.height)


def _sharded(render, cset: ClusterSet, uniforms, lights, cfg: StaticConfig,
             devices: list, band: int, **kw):
    """Queue ``render`` of each band on its device (with the keywords
    ``kw``), then gather the image and read the ray counts -> (image [H,
    W, 3] on devices[0], rays)."""
    copies = _replicas(cset, devices, lambda c, d: c.to(d))
    images, rays = [], []
    for dev, off in zip(devices, band_offsets(cfg.height, band, len(devices))):
        img, r = render(copies[dev], uniforms, lights, cfg, rows=band, row_offset=off,
                        device=dev, rays_on_device=True, **kw)
        images.append(img)
        rays.append(r)
    image = _gather(images, devices, cfg.height)
    return image, sum(int(r) for r in rays)


def render_sharded_megakernel(cset: ClusterSet, uniforms, lights, cfg: StaticConfig,
                              devices: list, tile=None, mxu: str = "off"):
    """The megakernel (:func:`cosig_tpu_torch.ops.trace_megakernel.render_clusters`)
    in bands of a multiple of its tile rows -> ``(image [H, W, 3] on
    devices[0], rays traced as an int)``; the counterpart of
    ``render_sharded_pallas``. ``tile``: the JAX (rows, cols) tile whose
    rows set the band height (default: the JAX package's choice);
    ``mxu``: the pair test's form (``"off"`` or ``"full"``)."""
    trace_megakernel.check_mxu(mxu)  # raise before any band is queued
    devices = make_mesh(devices=devices)
    band = megakernel_band(cset, cfg.height, len(devices), tile)
    return _sharded(trace_megakernel.render_clusters, cset, uniforms, lights, cfg, devices,
                    band, mxu=mxu)


def render_sharded_wavefront(cset: ClusterSet, uniforms, lights, cfg: StaticConfig,
                             devices: list, mxu: str = "off"):
    """The wavefront (:func:`cosig_tpu_torch.ops.trace_wavefront.render_wavefront`)
    in bands of a multiple of the JAX primary block's rows -> ``(image [H,
    W, 3] on devices[0], rays traced as an int)``; ``mxu``: the pair test's
    form (``"off"``, ``"full"``, ``"closest"``). Raises the wavefront's
    ``ValueError`` if a band holds 2^24 rays or more."""
    trace_wavefront.check_mxu(mxu)
    devices = make_mesh(devices=devices)
    band = wavefront_band(cfg, len(devices))
    trace_wavefront.num_rays(cfg, band)  # raise before any band is queued
    return _sharded(trace_wavefront.render_wavefront, cset, uniforms, lights, cfg, devices,
                    band, mxu=mxu)
