"""What decides ``correct``: frames of the timed window against the plain
reference.

A frame's answer is its image and the count of rays it traced; every
pixel can be checked by itself, since the reference traces a pixel from
its coordinates alone. So a run keeps ``FRAMES`` frames of its window,
drawn from the seed uniformly over every frame the window completed (a
reservoir: the choice is made as frames complete), and ``PIXELS`` pixels
of each, drawn from the seed before the window. A frame that enters the
reservoir is kept as those pixels' colours, gathered on the device, and
the rays the program reported for it: never as its whole image, so the
check holds 8 x 2,048 colours on the card, not 8 images. Once the window
has closed and the program's state is freed, the reference
(:mod:`benchmark.reference`) traces those pixels at the frame's own
camera pose, from the scene file and the settings alone, and each kept
frame gives these numbers:

* ``rmse``: the root mean square of the gaps over its pixels' channels;
* ``off_share``: the share of its pixels whose largest channel gap
  passes ``OFF_ABS`` (1e-3, the per-pixel tolerance that the project's
  backends hold among themselves);
* ``rays_gap``: the gap between the rays the program reported for the
  frame and the reference's estimate of them (the mean of its pixels'
  rays, over their AA samples, times the frame's pixels), as a share of
  the estimate. It holds the numerator of ``mrays_per_s`` to the
  reference; the sampling error of 2,048 pixels is its floor.

A frame fails when one of the numbers that the cell's limits file
(``benchmark/limits/<cell>.json``) names passes its limit; the run
reports the worst of each over its kept frames beside the limit. The lower-precision control, the
reference in bfloat16 put in the program's place, is computed by the
same code with ``dtype=torch.bfloat16`` (:mod:`benchmark.control`).
"""

from __future__ import annotations

import numpy as np

FRAMES = 8
PIXELS = 2048
OFF_ABS = 1e-3


class Reservoir:
    """Up to ``size`` frames drawn uniformly from a stream of frames, the
    draws taken from ``rng``. Each slot has its pixels, drawn from ``rng``
    here; a frame that enters a slot is kept as (frame index, pose, the
    slot's pixels (px, py), their colours on ``device``, the frame's rays)."""

    def __init__(self, rng, width: int, height: int, device="cpu", size: int = FRAMES):
        import torch

        self.rng, self.size, self.items, self.seen = rng, size, [], 0
        self.picks = [pick_pixels(rng, width, height) for _ in range(size)]
        self.index = [(torch.as_tensor(py, device=device), torch.as_tensor(px, device=device))
                      for px, py in self.picks]

    def offer(self, pose: int, image, rays: int) -> None:
        if len(self.items) < self.size:
            j = len(self.items)
            self.items.append(None)
        else:
            j = self.rng.randrange(self.seen + 1)
        if j < self.size:
            iy, ix = self.index[j]
            self.items[j] = (self.seen, pose, self.picks[j], image[iy, ix], int(rays))
        self.seen += 1

    def kept(self) -> list:
        """[(pose, (px, py), colours [n, 3] numpy, rays)] of the kept
        frames; the reservoir is emptied."""
        out = [(pose, pick, colours.float().cpu().numpy(), rays)
               for _, pose, pick, colours, rays in self.items]
        self.items.clear()
        return out


def pick_pixels(rng, width: int, height: int, n: int = PIXELS):
    """``n`` distinct pixels (all of a smaller frame) -> (px, py) int arrays."""
    n = min(n, width * height)
    flat = np.array(sorted(rng.sample(range(width * height), n)), dtype=np.int64)
    return flat % width, flat // width


def reference_pixels(scene_path: str, pose_kwargs: list, px_py: list, device, dtype=None,
                     count_work: bool = False) -> tuple:
    """(the reference's colours [n, 3] at each (pose keyword arguments, (px,
    py)) pair, its rays [n] there (summed over the AA samples), work) in
    ``dtype`` (float32 by default). With
    ``count_work``, ``work`` is the box and triangle tests that the rays
    traced need (:class:`benchmark.reference.bvh.WorkCount`) and the
    scene's triangle count, else None."""
    import torch

    from benchmark.reference import frame, parser, settings, trace
    from benchmark.reference.bvh import WorkCount
    from benchmark.reference.tessellate import extract_triangles

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = parser.load_scene(scene_path)
    tris = extract_triangles(scene)
    arrays = frame.compile_scene(scene, tris, device=device,
                                 dtype=torch.float32 if dtype is None else dtype)
    count = WorkCount(tris, device) if count_work else None
    out, rays = [], []
    for kw, (px, py) in zip(pose_kwargs, px_py):
        s = settings.RenderSettings(**kw)
        params = frame.frame_params(scene, s)
        cfg = frame.static_config(scene, s)
        fx = torch.as_tensor(px, dtype=torch.float32, device=device)
        fy = torch.as_tensor(py, dtype=torch.float32, device=device)
        colour, r = trace.trace_pixels(arrays, params, cfg, fx, fy, count=count)
        out.append(colour.float().cpu().numpy())
        rays.append(r.to(torch.float64).cpu().numpy())
    work = dict(count.run(), triangles=int(tris.count)) if count_work else None
    return out, rays, work


def rays_gap(got_rays: float, want_rays: np.ndarray, pixels: int) -> float:
    """The frame's reported rays against the reference's estimate from its
    pixels' rays ``want_rays``, scaled to the frame's ``pixels``."""
    estimate = float(np.mean(want_rays)) * pixels
    return abs(float(got_rays) - estimate) / estimate if estimate > 0 else float("inf")


def numbers(got: np.ndarray, want: np.ndarray, rays: tuple | None = None) -> dict:
    """One frame's numbers: its colours ``got`` against the reference's
    ``want``; with ``rays`` = (the frame's reported rays, the reference's
    rays at its pixels, the frame's pixels), ``rays_gap`` too."""
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    gap = np.where(np.isnan(gap), np.inf, gap)
    out = {"rmse": float(np.sqrt(np.mean(gap ** 2))),
           "off_share": float(np.mean(gap.max(axis=1) > OFF_ABS)),
           "max_gap": float(gap.max())}
    if rays is not None:
        out["rays_gap"] = rays_gap(*rays)
    return out


def judge(per_frame: list, limits: dict) -> tuple:
    """(checks, failed): for each number the cell's limits name, the worst
    over the kept frames beside its limit, and the count of frames over
    any limit (a NaN counts as over)."""
    checks = {name: {"value": max(f[name] for f in per_frame), "limit": lim["limit"]}
              for name, lim in limits.items()}
    failed = sum(any(not f[name] <= lim["limit"] for name, lim in limits.items())
                 for f in per_frame)
    return checks, failed
