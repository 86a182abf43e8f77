"""One run of one cell of ``BENCHMARK.json``.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up loads the configuration's frozen
scene file with the port's parser, builds a
``cosig_tpu_torch.Renderer(device="cuda", backend="auto")`` (the kernels
build at first use, into the checkout) and renders the first frame,
which captures the frame's CUDA graph, then a few more. The window is a
closed loop: frames one after another, each one call of
``Renderer.render_to_device`` at the next camera pose of the orbit
(:mod:`benchmark.orbit`), for ``--seconds``. After the window the
frames that :mod:`benchmark.check` kept are compared with the plain
reference, and the last line of standard output is one JSON object:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a further stretch of frames under
torch.profiler (:mod:`benchmark.timeline`) by the readers in
``benchmark/metrics/``.

End-to-end metrics, host clock: ``frame_ms`` (the window over the frames
it completed), ``frame_ms_p95`` (the 95th percentile of the frames' own
times, each from the call to its return), ``mrays_per_s`` (the rays the
renderer reports for the window's frames over the window; the kept
frames' counts are held to the reference's, :mod:`benchmark.check`) and
``setup_s`` (from the process's start to the window's first frame). A
metric ``<base>.<cells>`` (``frame_ms.preview``) is ``<base>`` in the
cells it lists, under a bound of its own.

The run exits non-zero and prints no result without enough CUDA devices,
or if a module of JAX or of the JAX package is loaded once the window
has closed.
"""

import os
import sys
import time

_T0 = time.perf_counter()
if __name__ == "__main__":
    # A run caches compiled bytecode in a fixed directory inside the
    # checkout, like the kernels, also where the environment says not to
    # write it (PYTHONDONTWRITEBYTECODE) and the installed packages ship
    # none: else every run compiles torch's modules anew, seconds of set-up
    # that vary with the host's load. From the second run on, imports read
    # it there.
    sys.pycache_prefix = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                      ".bench_cache", "pyc")
    sys.dont_write_bytecode = False

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402

from benchmark import check, orbit, peaks, timeline  # noqa: E402
from benchmark.manifest import ROOT, Cell, reader  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cosig_tpu", "__graft_entry__")
WARM_FRAMES = 3
TRACE_SECONDS = 2.0
TRACE_FRAMES = 500
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


def _age_at_start() -> float:
    """Seconds from the process's start to this module's first line (Linux
    /proc, to the kernel's 10 ms tick); 0 where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age_now = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return max(0.0, age_now - (time.perf_counter() - _T0))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its kernels into ``cosig_tpu_torch/build/`` there."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


class Session:
    """The program under test, set up for one cell: the scene, the poses'
    settings and the renderer with its first frame rendered."""

    def __init__(self, cell: Cell, device: str = "cuda", start_pose: int = 0, mxu: str = "off"):
        marks = [("start", time.perf_counter())]
        import torch

        from cosig_tpu_torch import Renderer, RenderSettings, load_scene
        from cosig_tpu_torch.kernels import binding

        marks.append(("imports", time.perf_counter()))
        self.cell, self.device = cell, device
        self.launches = binding.LAUNCHES
        self.pose_kwargs = orbit.pose_settings(cell.config, cell.traffic)
        self.poses = [RenderSettings(**kw) for kw in self.pose_kwargs]
        self.scene = load_scene(cell.scene_path())
        marks.append(("scene", time.perf_counter()))
        self.renderer = Renderer(device=device, backend="auto", mxu=mxu)
        if device == "cuda":
            torch.zeros(1, device=device)  # the CUDA context
        marks.append(("device", time.perf_counter()))
        self.next_pose = start_pose
        self.frame()
        marks.append(("first_frame", time.perf_counter()))
        for _ in range(WARM_FRAMES):
            self.frame()
        marks.append(("warm", time.perf_counter()))
        self.first_frame_s = marks[-2][1] - marks[-3][1]
        # Seconds of each step of set-up, for the record on standard error.
        self.steps = {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
        self.width, self.height = self.poses[0].resolution_override
        self._sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def frame(self):
        """Render the next pose of the orbit -> the image on the device."""
        pose = self.next_pose
        self.next_pose = (pose + 1) % len(self.poses)
        return self.renderer.render_to_device(self.scene, self.poses[pose])

    def window(self, seconds: float, keep: check.Reservoir) -> dict:
        """The closed loop for ``seconds``; kept frames go to ``keep``."""
        gc.collect()
        self._sync()
        before = dict(self.launches)
        times, rays = [], 0
        t0 = t_end = time.perf_counter()
        while t_end - t0 < seconds:
            pose = self.next_pose
            t = time.perf_counter()
            image = self.frame()
            t_end = time.perf_counter()
            times.append(t_end - t)
            frame_rays = self.renderer.last_stats.rays_traced
            rays += frame_rays
            keep.offer(pose, image, frame_rays)
        return {"t0": t0, "frames": len(times), "window_s": t_end - t0, "frame_s": times,
                "rays": rays, "launches": {k: self.launches[k] - before[k] for k in before}}

    def close(self) -> None:
        """Free the program's state, and its memory on the device."""
        self.renderer = self.scene = None
        gc.collect()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()


def reservoir(session: Session, rng) -> check.Reservoir:
    """The run's reservoir of kept frames, its pixels drawn from ``rng``."""
    return check.Reservoir(rng, session.width, session.height, session.device)


def kept_pixels(session: Session, keep: check.Reservoir) -> tuple:
    """(each kept frame's pose settings, its pixels (px, py), the program's
    colours there, its reported rays); ``keep`` is emptied."""
    kept = keep.kept()
    return ([session.pose_kwargs[pose] for pose, _, _, _ in kept], [p for _, p, _, _ in kept],
            [c for _, _, c, _ in kept], [r for _, _, _, r in kept])


def compare(cell: Cell, session: Session, keep: check.Reservoir, device: str,
            count_work: bool = False) -> tuple:
    """The kept frames against the reference -> (per-frame numbers, work)."""
    kwargs, picks, got, got_rays = kept_pixels(session, keep)
    want, want_rays, work = check.reference_pixels(cell.scene_path(), kwargs, picks, device,
                                                   count_work=count_work)
    pixels = session.width * session.height
    return [check.numbers(g, w, (gr, wr, pixels))
            for g, w, gr, wr in zip(got, want, got_rays, want_rays)], work, picks


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        pre_steps: dict | None = None) -> tuple:
    """One run -> (result dict, the check lines for standard error).
    ``pre_steps``: seconds of the steps before set-up, for the record."""
    rng = random.Random(seed)
    n_poses = int(cell.traffic["orbit"]["poses"])
    session_t0 = time.perf_counter()
    session = Session(cell, device, orbit.start_pose(rng, n_poses))
    keep = reservoir(session, rng)
    setup_s = _age_at_start() + (time.perf_counter() - _T0)
    win = session.window(seconds, keep)
    result_device = {"platform": "gpu" if device == "cuda" else device,
                     "kind": "cpu", "count": cell.chips, "memory_peak_bytes": 0}
    if device == "cuda":
        import torch

        result_device["kind"] = torch.cuda.get_device_name(0)
        result_device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    tr = None
    if trace:
        tr = timeline.capture(session.frame, TRACE_SECONDS, TRACE_FRAMES)
    session.close()

    # The frames kept from the window, against the reference.
    width, height = session.width, session.height
    per_frame, work, picks = compare(cell, session, keep, device, count_work=trace)
    checks, failed = check.judge(per_frame, cell.limits)

    records = {"frames": win["frames"], "window_s": win["window_s"], "frame_s": win["frame_s"],
               "launches": win["launches"], "first_frame_s": session.first_frame_s,
               "trace": tr, "bound": None}
    if work is not None:
        scale = width * height / len(picks[0][0]) / len(picks)
        records["bound"] = peaks.frame_bound(work["box_tests"] * scale, work["tri_tests"] * scale,
                                             work["triangles"], width * height)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        w0, w1 = timeline.window(tr)
        result_device["busy_s"] = sum(e - s for s, e in timeline.busy_intervals(tr)) / 1e6
        result_device["window_s"] = (w1 - w0) / 1e6
        breakdown = {
            "device_ops": timeline.top((n, (e - s) / 1e6) for n, s, e in tr["device"]
                                       if w0 <= s < w1),
            "idle_gaps": timeline.top(timeline.idle_gaps(tr))}
    else:
        times = win["frame_s"] if len(win["frame_s"]) > 1 else win["frame_s"] * 2
        e2e = {"frame_ms": win["window_s"] / win["frames"] * 1e3,
               "frame_ms_p95": statistics.quantiles(times, n=100, method="inclusive")[94] * 1e3,
               "mrays_per_s": win["rays"] / win["window_s"] / 1e6,
               "setup_s": setup_s}
        # A metric ``<base>.<cells>`` is ``<base>`` under a bound of its own.
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": failed == 0 and win["frames"] > 0, "attempted": win["frames"],
              "failed": failed, "metrics": metrics, "device": result_device}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    steps = dict(interpreter=_age_at_start(), **(pre_steps or {}),
                 before_session=session_t0 - _T0 + _age_at_start(), **session.steps,
                 port_setup=win["t0"] - session_t0)
    lines = [f"setup steps (s): {json.dumps(steps)}"]
    lines += [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    cache_dirs()
    t_main = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    pre = {"harness": t_main - _T0, "torch": t_torch - t_main,
           "cuda_check": time.perf_counter() - t_torch}
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace), pre_steps=pre)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result))
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
