"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (set-up, the window, the comparison
with the reference, the cell's own limits) on the CPU at a small frame,
without the harness's look for a card: ``Renderer(device="cpu",
backend="auto")`` is the port's oracle path there. Faults, each in the
frame as the renderer returns it: a frame that returns its state
unchanged (the first frame's image for every pose), half of the batch
left out with the mean taken over the rest (half of the AA samples, or
half of the rows), and an answer altered where it is produced: a
channel of the image, or the count of rays the frame reports. The
cells run on one card, so no exchange between cards can be left out.
The control, the reference in bfloat16 in the program's place, comes
out not correct too."""

import random

import pytest
import torch

from benchmark import check, control, orbit, run
from benchmark.manifest import Cell
from cosig_tpu_torch.render.renderer import Renderer

SIDE = 12
SECONDS = 0.5


def small(name):
    cell = Cell(name)
    cell.traffic["settings"]["resolution_override"] = [SIDE, SIDE]
    return cell


def broken(monkeypatch, fault):
    plain = Renderer.render_to_device
    first = {}

    def frame(self, scene, settings):
        if fault == "half_samples":
            settings = settings.replace(aa_samples=settings.aa_samples // 2)
        image = plain(self, scene, settings)
        if fault == "unchanged":
            return first.setdefault("image", image)
        if fault == "half_rows":
            image = image.clone()
            image[: image.shape[0] // 2] = 0.0
        if fault == "altered":
            image = image.clone()
            image[..., 0] += 1.0 / 255.0
        if fault == "rays_doubled":
            self.last_stats.rays_traced *= 2
        return image

    monkeypatch.setattr(Renderer, "render_to_device", frame)


@pytest.mark.parametrize("cell", ["large_mesh-orbit", "glass_sphere-orbit"])
def test_sound_run_is_correct(cell):
    result, lines = run.run(small(cell), 2**31 + 77, SECONDS, False, "cpu")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    tail = lines[-len(result["checks"]):]
    assert [line.split()[1] for line in tail] == list(result["checks"])
    assert set(result["metrics"]) == {"frame_ms", "frame_ms_p95", "mrays_per_s", "setup_s"}


@pytest.mark.parametrize("cell,fault", [
    ("glass_sphere-orbit", "unchanged"),
    ("glass_sphere-orbit", "half_samples"),
    ("glass_sphere-orbit", "altered"),
    ("large_mesh-orbit", "unchanged"),
    ("large_mesh-orbit", "half_rows"),
    ("large_mesh-orbit", "altered"),
    ("glass_sphere-orbit", "rays_doubled"),
    ("large_mesh-orbit", "rays_doubled"),
])
def test_broken_frame_is_not_correct(monkeypatch, cell, fault):
    broken(monkeypatch, fault)
    result, _ = run.run(small(cell), 2**31 + 78, SECONDS, False, "cpu")
    assert not result["correct"] and result["failed"] >= 1


@pytest.mark.parametrize("cell", ["glass_sphere-orbit", "large_mesh-orbit"])
def test_control_is_not_correct(cell):
    c = small(cell)
    rng = random.Random(2**31 + 79)
    kwargs = orbit.pose_settings(c.config, c.traffic)[:3]
    picks = [check.pick_pixels(rng, SIDE, SIDE) for _ in kwargs]
    want, _, _ = check.reference_pixels(c.scene_path(), kwargs, picks, "cpu")
    low, _, _ = check.reference_pixels(c.scene_path(), kwargs, picks, "cpu",
                                       dtype=torch.bfloat16)
    per_frame = [check.numbers(lo, w) for lo, w in zip(low, want)]
    # The control traces only the kept pixels: it has the colours' numbers.
    colours = {k: v for k, v in c.limits.items() if k in per_frame[0]}
    assert set(colours) == {"rmse", "off_share"}
    checks, failed = check.judge(per_frame, colours)
    assert failed == len(per_frame)
    assert all(v["value"] > v["limit"] for v in checks.values())
    assert control.worst(per_frame)["rmse"] == checks["rmse"]["value"]
