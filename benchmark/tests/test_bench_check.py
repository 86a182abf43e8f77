"""The reservoir of kept frames and the ray count's number."""

import random

import numpy as np
import torch

from benchmark import check


def test_reservoir_keeps_each_frames_pixels_not_its_image():
    width, height, frames = 64, 48, 40
    keep = check.Reservoir(random.Random(3), width, height, size=4)
    images = [torch.rand(height, width, 3) for _ in range(frames)]
    for i, image in enumerate(images):
        keep.offer(i % 7, image, 1000 + i)
    held = [item[3] for item in keep.items]
    assert all(tuple(c.shape) == (check.PIXELS, 3) for c in held)
    assert not any(c.data_ptr() == image.data_ptr() for c in held for image in images)
    kept = keep.kept()
    assert len(kept) == 4 and keep.items == []
    for pose, (px, py), colours, rays in kept:
        i = rays - 1000
        assert pose == i % 7
        np.testing.assert_array_equal(colours, images[i].numpy()[py, px])


def test_reservoir_draws_alike_from_one_seed():
    def kept(seed):
        keep = check.Reservoir(random.Random(seed), 16, 16, size=3)
        for i in range(50):
            keep.offer(i, torch.full((16, 16, 3), float(i)), i)
        return [(pose, rays, px.tolist()) for pose, (px, _), _, rays in keep.kept()]

    assert kept(11) == kept(11)
    assert kept(11) != kept(12)


def test_rays_gap_reads_the_estimate_from_the_pixels():
    want = np.array([2.0, 4.0, 6.0])
    assert check.rays_gap(400, want, 100) == 0.0
    assert check.rays_gap(800, want, 100) == 1.0
    assert check.numbers(np.zeros((3, 3)), np.zeros((3, 3)), (200, want, 100))["rays_gap"] == 0.5
    assert "rays_gap" not in check.numbers(np.zeros((3, 3)), np.zeros((3, 3)))
