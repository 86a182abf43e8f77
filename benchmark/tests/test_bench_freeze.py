"""The frozen scene files: each parses to the generator's scene as it was
when written, and its sha256 is the one its configuration records."""

import os

import pytest

from benchmark import freeze, manifest
from benchmark.manifest import ROOT, Cell, sha256_of
from benchmark.reference import parser as ref_parser
from cosig_tpu_torch.scene.generate import CONFIGS
from cosig_tpu_torch.scene.parser import load_scene

NAMES = [c["name"] for c in manifest.manifest()["configs"]]


@pytest.mark.parametrize("name", NAMES)
def test_file_parses_to_the_generators_scene(name):
    cfg = [w for w in manifest.manifest()["workloads"] if w["config"] == name][0]
    path = Cell(cfg["name"]).scene_path()  # checks the sha256
    scene, settings = CONFIGS[name]()
    assert load_scene(path) == scene
    published = Cell(cfg["name"]).config["published_settings"]
    assert tuple(published["resolution_override"]) == (scene.image.horizontal,
                                                      scene.image.vertical)
    assert (published["max_depth"], published["aa_samples"]) == (settings.max_depth,
                                                                 settings.aa_samples)


@pytest.mark.parametrize("name", NAMES)
def test_reference_parser_reads_the_same_scene(name):
    path = os.path.join(ROOT, "benchmark", "configs", f"{name}.txt")
    ours, theirs = ref_parser.load_scene(path), load_scene(path)
    assert ours.summary() == theirs.summary()
    for field in ("image", "camera", "lights", "materials", "spheres", "boxes"):
        assert repr(getattr(ours, field)) == repr(getattr(theirs, field))


@pytest.mark.parametrize("name", NAMES)
def test_writer_gives_the_same_bytes(name, tmp_path):
    scene, _ = CONFIGS[name]()
    path = os.path.join(ROOT, "benchmark", "configs", f"{name}.txt")
    with open(path) as f:
        first_line = f.readline().rstrip("\n")[3:]
    out = tmp_path / f"{name}.txt"
    out.write_text(freeze.scene_text(scene, first_line))
    assert sha256_of(str(out)) == sha256_of(path)
