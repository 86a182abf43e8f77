"""Write a configuration's scene file once, from the port's procedural
generator, in the scene description format that the port's and the
reference's parsers read.

    python -m benchmark.freeze glass_sphere large_mesh

writes ``benchmark/configs/<name>.txt`` and prints each file's sha256,
which the configuration's ``.json`` records and the harness checks before
every run. Numbers are written with ``repr``, so the file parses back to
the generator's scene exactly (``benchmark/tests/test_bench_freeze.py``).
The harness never runs this module: a later change to the generator does
not move a frozen file.
"""

from __future__ import annotations

import hashlib
import os
import sys

from benchmark.manifest import ROOT

CONFIG_DIR = os.path.join(ROOT, "benchmark", "configs")


def _num(x) -> str:
    return repr(float(x)) if isinstance(x, float) else str(int(x))


def _nums(xs) -> str:
    return " ".join(_num(x) for x in xs)


def scene_text(scene, title: str) -> str:
    """The scene as text in the reference's description format."""
    out = [f"// {title}", ""]
    if scene.image is not None:
        im = scene.image
        out += ["Image", "{", f"\t{im.horizontal} {im.vertical}", f"\t{_nums(im.background)}", "}", ""]
    for i, comp in enumerate(scene.transformations):
        out += [f"Transformation // {i}", "{"]
        for e in comp.elements:
            out.append(f"\t{e.kind} {_nums(e.xyz)}" if e.kind in ("T", "S")
                       else f"\t{e.kind} {_num(e.angle_deg)}")
        out += ["}", ""]
    if scene.camera is not None:
        c = scene.camera
        out += ["Camera", "{", f"\t{c.transformation_index}", f"\t{_num(c.distance)}",
                f"\t{_num(c.vertical_fov_deg)}", "}", ""]
    for light in scene.lights:
        out += ["Light", "{", f"\t{light.transformation_index}", f"\t{_nums(light.rgb)}", "}", ""]
    for i, m in enumerate(scene.materials):
        out += [f"Material // {i}", "{", f"\t{_nums(m.color)}",
                f"\t{_nums((m.ambient, m.diffuse, m.specular, m.refraction, m.ior))}", "}", ""]
    for mesh in scene.triangle_meshes:
        out += ["Triangles", "{", f"\t{mesh.transformation_index}"]
        for t in mesh.triangles:
            out += [f"\t{t.material_index}", f"\t{_nums(t.v0)}", f"\t{_nums(t.v1)}", f"\t{_nums(t.v2)}"]
        out += ["}", ""]
    for kind, items in (("Sphere", scene.spheres), ("Box", scene.boxes)):
        for p in items:
            out += [kind, "{", f"\t{p.transformation_index}", f"\t{p.material_index}", "}", ""]
    return "\n".join(out)


def sha256_of(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main(argv=None) -> int:
    from cosig_tpu_torch.scene.generate import CONFIGS

    for name in argv if argv is not None else sys.argv[1:]:
        scene, _ = CONFIGS[name]()
        path = os.path.join(CONFIG_DIR, f"{name}.txt")
        title = (f"{name}: cosig_tpu_torch/scene/generate.py CONFIGS[{name!r}], "
                 "frozen by benchmark/freeze.py")
        with open(path, "w") as f:
            f.write(scene_text(scene, title))
        print(name, sha256_of(path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
