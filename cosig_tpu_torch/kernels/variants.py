"""Time variants of the kernels' tuned constants on one card, in turns.

Some constants of the kernels were chosen by timing candidates on the
card: the compaction's grid (``csrc/wavefront.cu``: the threads of a
block, the most blocks a multiprocessor may hold, the chunks of 32 rays
whose loads a warp issues together) and the fission form's walks
(``csrc/wavefront.cuh``: the ``__launch_bounds__`` minima of the fission
primary and the shade, and ``PER_WARP_ROWS``, the cluster size up to
which the fission primary and the shade over every ray walk per warp;
past it they walk compacted). A variant is a list of (file, constant,
value) edits: the line ``constexpr int CONSTANT = ...;`` of that file
gets the new value, and a constant the file does not hold once raises
before anything is built.

The script copies the package and ``chip_smoke.py`` into a temporary
directory once per variant and applies its edits there, builds every copy
at once (one process each, ``nvcc -Xptxas -v``), then times each copy in a
process of its own, in turns (every variant, then again in reverse
order), at the main path's full size. In the first turn each kernel's
result is held to its plain version. Checkouts given as arguments (a
parent commit unpacked with ``git archive``) are timed in the same turns,
built in place. The sets:

- ``compact``: the compaction on the states of glass_sphere's depth 1 and
  large_mesh's depths 1-3, its list equal to ``compact_plain``'s as
  integers;
- ``forms``: the fission primary and the shade over every ray of the
  primary stage at glass_sphere (k = 32), large_mesh (k = 64) and the
  dense knot (k = 128; not held, its plain stages take minutes), and on
  the other side of ``PER_WARP_ROWS`` on both bench scenes (glass_sphere
  cut to clusters of 64 rows, large_mesh to 32); the shade on the list of
  glass_sphere's depth 1 and of large_mesh's depths 1-3; each held bit for
  bit.

One JSON line per variant (its builds' ptxas lines, blocks per
multiprocessor, the times of both turns), then the card's name and power
limit. Run on a machine with the card and ``nvcc``:

    python3 -m cosig_tpu_torch.kernels.variants SET [VARIANT ...] [TREE ...]

VARIANT names the variants of SET to time (all of them when none is
named); TREE is a checkout's directory.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

CU = "cosig_tpu_torch/csrc/wavefront.cu"
CUH = "cosig_tpu_torch/csrc/wavefront.cuh"

# set -> {variant: [(file, constant, value)]}
VARIANTS = {
    "compact": {
        "512x4-unroll4": [],  # the kernel's
        "512x4-unroll8": [(CU, "COMPACT_UNROLL", 8)],
        "1024x2-unroll4": [(CU, "COMPACT_THREADS", 1024)],
        "1024x1-unroll4": [(CU, "COMPACT_THREADS", 1024), (CU, "COMPACT_MAX_PER_SM", 1)],
        "1024x1-unroll8": [(CU, "COMPACT_THREADS", 1024), (CU, "COMPACT_MAX_PER_SM", 1),
                           (CU, "COMPACT_UNROLL", 8)],
        "512x2-unroll4": [(CU, "COMPACT_MAX_PER_SM", 2)],
        "256x8-unroll4": [(CU, "COMPACT_THREADS", 256)],
        "512x1-unroll8": [(CU, "COMPACT_MAX_PER_SM", 1), (CU, "COMPACT_UNROLL", 8)],
    },
    "forms": {
        "kernels": [],
        "compacted-5": [(CUH, "SHADE_MIN_BLOCKS", 5), (CUH, "FISSION_PAIRS_MIN_BLOCKS", 5)],
        "compacted-4": [(CUH, "SHADE_MIN_BLOCKS", 4), (CUH, "FISSION_PAIRS_MIN_BLOCKS", 4)],
        "per-warp-5": [(CUH, "FISSION_MIN_BLOCKS", 5), (CUH, "SHADE_ALL_MIN_BLOCKS", 5)],
        "per-warp-6": [(CUH, "FISSION_MIN_BLOCKS", 6), (CUH, "SHADE_ALL_MIN_BLOCKS", 6)],
        "per-warp-7": [(CUH, "SHADE_ALL_MIN_BLOCKS", 7)],
        "compacted-every-k": [(CUH, "PER_WARP_ROWS", 0)],
        "per-warp-to-128": [(CUH, "PER_WARP_ROWS", "SLOT_MAX")],
    },
}
# set -> the builds whose ptxas lines each variant reports
BUILDS = {"compact": ("compact",),
          "forms": ("primary_fission", "primary_fission slots", "shade", "shade_all",
                    "shade_all slots", "trace")}


def edit_text(text: str, edits: list) -> str:
    """``text`` with each (constant, value) of ``edits`` set: its line
    ``constexpr int constant = ...;`` ends in the new value."""
    for name, value in edits:
        pat = re.compile(rf"constexpr int {name} = [^;]*;")
        if len(pat.findall(text)) != 1:
            raise ValueError(f"the source does not define {name} once")
        text = pat.sub(f"constexpr int {name} = {value};", text)
    return text


def copy_variant(src: str, dst: str, edits: list) -> None:
    """The package and chip_smoke.py of the checkout ``src`` into ``dst``
    (no build directory), with ``edits`` applied."""
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, "cosig_tpu_torch"), os.path.join(dst, "cosig_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(src, "chip_smoke.py"), dst)
    for rel in sorted({e[0] for e in edits}):
        path = os.path.join(dst, rel)
        with open(path) as fh:
            text = fh.read()
        with open(path, "w") as fh:
            fh.write(edit_text(text, [(n, v) for f, n, v in edits if f == rel]))


def build_here(which: str) -> dict:
    """In a checkout (the working directory): build its library and read
    the ptxas lines of the set's builds."""
    import chip_smoke
    from cosig_tpu_torch.kernels import build as kbuild

    _, secs, ptxas = kbuild.build(force=True, verbose=True)
    res = chip_smoke.ptxas_resources(ptxas)
    m = re.search(r"compact_kernel.*?Used (\d+) registers", ptxas, re.S)
    res["compact"] = {"registers": int(m.group(1))} if m else None
    return {"build_s": secs, "ptxas": {n: res.get(n) for n in BUILDS[which]}}


def _frame(name: str, dev, k: int | None = None) -> tuple:
    """(cfg, cset, uni, lights, mats, fb, pk) of a bench scene at full
    size, its clusters cut to ``k`` rows if given."""
    import chip_smoke
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.ops import kernel_core as kc

    s = chip_smoke.scene_setup(name, {}, dev)
    cset = chip_smoke.form_sets(s, {"main": k}, dev)["main"] if k else s["cset"]
    fb = binding.frame_buffer(dev, s["uni"], cset.mats_host, s["lights"])
    return (s["cfg"], cset, s["uni"], s["lights"], cset.mats_host, fb,
            kc.prim_table(None, (0, 0), dev))


def _held(tag: str, a, b) -> None:
    import torch

    if not torch.equal(a, b):
        raise RuntimeError(f"{os.getcwd()}: {tag} differs from its plain version")


def time_compact(dev, check: bool) -> dict:
    """The compaction on the main path's states: ms per call, its list held
    to compact_plain's in the first turn."""
    import chip_smoke
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import trace_wavefront as tw

    out = {}
    for name, depths in (("glass_sphere", 1), ("large_mesh", 3)):
        cfg, cset, _, _, _, fb, pk = _frame(name, dev)
        state = kw.primary(cset, fb, cfg, cfg.height, *pk)
        for d in range(1, depths + 1):
            idx, n_live = kw.compact(state)
            if check:
                idx_p, n_p = tw.compact_plain(state)
                m = int(n_live)
                if m != int(n_p) or not bool((idx[:m] == idx_p[:m]).all()):
                    raise RuntimeError(f"{os.getcwd()}: the compaction differs from "
                                       f"compact_plain at {name} depth {d}")
            out[f"{name} depth {d}"] = chip_smoke.device_ms(lambda: kw.compact(state), 50)
            kw.bounce(state, idx, n_live, cset, fb, cfg, d, *pk)
    out["grid at 4,194,304 rays"] = list(binding.compact_grid(4 * 1024 * 1024, dev))
    return out


def time_forms(dev, check: bool) -> dict:
    """The fission primary and the shade at the shapes of the module's
    docstring: ms per launch, blocks per multiprocessor; each result held
    bit for bit to its plain version in the first turn (not the knot's)."""
    import torch

    import chip_smoke
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc
    from cosig_tpu_torch.ops import trace_wavefront as tw

    out = {}
    for name, k in (("glass_sphere", None), ("large_mesh", None), ("dense_knot", None),
                    ("glass_sphere", 64), ("large_mesh", 32)):
        cfg, cset, uni, lights, mats, fb, pk = _frame(name, dev, k)
        band = cfg.height
        tag = f"{name} k{cset.k}"
        knot = name == "dense_knot"
        hold = check and not knot
        reps = 3 if knot else 5
        out[f"{tag} blocks"] = {n: binding.occupancy(n, cset.num_clusters, cset.k, dev)
                                for n in ("primary_fission", "shade", "shade_all")}
        st = kw.primary(cset, fb, cfg, band, *pk, fission=True)
        if hold:
            _held(f"{tag} primary_fission", st, tw.primary_stage(
                cset, uni, mats, lights, cfg, band, *pk, fission=True))
        out[f"{tag} primary_fission"] = chip_smoke.device_ms(
            lambda: kw.primary(cset, fb, cfg, band, *pk, fission=True), reps)
        copies = [st.clone() for _ in range(reps + 1)]
        if hold:
            a = copies.pop()
            kw.shade(a, None, None, cset, fb, cfg, 0, *pk)
            tw.primary_shade(st, cset, uni, mats, lights, cfg, *pk)
            _held(f"{tag} shade_all", a, st)
        out[f"{tag} shade_all"] = chip_smoke.device_ms(
            lambda: kw.shade(copies.pop(), None, None, cset, fb, cfg, 0, *pk), reps)
        del copies, st
        if not knot and k is None:
            # The shade on each depth's list, after the trace, on the fused chain's states.
            st16 = kw.primary(cset, fb, cfg, band, *pk)
            st = torch.zeros((kc.FISSION_ROWS, st16.shape[1]), dtype=torch.float32, device=dev)
            for d in range(1, 2 if name == "glass_sphere" else cfg.max_depth):
                idx, n_live = kw.compact(st16)
                st[:kc.STATE_ROWS] = st16
                kw.trace(st, idx, n_live, cset, fb, cfg, d, *pk)
                copies = [st.clone() for _ in range(reps + 1)]
                if hold:
                    a = copies.pop()
                    kw.shade(a, idx, n_live, cset, fb, cfg, d, *pk)
                    ref = st.clone()
                    tw.shade_listed_stage(ref, idx, n_live, cset, uni, mats, lights, cfg, d, *pk)
                    _held(f"{tag} shade {d}", a, ref)
                out[f"{tag} shade {d}"] = chip_smoke.device_ms(
                    lambda: kw.shade(copies.pop(), idx, n_live, cset, fb, cfg, d, *pk), reps)
                kw.bounce(st16, idx, n_live, cset, fb, cfg, d, *pk)
                del copies
            del st16, st
        del cset
        torch.cuda.empty_cache()
    return out


def _child(which: str, mode: str, tree: str, check: bool = False) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), mode, which] + (["--check"] if check else [])
    res = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
    for line in res.stdout.splitlines():
        if line.startswith("R "):
            return json.loads(line[2:])
    raise RuntimeError(f"{mode} {which} in {tree} failed ({res.returncode}):\n{res.stderr[-3000:]}")


def main(argv: list) -> int:
    if argv[:1] in (["--build"], ["--time"]):  # a child, in the checkout it measures
        sys.path.insert(0, os.getcwd())
        which = argv[1]
        if argv[0] == "--build":
            out = build_here(which)
        else:
            import torch

            timer = time_compact if which == "compact" else time_forms
            out = timer(torch.device("cuda", 0), "--check" in argv)
        print("R " + json.dumps(out), flush=True)
        return 0
    if not argv or argv[0] not in VARIANTS:
        print(f"usage: variants.py {{{','.join(VARIANTS)}}} [VARIANT ...] [TREE ...]",
              file=sys.stderr)
        return 2
    which, names = argv[0], argv[1:]
    variants = VARIANTS[which]
    unknown = [n for n in names if n not in variants and not os.path.isdir(n)]
    if unknown:
        print(f"variants: no variant or checkout {unknown}", file=sys.stderr)
        return 2
    import torch

    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, here)
    import chip_smoke

    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    picked = [n for n in names if n in variants] or list(variants)
    with tempfile.TemporaryDirectory() as tmp:
        trees = {}
        for i, name in enumerate(picked):
            trees[name] = os.path.join(tmp, f"v{i}")
            copy_variant(here, trees[name], variants[name])
        for tree in names:
            if tree not in variants:
                trees[os.path.abspath(tree)] = os.path.abspath(tree)
        procs = {name: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build",
                                         which], cwd=tree, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                 for name, tree in trees.items()}
        rec = {}
        for name, p in procs.items():
            stdout, stderr = p.communicate()
            lines = [x for x in stdout.splitlines() if x.startswith("R ")]
            if p.returncode != 0 or not lines:
                raise RuntimeError(f"build of {name} failed ({p.returncode}):\n{stderr[-3000:]}")
            rec[name] = dict(json.loads(lines[0][2:]), times=[])
        order = list(trees) + list(reversed(trees))
        for turn, name in enumerate(order):
            rec[name]["times"].append(_child(which, "--time", trees[name],
                                             check=turn < len(trees)))
        for name, r in rec.items():
            print(json.dumps(dict(variant=name, edits=variants.get(name), **r)), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
