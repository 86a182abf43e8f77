"""The readings that a cell's limits are set from, on the card.

    python -m benchmark.control --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--mxu full]

One process sets the cell up once, then for each seed runs a window of
``--seconds`` at the cell's own load, keeps frames and pixels as a run
does (:mod:`benchmark.check`), and prints one JSON line:

* ``program``: the worst of each number over the kept frames, the
  program's frames against the reference (the lower reading comes from
  these);
* ``control``: the same numbers for the control, the reference itself
  computed in bfloat16 (the nearest precision below the configuration's
  float32) put in the program's place at the same poses and pixels (the
  upper reading comes from these);
* ``faults``: ``rays_gap`` with the program's ray count altered where
  the harness reads it, to the primary rays alone or to every ray
  counted twice (the control traces only the kept pixels, so it has no
  count of a whole frame to stand in for the program's; these readings
  are ``rays_gap``'s upper ones);
* with ``--mxu full``, ``mxu_full``: the program with its tensor-core
  pair test on (bfloat16 limbs), a witness of its own lower-precision
  path.

A last line gives the largest program reading and the smallest control
and fault readings over the seeds. The benchmark's runs never run this module.
"""

from __future__ import annotations

import argparse
import json
import random
import sys

from benchmark import check, orbit, run
from benchmark.manifest import Cell


def worst(per_frame: list) -> dict:
    return {k: max(f[k] for f in per_frame) for k in per_frame[0]}


def readings(session, cell, seed: int, seconds: float, witness=None) -> dict:
    import torch

    rng = random.Random(seed)
    session.next_pose = orbit.start_pose(rng, len(session.poses))
    keep = run.reservoir(session, rng)
    session.window(seconds, keep)
    kwargs, picks, got, got_rays = run.kept_pixels(session, keep)
    path = cell.scene_path()
    want, want_rays, _ = check.reference_pixels(path, kwargs, picks, "cuda")
    low, _, _ = check.reference_pixels(path, kwargs, picks, "cuda", dtype=torch.bfloat16)
    pixels = session.width * session.height
    primary = pixels * int(session.poses[0].aa_samples)
    out = {"seed": seed,
           "program": worst([check.numbers(g, w, (r, wr, pixels))
                             for g, w, r, wr in zip(got, want, got_rays, want_rays)]),
           "control": worst([check.numbers(c, w) for c, w in zip(low, want)]),
           # The program's ray count altered where the harness reads it: the
           # primary rays alone, or every ray counted twice.
           "faults": {"rays_primary_only": max(check.rays_gap(primary, wr, pixels)
                                               for wr in want_rays),
                      "rays_doubled": max(check.rays_gap(2 * r, wr, pixels)
                                          for r, wr in zip(got_rays, want_rays))}}
    if witness is not None:
        # The same poses on the witness, from the same start.
        rng = random.Random(seed)
        witness.next_pose = orbit.start_pose(rng, len(witness.poses))
        keep = run.reservoir(witness, rng)
        witness.window(seconds, keep)
        kwargs, picks, got, got_rays = run.kept_pixels(witness, keep)
        want, want_rays, _ = check.reference_pixels(path, kwargs, picks, "cuda")
        out["mxu_full"] = worst([check.numbers(g, w, (r, wr, pixels))
                                 for g, w, r, wr in zip(got, want, got_rays, want_rays)])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.5)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mxu", choices=("off", "full"), default="off")
    args = p.parse_args(argv)
    cell = Cell(args.workload)
    run.cache_dirs()
    session = run.Session(cell)
    witness = run.Session(cell, mxu="full") if args.mxu == "full" else None
    rows = []
    for seed in args.seeds:
        rows.append(readings(session, cell, seed, args.seconds, witness))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "program_max": {k: max(r["program"][k] for r in rows) for k in rows[0]["program"]},
               "control_min": {k: min(r["control"][k] for r in rows) for k in rows[0]["control"]},
               "faults_min": {k: min(r["faults"][k] for r in rows) for k in rows[0]["faults"]}}
    if witness is not None:
        summary["mxu_full_max"] = {k: max(r["mxu_full"][k] for r in rows)
                                   for k in rows[0]["mxu_full"]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
