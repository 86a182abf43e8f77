"""Instruction mix of the kernels' pair and cull loops, read from the built library.

    python3 -m cosig_tpu_torch.kernels.sass [LIBRARY.so ...]

Disassembles each library (default: the one :mod:`cosig_tpu_torch.kernels.build`
builds from this checkout) with the CUDA toolkit's ``cuobjdump -sass`` and
finds, in each of the four ray kernels, the pair loops: the innermost loops
(a backward branch and its target) whose body compares a gid with the
padding gid 2^24 (``gid >= GID_PAD``, the row loop's break) and takes a
reciprocal (``1 / s``, MUFU.RCP); and the block walk's cull loops: the
innermost loops that run slab tests (FMNMX) and store a warp ballot
(VOTE), with no block or mbarrier wait inside. For each it prints the instructions per pair test (per slab
test), by class: loads from global memory, shared memory, the constant
bank and the stack (spills), fp32 arithmetic and compares, and control
flow. A loop the compiler unrolled holds several tests: the counts are
divided by its reciprocals (its ballots). Every kernel walks with the
block walk; a library built before it had a per-ray walk, whose slab test
shares the cluster loop with the pair loop, so it shows no cull loop. The
script prints one JSON line per library.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

KERNELS = {"primary_kernel": "primary", "bounce_kernel": "bounce",
           "megakernel": "megakernel", "debug_kernel": "debug"}
GID_PAD = "16777216"
CLASSES = {
    "global_loads": ("LDG",),
    "shared_loads": ("LDS",),
    "const_loads": ("LDC", "ULDC"),
    "stack_loads": ("LDL",),
    "fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET", "MUFU", "FCHK"),
    "control": ("BRA", "CALL", "RET", "BSSY", "BSYNC", "WARPSYNC", "BAR", "SYNCS"),
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def cuobjdump() -> str:
    from cosig_tpu_torch.kernels.build import find_nvcc

    return os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")


def functions(sass: str) -> dict:
    """{kernel label: [(address, opcode, operands), ...]} of the four ray
    kernels, each in its builds without and with the superblock cull."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : _ZN5cosig(\d+)(\w+)", line)
        if m:
            cur = KERNELS.get(m.group(2)[: int(m.group(1))])
            if cur and m.group(2)[int(m.group(1)):].startswith("ILb1E"):
                cur += " (superblocks)"  # the build with the superblock cull
            if cur:
                out[cur] = []
            continue
        m = _INSN.search(line)
        if m and cur:
            out[cur].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def loops(insns: list, wanted) -> list:
    """The innermost loops (a backward branch and its target) whose body
    satisfies ``wanted``: [(start, end, body)]."""
    found = []
    for addr, op, args in insns:
        t = re.search(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            lo = int(t.group(1), 16)
            body = [(a, o, g) for a, o, g in insns if lo <= a <= addr]
            if wanted(body):
                found.append((lo, addr, body))
    return [lp for lp in found
            if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in found)]


def is_pair_loop(body: list) -> bool:
    return (any(o.startswith("MUFU.RCP") for _, o, _ in body)
            and any(GID_PAD in g for _, o, g in body if o.startswith("FSETP")))


def is_cull_loop(body: list) -> bool:
    ops = [o.split(".")[0] for _, o, _ in body]
    return "VOTE" in ops and "FMNMX" in ops and "BAR" not in ops and "SYNCS" not in ops


def mix(body: list, unit: str) -> dict:
    tests = max(1, sum(o.startswith(unit) for _, o, _ in body))
    row = {"tests_per_trip": tests, "instructions": round(len(body) / tests, 2)}
    for name, prefixes in CLASSES.items():
        n = sum(o.split(".")[0] in prefixes for _, o, _ in body)
        row[name] = round(n / tests, 2)
    return row


def library_mix(path: str) -> dict:
    sass = subprocess.run([cuobjdump(), "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    return {name: {kind: [dict(span=f"{lo:#x}-{hi:#x}", **mix(body, unit))
                          for lo, hi, body in loops(ins, wanted)]
                   for kind, wanted, unit in (("pair_loops", is_pair_loop, "MUFU.RCP"),
                                              ("cull_loops", is_cull_loop, "VOTE"))}
            for name, ins in functions(sass).items()}


def main(argv: list) -> int:
    if not argv:
        from cosig_tpu_torch.kernels.build import build

        argv = [build()[0]]
    for path in argv:
        print(json.dumps({"library": path, "kernels": library_mix(path)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
