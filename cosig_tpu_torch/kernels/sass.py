"""Instruction mix of the kernels' pair and cull loops, read from the built library.

    python3 -m cosig_tpu_torch.kernels.sass [LIBRARY.so ...]

Disassembles each library (default: the one :mod:`cosig_tpu_torch.kernels.build`
builds from this checkout) with the CUDA toolkit's ``cuobjdump -sass`` and
finds, in each build of each ray kernel (named as :func:`build_label`
names it: ``bounce``, ``bounce_mx``, ``primary_fission``, ..., with `` (superblocks)``
for the build with the superblock cull), the pair loops: the innermost loops
(a backward branch and its target) whose body compares a gid with the
padding gid 2^24 (``gid >= GID_PAD``, the row loop's break) and takes a
reciprocal (``1 / s``, MUFU.RCP); and the block walk's cull loops: the
innermost loops that run slab tests (FMNMX) and store a warp ballot
(VOTE), with no block or mbarrier wait inside. For each it prints the instructions per pair test (per slab
test), by class: loads from global memory, shared memory, the constant
bank and the stack (spills), fp32 arithmetic and compares, and control
flow. A loop the compiler unrolled holds several tests: the counts are
divided by its reciprocals (its ballots). In the tensor-core builds the
pair loop is the walk over a cluster's n-tiles (mx_pair.cuh), whose
products are wgmma: :func:`tensor_ops` counts the tensor-core
instructions (HGMMA: wgmma; HMMA: mma.sync) in each build, in its pair
loops and in the whole function. The script prints one JSON line per
library.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

KERNELS = {"primary_kernel": "primary", "bounce_kernel": "bounce", "trace_kernel": "trace",
           "shade_kernel": "shade", "megakernel": "megakernel", "debug_kernel": "debug",
           "compact_kernel": "compact", "mx_probe_kernel": "mx_probe"}
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


def build_label(mangled: str) -> tuple | None:
    """(label, superblocks) of a kernel's mangled name, or None for another
    function: the launch counter's name of the build its template flags
    give (primary_kernel<SB, SH, FISSION, MX, PC>, bounce_kernel<SB, SH,
    MX, PC>, trace_kernel<SB, MX, PC>, shade_kernel<SB, LISTED, MX, PC>,
    megakernel<SB, MX, PC>, debug_kernel<SB, PC>): primary_fission,
    primary_shadow, bounce_shadow, shade_all (the shade over every ray of
    the primary stage), with ``_mx`` for the tensor-core builds and
    `` slots`` for the builds whose walk has slots of 128 rows (PC, the
    launches' pick for k > 128); superblocks: built with the superblock
    cull. The exact trace and shade on a list walk in the compacted form,
    in slots of 32 rows at every k, and are built only with PC false: their
    labels are their counters' names, and they have no `` slots`` build.
    The exact fission primary's and shade over every ray's `` slots``
    builds are their compacted walks, in slots of 32 rows (the launches'
    pick for k > 32)."""
    m = re.match(r"_ZN5cosig(\d+)(\w+)", mangled)
    if not m:
        return None
    n = int(m.group(1))
    name = KERNELS.get(m.group(2)[:n])
    if name is None:
        return None
    args = re.match(r"I((?:Lb[01]E)+)", m.group(2)[n:])
    flags = [f == "1" for f in re.findall(r"Lb([01])E", args.group(1))] if args else []
    flags += [False] * 5
    mx = {"primary": flags[3], "bounce": flags[2], "trace": flags[1], "shade": flags[2],
          "megakernel": flags[1]}.get(name, False)
    pc = {"primary": flags[4], "bounce": flags[3], "trace": flags[2], "shade": flags[3],
          "megakernel": flags[2], "debug": flags[1]}.get(name, False)
    if name == "primary" and flags[2]:
        name = "primary_fission"
    elif name in ("primary", "bounce") and flags[1]:
        name += "_shadow"
    elif name == "shade" and not flags[1]:
        name = "shade_all"
    return name + ("_mx" if mx else "") + (" slots" if pc else ""), bool(args) and flags[0]


def functions(sass: str) -> dict:
    """{build label: [(address, opcode, operands), ...]} of every kernel
    build, `` (superblocks)`` appended for the builds with the superblock
    cull."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (_ZN5cosig\w+)", line)
        if m:
            label = build_label(m.group(1))
            cur = None
            if label:
                cur = label[0] + (" (superblocks)" if label[1] else "")
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


def disassemble(path: str) -> dict:
    """functions() of the library at ``path``."""
    return functions(subprocess.run([cuobjdump(), "-sass", path], capture_output=True,
                                    text=True, check=True).stdout)


def library_mix(path: str, funcs: dict | None = None) -> dict:
    funcs = disassemble(path) if funcs is None else funcs
    return {name: {kind: [dict(span=f"{lo:#x}-{hi:#x}", **mix(body, unit))
                          for lo, hi, body in loops(ins, wanted)]
                   for kind, wanted, unit in (("pair_loops", is_pair_loop, "MUFU.RCP"),
                                              ("cull_loops", is_cull_loop, "VOTE"))}
            for name, ins in funcs.items() if name != "mx_probe"}


def tensor_ops(funcs: dict) -> dict:
    """{build label: {"hgmma", "hmma": counts in the whole function,
    "pair_loop_hgmma", "pair_loop_hmma": in its pair loops}} of every
    kernel build (functions())."""
    out = {}
    for name, ins in funcs.items():
        pair = [i for _, _, body in loops(ins, is_pair_loop) for i in body]
        out[name] = {f"{where}{op.lower()}": sum(o.split(".")[0] == op for _, o, _ in body)
                     for where, body in (("", ins), ("pair_loop_", pair))
                     for op in ("HGMMA", "HMMA")}
    return out


def main(argv: list) -> int:
    if not argv:
        from cosig_tpu_torch.kernels.build import build

        argv = [build()[0]]
    for path in argv:
        funcs = disassemble(path)
        print(json.dumps({"library": path, "kernels": library_mix(path, funcs),
                          "tensor_ops": tensor_ops(funcs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
