"""Time variants of the compaction kernel's grid on one card.

The compaction kernel (``csrc/wavefront.cu`` ``compact_kernel``) has three
constants that shape its cooperative grid: the threads of a block
(``COMPACT_THREADS``), the most blocks a multiprocessor may hold
(``COMPACT_MAX_PER_SM``) and the chunks of 32 rays whose loads a warp
issues together (``COMPACT_UNROLL``). This script builds ``wavefront.cu``
once per variant (one ``nvcc`` each, all started at once, into a temporary
directory), checks each variant's list against ``compact_plain`` as
integers and times it on the card (launches queued behind a sleep, so the
host does not pace them) on the states the main path gives it: glass_sphere
at depth 1 and large_mesh at depths 1-3, at their full size. Each variant
is timed twice, in turns. Run on a machine with the card and ``nvcc``:

    python3 -m cosig_tpu_torch.kernels.compact_variants
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

# name: (threads a block, most blocks a multiprocessor holds, unroll)
VARIANTS = {
    "512 x 4, unroll 4 (the kernel's)": (512, "2048 / COMPACT_THREADS", 4),
    "512 x 4, unroll 8": (512, "2048 / COMPACT_THREADS", 8),
    "1024 x 2, unroll 4": (1024, "2048 / COMPACT_THREADS", 4),
    "1024 x 1, unroll 4": (1024, "1", 4),
    "1024 x 1, unroll 8": (1024, "1", 8),
    "512 x 2, unroll 4": (512, "2", 4),
    "256 x 8, unroll 4": (256, "2048 / COMPACT_THREADS", 4),
    "512 x 1, unroll 8": (512, "1", 8),
}
CONSTANTS = ("constexpr int COMPACT_THREADS = 512;", "constexpr int COMPACT_UNROLL = 4;",
             "constexpr int COMPACT_MAX_PER_SM = 2048 / COMPACT_THREADS;")


def variant_source(text: str, threads: int, per_sm: str, unroll: int) -> str:
    """``wavefront.cu`` with the three constants replaced."""
    for line in CONSTANTS:
        if line not in text:
            raise ValueError(f"wavefront.cu no longer holds {line!r}")
    return (text.replace(CONSTANTS[0], f"constexpr int COMPACT_THREADS = {threads};")
            .replace(CONSTANTS[1], f"constexpr int COMPACT_UNROLL = {unroll};")
            .replace(CONSTANTS[2], f"constexpr int COMPACT_MAX_PER_SM = {per_sm};"))


def build_variants(tmp: str) -> dict:
    """Compile every variant into its own library -> {name: (CDLL, registers)}."""
    from cosig_tpu_torch.kernels import build as kbuild

    nvcc = kbuild.find_nvcc()
    with open(os.path.join(kbuild.CSRC_DIR, "wavefront.cu")) as fh:
        text = fh.read()
    procs = []
    for i, (name, (threads, per_sm, unroll)) in enumerate(VARIANTS.items()):
        src = os.path.join(tmp, f"v{i}")
        shutil.copytree(kbuild.CSRC_DIR, src)
        with open(os.path.join(src, "wavefront.cu"), "w") as fh:
            fh.write(variant_source(text, threads, per_sm, unroll))
        out = os.path.join(src, "lib.so")
        cmd = [nvcc, *kbuild.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", out,
               os.path.join(src, "wavefront.cu")]
        procs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, out, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err[-3000:]}")
        m = re.search(r"compact_kernel.*?Used (\d+) registers", err, re.S)
        lib = ctypes.CDLL(out)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cosig_compact_launch.argtypes = [ptr, i32, i32, i32, ptr, i32, ptr, ptr, ptr]
        lib.cosig_compact_launch.restype = i32
        lib.cosig_compact_grid.argtypes = [i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
        lib.cosig_compact_grid.restype = i32
        libs[name] = (lib, int(m.group(1)) if m else None)
    return libs


def grid(lib, n: int) -> tuple:
    """(blocks, rays per block) of ``lib``'s compaction grid for ``n`` rays."""
    blocks, rays = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.cosig_compact_grid(n, ctypes.byref(blocks), ctypes.byref(rays))
    if err != 0:
        raise RuntimeError(f"cosig_compact_grid failed: CUDA error {err}")
    return blocks.value, rays.value


def runner(lib, state):
    """A call of ``lib``'s compaction on ``state`` -> (run, idx, n_live)."""
    import torch

    from cosig_tpu_torch.kernels.binding import OCTANTS

    dev, n = state.device, int(state.shape[1])
    blocks, rays = grid(lib, n)
    ints = OCTANTS * blocks
    counts = torch.empty(max(1, ints), dtype=torch.int32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    n_live = torch.empty(1, dtype=torch.int32, device=dev)
    args = [ctypes.c_void_p(state.data_ptr()), n, blocks, rays,
            ctypes.c_void_p(counts.data_ptr()), ints,
            ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(n_live.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)]

    def run():
        err = lib.cosig_compact_launch(*args)
        if err != 0:
            raise RuntimeError(f"cosig_compact_launch failed: CUDA error {err}")

    return run, idx, n_live


def main_path_states(device) -> dict:
    """The states the compaction reads on the main path: glass_sphere's at
    depth 1 and large_mesh's at depths 1-3, from the wavefront kernels."""
    import chip_smoke
    from cosig_tpu_torch.kernels import binding
    from cosig_tpu_torch.kernels import wavefront as kw
    from cosig_tpu_torch.ops import kernel_core as kc

    states = {}
    for name, depths in (("glass_sphere", 1), ("large_mesh", 3)):
        s = chip_smoke.scene_setup(name, {}, device)
        cfg, cset, uni, lights = s["cfg"], s["cset"], s["uni"], s["lights"]
        fb = binding.frame_buffer(cset.device, uni, cset.mats_host, lights)
        pk = kc.prim_table(None, (0, 0), device)
        state = kw.primary(cset, fb, cfg, cfg.height, *pk)
        for d in range(1, depths + 1):
            states[f"{name} depth {d}"] = state.clone()
            idx, n_live = kw.compact(state)
            kw.bounce(state, idx, n_live, cset, fb, cfg, d, *pk)
    return states


def main() -> int:
    import torch

    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, here)
    import chip_smoke
    from cosig_tpu_torch.ops import trace_wavefront as tw

    if not torch.cuda.is_available():
        print("compact_variants: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        states = main_path_states(device)
        times = {}
        for turn in range(2):
            for name, (lib, _) in libs.items():
                for tag, state in states.items():
                    run, idx, n_live = runner(lib, state)
                    run()
                    if turn == 0:
                        idx_p, n_p = tw.compact_plain(state)
                        m = int(n_live)
                        if m != int(n_p) or not bool((idx[:m] == idx_p[:m]).all()):
                            raise RuntimeError(f"variant {name} differs from compact_plain "
                                               f"on {tag}")
                    times.setdefault((name, tag), []).append(chip_smoke.device_ms(run, 50))
        for name, (lib, regs) in libs.items():
            blocks, rays = grid(lib, 4 * 1024 * 1024)
            print(f"{name}: {regs} registers; grid at N = 4,194,304: {blocks} blocks x "
                  f"{rays} rays")
            for tag in states:
                print(f"  {tag}: " + " / ".join(f"{t:.4f}" for t in times[(name, tag)])
                      + " ms on the card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
