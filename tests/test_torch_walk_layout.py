"""The block walk's shared-memory layout, its ring slots and the trace's
compacted pair loop, on the CPU.

``csrc/walk_layout.h`` is plain C++ (no CUDA include): g++ builds it into
a small library, as the ``mx_layout`` fixture of tests/test_torch_mxu.py
builds ``csrc/mx_layout.h``, and these tests hold what the kernels compute
from it: 16-byte offsets, every k within what a block may opt into on the
H100 (232,448 B), the layouts of k <= 128 as they were before slots, the
pieces of a cluster covering its rows once and in order, the shadow-set
builds' shared memory equal to the main walk's; the compacted loop's pair
map a bijection, and the 64-bit (t, gid) key's minimum the lexicographic
one. The slot count of the compacted walk that ``kernel_core.WORK``
counts (``pair_slots``, chip_smoke.py phase 3) is held to a numpy model of
the schedule. The compacted any hit's flags and max_t lie in that walk's
region at every k, and the fission builds fit the blocks their
``__launch_bounds__`` ask for at every k they run at."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
import cosig_tpu_torch
from cosig_tpu_torch.kernels import sass
from cosig_tpu_torch.ops import kernel_core as tkc

OPTIN_BYTES = 232_448  # the most dynamic shared memory an H100 block may opt into
MX_EXTRA = 5_184  # the tensor-core layout's B tiles and their alignment at k = 32-128

_SRC = r"""
#include "walk_layout.h"
extern "C" {
int layout(int rows, int mx, int pairs, unsigned* out) {
  const cosig::TileLayout l = cosig::tile_layout(rows, mx != 0, pairs != 0);
  const unsigned v[] = {l.ring, l.boxes, l.groups, l.ballots, l.list, l.cand, l.pre,
                        l.partial, l.hull, l.bars, l.count, l.mxb, l.pairs, l.total};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 14;
}
int walk_smem(int k, int mx) { return cosig::walk_smem(k, mx != 0); }
int both_smem(int k, int sh_k, int mx) { return cosig::both_smem(k, sh_k, mx != 0); }
int trace_smem(int k) { return cosig::trace_smem(k); }
int walk_rows(int k) { return cosig::walk_rows(k); }
int shadow_rows(int k, int sh_k) { return cosig::shadow_rows(k, sh_k); }
int slot_pieces(int k, int rows) { return cosig::slot_pieces(k, rows); }
int piece_first(int p, int rows) { return cosig::piece_first(p, rows); }
int piece_rows(int k, int rows, int p) { return cosig::piece_rows(k, rows, p); }
// Thread t's pairs of n rays x `rows` rows: (row, ray) pairs into out, -> count.
int thread_pairs(int t, int n, int rows, int* out) {
  int m = 0;
  const int total = n * rows;
  if (t >= total) return 0;
  cosig::PairCursor c = cosig::pair_first(t, n);
  for (int p = t; p < total; p += cosig::TILE_THREADS) {
    out[2 * m] = c.row;
    out[2 * m + 1] = c.ray;
    ++m;
    cosig::pair_next(c, n);
  }
  return m;
}
unsigned long long hit_key(unsigned t_bits, unsigned gid) { return cosig::hit_key(t_bits, gid); }
int constant(int i) {
  const int v[] = {cosig::TILE_THREADS, cosig::RING_STAGES, cosig::ROW_BYTES, cosig::SLOT_MAX,
                   cosig::TRACE_SLOT, cosig::PAIR_BYTES, cosig::PAIR_KEYS, cosig::PAIR_FLAGS,
                   cosig::PAIR_MAX_T, cosig::PAIR_OPS, cosig::PAIR_LIST, cosig::PAIR_OPERANDS,
                   cosig::PAIR_COUNTS, cosig::PAIR_COUNT_WORDS};
  return v[i];
}
}
"""
_NAMES = ("TILE_THREADS", "RING_STAGES", "ROW_BYTES", "SLOT_MAX", "TRACE_SLOT", "PAIR_BYTES",
          "PAIR_KEYS", "PAIR_FLAGS", "PAIR_MAX_T", "PAIR_OPS", "PAIR_LIST", "PAIR_OPERANDS",
          "PAIR_COUNTS", "PAIR_COUNT_WORDS")
_FIELDS = ("ring", "boxes", "groups", "ballots", "list", "cand", "pre", "partial", "hull",
           "bars", "count", "mxb", "pairs", "total")


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """csrc/walk_layout.h built by g++ into a small library -> (ctypes
    library, its constants by name)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build csrc/walk_layout.h")
    d = tmp_path_factory.mktemp("walk_layout")
    (d / "walk.cc").write_text(_SRC)
    csrc = os.path.join(os.path.dirname(cosig_tpu_torch.__file__), "csrc")
    subprocess.run([cxx, "-O2", "-std=c++17", "-fPIC", "-shared", "-I", csrc, "-o",
                    str(d / "walk.so"), str(d / "walk.cc")], check=True)
    lib = ctypes.CDLL(str(d / "walk.so"))
    lib.hit_key.restype = ctypes.c_ulonglong
    lib.hit_key.argtypes = [ctypes.c_uint, ctypes.c_uint]
    return lib, {n: lib.constant(i) for i, n in enumerate(_NAMES)}


def _layout(lib, rows, mx=False, pairs=False) -> dict:
    out = (ctypes.c_uint * 14)()
    lib.layout(rows, int(mx), int(pairs), out)
    return dict(zip(_FIELDS, out))


@pytest.mark.parametrize("mx", [False, True])
def test_offsets_are_16_byte_words_and_every_k_fits(walk, mx):
    """Every region starts at a multiple of 16 bytes, in order; the main
    walk's, the shadow-set builds' and the trace's shared memory stay
    within what a block may opt into for every k of 1-2048 (the ring of
    whole clusters passed it at k = 504)."""
    lib, _ = walk
    for k in range(1, 2049):
        lay = _layout(lib, lib.walk_rows(k), mx)
        offs = [lay[f] for f in _FIELDS]
        assert all(o % 16 == 0 for o in offs), (k, lay)
        assert offs == sorted(offs), (k, lay)
        assert lay["total"] == lib.walk_smem(k, int(mx)) <= OPTIN_BYTES, k
        assert lib.trace_smem(k) <= OPTIN_BYTES, k
        for sh_k in (k, 2 * k, 1024):
            assert lib.both_smem(k, sh_k, int(mx)) <= OPTIN_BYTES, (k, sh_k)
    assert 3 * 504 * 144 + _layout(lib, 0)["total"] > OPTIN_BYTES  # the old ring at k = 504


def test_layouts_up_to_k128_are_unchanged(walk):
    """Up to k = 128 a slot is one whole cluster and the layout is the one
    every build had before slots, with the two-level cull's union boxes
    (1,024 B) beside the boxes: 29,632 B at k = 32, 71,104 B at k = 128
    (PERF.md), the tensor-core layout 5,184 B more; past 128 it stays at
    k = 128's."""
    lib, c = walk
    assert (c["RING_STAGES"], c["ROW_BYTES"], c["SLOT_MAX"]) == (3, 144, 128)
    assert lib.walk_smem(32, 0) == 29_632 and lib.walk_smem(128, 0) == 71_104
    for k in (32, 64, 128):
        assert lib.walk_smem(k, 1) == lib.walk_smem(k, 0) + MX_EXTRA
    for k in (1, 8, 16, 32, 64, 100, 128):
        assert lib.walk_rows(k) == k
        assert lib.walk_smem(k, 0) == 29_632 + 3 * 144 * (k - 32)
        # The two B tiles (2 x 2,560 B) at the next multiple of 128 B.
        assert lib.walk_smem(k, 1) == -(-lib.walk_smem(k, 0) // 128) * 128 + 5_120
        assert _layout(lib, k)["pairs"] == _layout(lib, k)["total"]  # no pair region
        assert _layout(lib, k)["ballots"] - _layout(lib, k)["groups"] == 256 // 8 * 32
    for k in (129, 512, 1024, 2048):
        assert lib.walk_rows(k) == 128
        assert lib.walk_smem(k, 0) == 71_104 and lib.walk_smem(k, 1) == 71_104 + MX_EXTRA


@pytest.mark.parametrize("rows", [1, 7, 32, 64, 128])
def test_slot_pieces_cover_each_row_once_in_order(walk, rows):
    """The pieces of a k-row cluster in slots of `rows` rows (slot_rows)
    cover rows 0..k-1 once each, in order, every piece but the last full."""
    lib, _ = walk
    for k in list(range(1, 300)) + [511, 512, 513, 1000, 1024, 2048]:
        slot = min(k, rows)
        n = lib.slot_pieces(k, slot)
        got = []
        for p in range(n):
            first, m = lib.piece_first(p, slot), lib.piece_rows(k, slot, p)
            assert 0 < m <= slot and (m == slot or p == n - 1), (k, rows, p)
            got.extend(range(first, first + m))
        assert got == list(range(k)), (k, rows)


def test_shadow_builds_hold_the_main_walks_memory(walk):
    """A shadow walk's slots hold no more rows than its main walk's, so the
    shadow-set builds' shared memory is the main walk's, exact and
    tensor-core, for the (k, shadow k) pairs of phase 10 (FORM_KS,
    SLOT_KS) and more: at large_mesh 43,456 B, not the 71,104 B of its
    k = 128 shadow set's whole-cluster ring."""
    lib, _ = walk
    pairs = [(32, 64), (64, 128), (128, 1024), (512, 1024), (64, 1024), (8, 2048), (200, 300)]
    pairs += [(k, chip_smoke.FORM_KS[n]["shadow"]) for n, k in
              (("glass_sphere", 32), ("large_mesh", 64), ("dense_knot", 128))]
    pairs += [(chip_smoke.SLOT_KS["main"], chip_smoke.SLOT_KS["shadow"])]
    for k, sh_k in pairs:
        assert lib.shadow_rows(k, sh_k) == min(sh_k, k, 128)
        for mx in (0, 1):
            assert lib.both_smem(k, sh_k, mx) == lib.walk_smem(k, mx), (k, sh_k, mx)
    assert lib.both_smem(64, 128, 0) == 43_456


def test_trace_layout(walk):
    """The trace's compacted walk: slots of TRACE_SLOT (32) rows, a ring of
    13,824 B, and PAIR_BYTES (a key, 9 operands and a list entry per ray,
    then the closest hit's four count words) past the layout."""
    lib, c = walk
    assert c["PAIR_COUNT_WORDS"] == 4
    assert c["TRACE_SLOT"] == 32 and c["PAIR_BYTES"] == 128 * (8 + 36 + 4) + 16 == 6_160
    lay = _layout(lib, 32, pairs=True)
    assert lay["boxes"] == 13_824 and lay["total"] == lay["pairs"] + 6_160
    for k in (8, 32, 64, 128, 1024):
        assert lib.trace_smem(k) == _layout(lib, min(k, 32), pairs=True)["total"]


def test_any_hit_region_lies_inside_the_compacted_layout(walk):
    """The compacted any hit's per-ray flag and max_t (4 bytes each) take
    the bytes of the closest hit's 8-byte key, before the operands, the
    list and the closest hit's count words, so the region stays PAIR_BYTES
    and the walk trace_smem(k) at every k of 1-2048: each array lies inside
    [pairs, total) and none overlaps another."""
    lib, c = walk
    t = c["TILE_THREADS"]
    spans = {"flags": (c["PAIR_FLAGS"], 4 * t), "max_t": (c["PAIR_MAX_T"], 4 * t),
             "ops": (c["PAIR_OPS"], 4 * t * c["PAIR_OPERANDS"]), "list": (c["PAIR_LIST"], 4 * t),
             "counts": (c["PAIR_COUNTS"], 4 * c["PAIR_COUNT_WORDS"])}
    assert (c["PAIR_KEYS"], c["PAIR_OPS"]) == (0, 8 * t)  # the closest hit's key: 8 bytes a ray
    ends = sorted((lo, lo + n) for lo, n in spans.values())
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))  # disjoint
    assert ends[0][0] >= 0 and ends[-1][1] == c["PAIR_BYTES"]
    for k in range(1, 2049):
        lay = _layout(lib, min(k, c["TRACE_SLOT"]), pairs=True)
        assert lay["total"] == lib.trace_smem(k) <= OPTIN_BYTES, k
        for lo, n in spans.values():
            assert lay["pairs"] <= lay["pairs"] + lo and lay["pairs"] + lo + n <= lay["total"], k
            assert (lay["pairs"] + lo) % 16 == 0, k


# Dynamic shared memory a Hopper multiprocessor holds (228 KiB), and what
# the runtime reserves a block beside a kernel's own.
SM_SMEM_BYTES = 233_472
BLOCK_RESERVED_BYTES = 1_024


def _min_blocks(name: str) -> int:
    """A __launch_bounds__ minimum of csrc/wavefront.cuh by its constant's name."""
    import re

    src = open(os.path.join(os.path.dirname(cosig_tpu_torch.__file__), "csrc",
                            "wavefront.cuh")).read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# (build, its __launch_bounds__ minimum, the k its launches pick it for)
FISSION_BUILDS = (("trace", "TRACE_MIN_BLOCKS", range(1, 2049)),
                  ("shade", "SHADE_MIN_BLOCKS", range(1, 2049)),
                  ("shade_all slots", "SHADE_MIN_BLOCKS", range(33, 2049)),
                  ("primary_fission slots", "FISSION_PAIRS_MIN_BLOCKS", range(33, 2049)),
                  ("primary_fission", "FISSION_MIN_BLOCKS", range(1, 33)))


def test_fission_builds_fit_their_blocks_at_every_k(walk):
    """The exact trace and shade on a list walk in the compacted layout
    (trace_smem) at every k, the fission primary and the shade over every
    ray past 32 rows (their slots builds); the fission primary's per-warp
    walk holds whole clusters (walk_smem) up to 32 rows: each within what a
    block may opt into, and small enough that a multiprocessor's shared
    memory holds the blocks its __launch_bounds__ asks for (its registers
    held to it by ptxas), at every k its launches pick it for."""
    lib, _ = walk
    for kernel, bound, ks in FISSION_BUILDS:
        blocks = _min_blocks(bound)
        assert 4 <= blocks <= 8, (kernel, blocks)
        for k in ks:
            smem = lib.walk_smem(k, 0) if kernel == "primary_fission" else lib.trace_smem(k)
            assert smem <= OPTIN_BYTES, (kernel, k)
            assert SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES) >= blocks, (kernel, k, smem)


@pytest.mark.parametrize("rows", [1, 5, 32])
def test_pair_map_is_a_bijection(walk, rows):
    """For every n of 1-128 rays in a box, the block's threads take the n x
    rows pairs once each, thread t pair t + 128 i = (row p / n, ray p % n)
    (the cursor's steps, without a division per pair); n = 0 gives no
    pair."""
    lib, c = walk
    threads = c["TILE_THREADS"]
    buf = (ctypes.c_int * (2 * 128 * 32))()
    assert all(lib.thread_pairs(t, 0, rows, buf) == 0 for t in range(threads))
    for n in range(1, 129):
        seen = np.zeros((rows, n), np.int32)
        for t in range(threads):
            m = lib.thread_pairs(t, n, rows, buf)
            got = np.frombuffer(buf, np.int32, 2 * m).reshape(m, 2)
            p = t + threads * np.arange(m)
            assert np.array_equal(got[:, 0], p // n) and np.array_equal(got[:, 1], p % n)
            seen[got[:, 0], got[:, 1]] += 1
        assert np.all(seen == 1), n


def test_hit_key_minimum_is_the_lexicographic_winner(walk):
    """The (t, gid) key's minimum over a ray's candidates is numpy's
    lexicographic (t, gid) minimum (the per-ray fold's winner): random
    positive t with forced ties, denormals, FLT_MAX and +inf among them,
    gids below 2^24; the key of (FLT_MAX, 2^24) is the no-hit start."""
    lib, _ = walk
    rng = np.random.default_rng(0)
    for trial in range(300):
        n = int(rng.integers(1, 40))
        t = rng.uniform(1e-4, 100.0, n).astype(np.float32)
        if trial % 3 == 0:
            t[rng.integers(0, n, n // 2 + 1)] = t[0]  # ties in t
        if trial % 5 == 0:
            t[rng.integers(0, n)] = np.float32(1e-42)  # a denormal
        if trial % 7 == 0:
            t[rng.integers(0, n)] = np.inf
        if trial % 11 == 0:
            t[rng.integers(0, n)] = np.finfo(np.float32).max
        gid = rng.choice(2**24, n, replace=False).astype(np.uint32)
        keys = [lib.hit_key(int(tb), int(g)) for tb, g in zip(t.view(np.uint32), gid)]
        start = lib.hit_key(int(np.float32(np.finfo(np.float32).max).view(np.uint32)), 2**24)
        best = min(keys + [start])
        order = np.lexsort((gid, t))
        i = order[0]
        fold_wins = t[i] < np.finfo(np.float32).max or (
            t[i] == np.finfo(np.float32).max and gid[i] < 2**24)
        if fold_wins:
            assert best == keys[i], trial
            assert (best >> 32, best & 0xFFFFFFFF) == (int(t[i].view(np.uint32)), int(gid[i]))
        else:
            assert best == start, trial


def _compact_slots_model(n_in: np.ndarray, rows: int, slot: int = 32, block: int = 128) -> int:
    """The compacted schedule in numpy: per block with n rays in a
    cluster's box, per slot piece of r real rows, the block's threads take
    ceil(n r / block) turns of `block` slots."""
    total = 0
    for first in range(0, rows, slot):
        r = min(slot, rows - first)
        total += block * int(np.sum(-(-(n_in * r) // block)))
    return total


def _pruned_walk_model(cset, o, d, active, block: int = 128, slot: int = 32) -> tuple:
    """The compacted closest hit in numpy float32 (the plain cull's and pair
    test's operations): per block of ``block`` consecutive rays, its entered
    clusters near-first (the least max(tn, 0) over its rays in the box, NaN
    as 0, ties by cluster), each in pieces of ``slot`` rows; a ray in the
    box runs a piece unless its entry tn lies past its key's t by more than
    the margin of csrc/traverse.cuh prunes -> (pairs run, pairs pruned,
    slots of the pieces' n x rows pairs, the unpruned walk's slots)."""
    f = np.float32
    geom, box = cset.geom.numpy(), cset.aabb_t[:6].numpy()
    n_c, k = geom.shape[:2]
    inv = (f(1.0) / d).astype(f)
    w = np.stack([o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                  o[0] * d[1] - o[1] * d[0]])
    real = (geom[:, :, 35] != 2.0**24).sum(axis=1)
    l1 = (np.abs(geom[:, :, 3]) + np.abs(geom[:, :, 4])) + np.abs(geom[:, :, 5])
    o_inf = np.fmax(np.fmax(np.abs(o[0]), np.abs(o[1])), np.abs(o[2]))
    inf = f(np.finfo(f).max)
    tn_all = np.empty((n_c, o.shape[1]), f)
    enter = np.zeros((n_c, o.shape[1]), bool)
    t_rows = np.full((n_c, o.shape[1], k), np.inf, f)  # valid pairs' t, else inf
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for c in range(n_c):
            t0 = (box[:3, c, None] - o) * inv
            t1 = (box[3:, c, None] - o) * inv
            tn_all[c] = np.maximum.reduce(np.minimum(t0, t1))
            tf = np.minimum.reduce(np.maximum(t0, t1))
            enter[c] = ~(tn_all[c] > tf) & ~(tf < 0) & active
            g = geom[c]

            def vol(b):
                return (d[0, :, None] * g[:, b] + d[1, :, None] * g[:, b + 1]
                        + d[2, :, None] * g[:, b + 2] + w[0, :, None] * g[:, b + 3]
                        + w[1, :, None] * g[:, b + 4] + w[2, :, None] * g[:, b + 5])

            va, vb, vc = vol(7), vol(13), vol(19)
            sv = d[0, :, None] * g[:, 3] + d[1, :, None] * g[:, 4] + d[2, :, None] * g[:, 5]
            ndo = o[0, :, None] * g[:, 3] + o[1, :, None] * g[:, 4] + o[2, :, None] * g[:, 5]
            t = (g[:, 6] - ndo) * (f(1.0) / sv)
            ok = ((np.abs(sv) >= f(1e-4)) & (va * sv >= 0) & (vb * sv >= 0) & (vc * sv >= 0)
                  & (t > f(1e-4)))
            t_rows[c] = np.where(ok, t, np.inf)
        run = pruned = slots = unpruned = 0
        for b0 in range(0, o.shape[1], block):
            rays = np.arange(b0, min(b0 + block, o.shape[1]))
            ent = enter[:, rays]
            listed = np.flatnonzero(ent.any(axis=1))
            near = np.where(tn_all[:, rays] > 0, tn_all[:, rays], f(0.0))
            near = np.where(ent, np.where(np.isnan(near), f(0.0), near), np.inf)
            order = listed[np.lexsort((listed, near[listed].min(axis=1)))]
            key = np.full(rays.size, inf, f)
            for c in order:
                bmax = np.abs(box[:, c]).max()
                for first in range(0, int(real[c]), slot):
                    r = min(slot, int(real[c]) - first)
                    n1 = l1[c, first:first + slot].max()
                    margin = ((o_inf[rays] + bmax) + key) * n1 * f(5e-3) + key * f(2.0**-20)
                    cut = (key < inf) & (tn_all[c, rays] > key + margin)
                    keep = ent[c] & ~cut
                    run += int(keep.sum()) * r
                    pruned += int((ent[c] & cut).sum()) * r
                    slots += block * -(-int(keep.sum()) * r // block)
                    unpruned += block * -(-int(ent[c].sum()) * r // block)
                    piece = t_rows[c][rays, first:first + r].min(axis=1)
                    key = np.where(keep, np.minimum(key, piece), key)
    return run, pruned, slots, unpruned


def test_pair_slots_follow_the_compacted_schedule():
    """kernel_core.WORK["pair_slots"] (phase 3's compacted model, counted by
    the plain traversal with a ray -> warp map) equals the numpy model of
    the schedule on the same box entries, the walk near-first and
    distance-pruned (_pruned_walk_model), and so do the pairs it runs and
    prunes: large_mesh's clusters at k = 64, rays from random origins,
    blocks of 128 consecutive rays; the unpruned schedule
    (_compact_slots_model) takes more slots."""
    s = chip_smoke.scene_setup("large_mesh", dict(resolution_override=(8, 8)), "cpu")
    cset = s["cset"]
    rng = np.random.default_rng(1)
    n = 700
    o = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    active = np.ones(n, bool)
    active[::9] = False
    warps = torch.arange(n) // 32
    tkc.reset_work()
    tkc.traverse(cset, *(torch.from_numpy(x) for x in (*o, *d)), torch.from_numpy(active),
                 warps=warps)
    got = tkc.WORK["pair_slots"]
    run, pruned, want, unpruned = _pruned_walk_model(cset, o, d, active)
    assert got == want > 0
    assert (tkc.WORK["pair_tests"], tkc.WORK["pairs_pruned"]) == (run, pruned)
    assert pruned > 0 and tkc.WORK["pair_tests"] <= got < unpruned
    # The unpruned schedule on the same entries, cluster by cluster.
    box = cset.aabb_t[:6].numpy()
    inv = (np.float32(1.0) / d).astype(np.float32)
    real = (cset.geom[:, :, 35] != 2.0**24).sum(dim=1).numpy()
    flat = 0
    with np.errstate(invalid="ignore", divide="ignore"):
        for c in range(cset.num_clusters):
            t0 = (box[:3, c, None] - o) * inv
            t1 = (box[3:, c, None] - o) * inv
            tn = np.maximum.reduce(np.minimum(t0, t1))
            tf = np.minimum.reduce(np.maximum(t0, t1))
            enter = ~(tn > tf) & ~(tf < 0) & active
            if not enter.any():
                continue
            blocks = np.arange(n)[enter] // 128
            flat += _compact_slots_model(np.bincount(blocks)[np.unique(blocks)], int(real[c]))
    assert flat == unpruned


@pytest.mark.parametrize("sb", [0, 1])
def test_build_labels_name_the_slot_builds(sb):
    """kernels.sass.build_label reads the last template flag (PC, the walk
    in slots) of every ray kernel and names those builds `<counter> slots`,
    so ptxas_resources keeps them apart from the builds without."""
    builds = [("primary_kernel", (0, 0, 0), "primary"),
              ("primary_kernel", (1, 0, 1), "primary_shadow_mx"),
              ("primary_kernel", (0, 1, 0), "primary_fission"),
              ("bounce_kernel", (0, 0), "bounce"), ("bounce_kernel", (1, 1), "bounce_shadow_mx"),
              ("trace_kernel", (1,), "trace_mx"), ("shade_kernel", (1, 0), "shade"),
              ("shade_kernel", (0, 1), "shade_all_mx"), ("megakernel", (0,), "megakernel"),
              ("debug_kernel", (), "debug")]
    for base, flags, label in builds:
        for pc in (0, 1):
            args = "".join(f"Lb{f}E" for f in (sb, *flags, pc))
            mangled = f"_ZN5cosig{len(base)}{base}I{args}EEvNS_5FrameEPKf"
            want = label + (" slots" if pc else "")
            assert sass.build_label(mangled) == (want, bool(sb)), mangled
    # The exact builds with a compacted walk at every k (PC false) carry
    # their counters' names, which the kernels line looks their ptxas lines
    # up by (chip_smoke.COMPACTED_BUILDS).
    compacted = [("trace_kernel", (0,)), ("shade_kernel", (1, 0))]
    got = [sass.build_label(f"_ZN5cosig{len(b)}{b}I"
                            + "".join(f"Lb{f}E" for f in (sb, *fl, 0)) + "EEvNS_5FrameEPKf")
           for b, fl in compacted]
    assert got == [(n, bool(sb)) for n in chip_smoke.COMPACTED_BUILDS]
