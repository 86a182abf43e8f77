// The block walk's shared-memory layout and its slot arithmetic
// (traverse_tile.cuh), and the pair map and hit key of the trace's
// compacted closest hit: plain C++ with no CUDA include, so that a host
// compiler builds it too (tests/test_torch_walk_layout.py holds it to its
// rules).
//
// The ring. A walk streams each listed cluster's rows into a ring of
// RING_STAGES slots. A slot holds `rows` rows of ROW_BYTES: the walk's
// slot size, at most its clusters' k. A cluster of k rows takes
// slot_pieces(k, rows) consecutive copies, piece p its rows piece_first(p,
// rows) .. + piece_rows(k, rows, p) - 1, so a cluster larger than a slot
// is copied and walked a slot at a time. The walks of the main set take
// walk_rows(k) = min(k, SLOT_MAX): one piece a cluster up to k = 128 (the
// layout of every build before slots), then slots of 128 rows, so no k
// outgrows what a block may opt into (232,448 B on the H100). A shadow
// walk takes shadow_rows(k, sh_k), no more rows than the main walk's slot,
// so the block's shared memory is the main walk's (both_smem). The
// compacted walks (the trace's and the fission primary's closest hit, the
// exact shade's any hit) take slots of TRACE_SLOT rows and PAIR_BYTES
// more.
#pragma once

#include <stdint.h>

#include "mx_layout.h"

namespace cosig {

constexpr int TILE_THREADS = 128;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int TILE_C = 256;      // clusters culled and listed per pass
constexpr int CULL_GROUP = 8;    // consecutive clusters under one union box (the two-level cull)
constexpr int RING_STAGES = 3;   // slots in flight
constexpr int ROW_BYTES = 36 * 4;  // a geometry row: 144 = 9 sixteen-byte words
constexpr int HULL_SLOTS = 16;   // a warp's partial hull: 13 floats and the flag bits
constexpr int HULL_BYTES = 84;   // sizeof(Hull) (traverse.cuh; checked there)
constexpr int SLOT_MAX = 128;    // rows of a main walk's slot past k = 128
constexpr int TRACE_SLOT = 32;   // rows of the trace's slot: one warp ballot
// The compacted walks' region, byte offsets within it: per ray the closest
// hit's (t, gid) key (8 bytes), or in the same bytes the any hit's flag
// (4: occluded, or not walking) and max_t (4); then the ray operands
// [PAIR_OPERANDS][TILE_THREADS] and the list of the rays in the box.
constexpr int PAIR_OPERANDS = 9;  // ox, oy, oz, dx, dy, dz, wx, wy, wz
constexpr int PAIR_KEYS = 0;
constexpr int PAIR_FLAGS = 0;
constexpr int PAIR_MAX_T = TILE_THREADS * 4;
constexpr int PAIR_OPS = TILE_THREADS * 8;
constexpr int PAIR_LIST = PAIR_OPS + TILE_THREADS * 4 * PAIR_OPERANDS;
// Last, the closest hit's four count words (PAIR_COUNT_WORDS): the pairs
// run and the pairs pruned by the block, then the two counters of its
// pieces' ray lists, used in turn piece by piece.
constexpr int PAIR_COUNTS = PAIR_LIST + TILE_THREADS * 4;
constexpr int PAIR_COUNT_WORDS = 4;
constexpr int PAIRS_RUN = 0, PAIRS_PRUNED = 1, PAIRS_IN_BOX = 2;
constexpr int PAIR_BYTES = PAIR_COUNTS + 4 * PAIR_COUNT_WORDS;  // 6,160
// The block's count words (the layout's `count` region): the list's
// length, the frustum candidates' count, the hull's flag and the rays in
// the hull, which each cull pass rewrites, and what the block adds to its
// launch's counters (traverse_tile.cuh add_counts, add_shadow_counts): its
// box tests, the pairs its per-warp walks and compacted any hits run, and
// the shadow rays its any hits cast.
constexpr int COUNT_WORDS = 8;
constexpr int COUNT_BOX_TESTS = 3, COUNT_PAIRS_RUN = 4, COUNT_HULL_RAYS = 5,
              COUNT_SHADOW_RAYS = 6;

// Rows of a slot of at most `cap` rows over clusters of k rows.
MX_HD constexpr int slot_rows(int k, int cap) { return k < cap ? k : cap; }
// Copies (pieces) a cluster of k rows takes in slots of `rows` rows.
MX_HD constexpr int slot_pieces(int k, int rows) { return (k + rows - 1) / rows; }
// The cluster's first row of piece p, and the piece's rows (the last may be short).
MX_HD constexpr int piece_first(int p, int rows) { return p * rows; }
MX_HD constexpr int piece_rows(int k, int rows, int p) {
  return k - p * rows < rows ? k - p * rows : rows;
}
// The slot rows of a main walk, and of the shadow walk that follows it.
MX_HD constexpr int walk_rows(int k) { return slot_rows(k, SLOT_MAX); }
MX_HD constexpr int shadow_rows(int k, int sh_k) { return slot_rows(sh_k, walk_rows(k)); }

// Dynamic shared memory of a walk whose slots hold `rows` rows: the ring,
// the boxes [TILE_C][8], the union boxes of their groups of CULL_GROUP
// [TILE_C / CULL_GROUP][8], the ballots [TILE_C][TILE_WARPS], the list, the
// frustum candidates (the clusters of a pass the block's hull passes, in
// order) and their flag words, the warps' partial hulls
// [TILE_WARPS][HULL_SLOTS], the block's hull, the mbarriers, the two
// list lengths, the hull's flag and the block's counts (COUNT_WORDS), and with
// `mx` the two B tiles of the tensor-core pair test
// (mx_layout.h, MX_B_BYTES each, at a multiple of MX_B_ALIGN), with
// `pairs` the compacted walk's region. Every offset is a multiple of 16.
struct TileLayout {
  unsigned ring, boxes, groups, ballots, list, cand, pre, partial, hull, bars, count, mxb, pairs,
      total;
};

MX_HD inline TileLayout tile_layout(int rows, bool mx = false, bool pairs = false) {
  TileLayout l;
  l.ring = 0;
  l.boxes = (unsigned)(RING_STAGES * rows * ROW_BYTES);
  l.groups = l.boxes + TILE_C * 32;
  l.ballots = l.groups + TILE_C / CULL_GROUP * 32;
  l.list = l.ballots + TILE_C * TILE_WARPS * 4;
  l.cand = l.list + TILE_C * 4;
  l.pre = l.cand + TILE_C * 4;
  l.partial = l.pre + 16 * ((TILE_C / 32 * 4 + 15) / 16);
  l.hull = l.partial + TILE_WARPS * HULL_SLOTS * 4;
  l.bars = l.hull + 16 * ((HULL_BYTES + 4 + 15) / 16);
  l.count = l.bars + 16 * ((RING_STAGES * 8 + 15) / 16);
  l.mxb = l.count + 4 * COUNT_WORDS;
  if (mx) l.mxb = (l.mxb + MX_B_ALIGN - 1) / MX_B_ALIGN * MX_B_ALIGN;
  l.pairs = l.mxb + (mx ? 2u * MX_B_BYTES : 0u);
  l.total = l.pairs + (pairs ? (unsigned)PAIR_BYTES : 0u);
  return l;
}

// A main walk's shared memory over clusters of k rows.
MX_HD inline int walk_smem(int k, bool mx = false) {
  return (int)tile_layout(walk_rows(k), mx).total;
}
// A block that walks k-row clusters, then hands its memory to an exact
// walk over sh_k-row clusters (traverse_tile.cuh handoff): the main walk's
// layout, since the shadow walk's slots are no larger.
MX_HD inline int both_smem(int k, int sh_k, bool mx = false) {
  const int sh = (int)tile_layout(shadow_rows(k, sh_k)).total;
  const int main = walk_smem(k, mx);
  return main > sh ? main : sh;
}
// A compacted walk over clusters of k rows (the trace's, the fission
// primary's, the exact shade's).
MX_HD inline int trace_smem(int k) {
  return (int)tile_layout(slot_rows(k, TRACE_SLOT), false, true).total;
}

// The compacted pair loop: with n rays in a cluster's box and `rows` rows
// in the slot, pair p of the n x rows is (row p / n, ray p % n), so a
// warp's lanes read one row (a broadcast); thread t takes pairs t, t +
// TILE_THREADS, ... A cursor walks them without a division per pair.
struct PairCursor {
  int row, ray, drow, dray;
};

MX_HD inline PairCursor pair_first(int t, int n) {
  PairCursor c;
  c.row = t / n;
  c.ray = t - c.row * n;
  c.drow = TILE_THREADS / n;
  c.dray = TILE_THREADS - c.drow * n;
  return c;
}

MX_HD inline void pair_next(PairCursor& c, int n) {
  c.row += c.drow;
  c.ray += c.dray;
  if (c.ray >= n) {
    c.ray -= n;
    ++c.row;
  }
}

// The closest-hit fold's (t, gid) as one 64-bit key, t's float bits above
// the gid: a valid t is positive, and positive floats (denormals and +inf
// too) order as their bits, so the key's minimum is the lexicographic (t,
// gid) minimum that the per-ray fold keeps.
MX_HD constexpr uint64_t hit_key(uint32_t t_bits, uint32_t gid) {
  return ((uint64_t)t_bits << 32) | gid;
}

}  // namespace cosig
