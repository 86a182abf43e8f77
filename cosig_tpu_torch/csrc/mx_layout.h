// The shared-memory tile of the tensor-core pair test's geometry operand
// (operand B of wgmma, mx_pair.cuh) and the matrix descriptors that read
// it: plain C++ with no CUDA include, so that a host compiler builds it
// too (tests/test_torch_mxu.py holds it to the PTX ISA's canonical layout).
//
// One tile holds one n-tile: MX_TILE_ROWS geometry rows, as the B columns
// of the five planes, plane-major (column 8 p + r is plane p of row r;
// planes va, vb, vc and s against operand X, num against operand Z). The
// K dimension is the 48 columns of mx_pair.cuh: column 8 h + q of k-step s
// holds geometry limb j of input slot q, (j, k) = MX_COMBOS[2 s + h]. The
// geometry limbs of the six combos are 0, 0 | 1, 0 | 1, 2, so a column's
// 48 values are three distinct 8-slot rows of limbs. The tile stores
// each column's limb rows once per use that a descriptor can reach: four
// cores (G0, G1, G0, G2), and k-step s reads cores mx_step_core(s, 0) and
// mx_step_core(s, 1), both at non-negative distances from its start.
//
// Layout: wgmma's canonical K-major layout without swizzle (PTX ISA,
// "Shared Memory Matrix Layout", layout type 0): 8 x 16-byte core
// matrices, row r of a core at 16 r; the two cores of a k-step LBO bytes
// apart (the leading dimension, K); the next 8 columns SBO bytes on (the
// stride dimension, N). Here a plane's column group is MX_GROUP_BYTES
// (its four cores, 128 bytes each), so SBO = MX_GROUP_BYTES, and the
// X operand's 32 columns are planes 0-3, one descriptor; the Z operand's 8
// are plane 4.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MX_HD __host__ __device__
#else
#define MX_HD
#endif

namespace cosig {

constexpr int MX_TILE_ROWS = 8;     // rows of an n-tile (kernel_core.MX_ROWS)
constexpr int MX_PLANES = 5;        // va, vb, vc, s (operand X), num (operand Z)
constexpr int MX_SLOTS = 8;         // input slots of a limb row: 16 bytes of bf16
constexpr int MX_CORES = 4;         // limb rows a column keeps: G0, G1, G0, G2
constexpr int MX_CORE_BYTES = MX_TILE_ROWS * MX_SLOTS * 2;    // 128
constexpr int MX_GROUP_BYTES = MX_CORES * MX_CORE_BYTES;      // 512: SBO
constexpr int MX_B_BYTES = MX_PLANES * MX_GROUP_BYTES;        // 2,560 a tile
constexpr int MX_B_ALIGN = 128;     // a tile's alignment in shared memory

// The geometry limb that core c holds.
MX_HD constexpr int mx_core_limb(int c) { return c == 1 ? 1 : c == 3 ? 2 : 0; }

// The core that half h (K columns 8 h .. 8 h + 7) of k-step s reads:
// (G0, G0'), (G1, G0'), (G1, G2).
MX_HD constexpr int mx_step_core(int s, int h) {
  return h == 0 ? (s == 0 ? 0 : 1) : (s == 2 ? 3 : 2);
}

// Byte offset in a tile of slot q of row r's plane p, in core c.
MX_HD constexpr int mx_b_offset(int p, int c, int r, int q) {
  return p * MX_GROUP_BYTES + c * MX_CORE_BYTES + r * 16 + q * 2;
}

// The wgmma shared-memory matrix descriptor of k-step s of the operand
// whose first plane is p0 (X: 0, Z: 4), in the tile at shared address
// `tile` (16-byte units in 14-bit fields): start address bits 0-13,
// leading byte offset 16-29, stride byte offset 32-45, base offset 49-51
// (0: no swizzle), layout type 62-63 (0: no swizzle).
MX_HD inline uint64_t mx_desc(uint32_t tile, int p0, int s) {
  const uint32_t start = tile + (uint32_t)mx_b_offset(p0, mx_step_core(s, 0), 0, 0);
  const uint32_t lbo = (uint32_t)((mx_step_core(s, 1) - mx_step_core(s, 0)) * MX_CORE_BYTES);
  const uint32_t sbo = (uint32_t)MX_GROUP_BYTES;
  return (uint64_t)((start >> 4) & 0x3fffu) | ((uint64_t)((lbo >> 4) & 0x3fffu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fffu) << 32);
}

}  // namespace cosig
