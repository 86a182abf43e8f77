// One Whitted bounce on one ray, in registers.
//
// Replaces cosig_tpu/ops/kernel_core.py bounce_core (:1058-1270), which
// the TPU kernels run on (1, R) lane planes with every state write behind
// a where(). Here the ray's state lives in registers and the kernel
// writes it back once. The arithmetic mirrors the plain PyTorch version
// (cosig_tpu_torch/ops/kernel_core.py bounce_core) line for line, with the
// where() selects kept as selects, so the two agree to the bit wherever
// the operations are IEEE (sinf/cosf in the soft-shadow and glossy jitter
// are the only exception).
//
// Bound: the two traversals (closest hit, then one any-hit shadow ray per
// light), see traverse.cuh. Shading itself is a few hundred flops per
// ray.
//
// bounce_core walks with BlockWalk (traverse_tile.cuh), the block's rays
// together, so every thread of the block calls it, dead rays and threads
// without a ray too: a dead ray's bounce changes nothing (its colour gains
// +0, its count 0, its state stays) and it enters no box.
//
// Its two halves are the wavefront's fission form (kernel_core.py
// bounce_trace and bounce_core(rec=...), :1042-1090): bounce_trace counts
// and traces the closest hit, bounce_shade takes that hit (or the record
// a trace kernel stored) and does the rest. The overload with a second
// walk sends the shadow rays through a separate cluster set (cset_shadow)
// after handing it the block's shared memory (traverse_tile.cuh handoff).
#pragma once

#include "rng.cuh"
#include "traverse_tile.cuh"

namespace cosig {

constexpr float OFFSET = 1e-2f;

// Uniform slots (kernel_core.py U_*).
constexpr int U_CAM = 0, U_DIST = 12, U_PLANE_H = 13, U_ORTHO = 14, U_BG = 15,
              U_INTENSITY = 18, U_LIGHT_SIZE = 19, U_ROUGHNESS = 20, U_SHUTTER = 21,
              U_ROW_OFF = 22, UNIFORMS_LEN = 25;

// StaticConfig toggles as one runtime bitmask, and F_MX_SHADOW: in the
// builds with the tensor-core pair test (MX), the shadow rays take it too
// (full mode; without it closest-only mode, the JAX package's
// COSIG_MXU_SHADOW=0).
constexpr int F_AMBIENT = 1, F_DIFFUSE = 2, F_SPECULAR = 4, F_REFRACTION = 8,
              F_ORTHO = 16, F_SOFT_SHADOWS = 32, F_GLOSSY = 64, F_MOTION_BLUR = 128,
              F_MULTI_LIGHT = 256, F_MX_SHADOW = 512;

constexpr int MAX_MATS = 64;
constexpr int MAX_LIGHTS = 16;

// The per-frame inputs: uniforms, materials and lights, in device memory
// that every kernel reads through Frame::data on the read-only path. A
// captured frame (a CUDA graph) keeps the pointer, so a replay reads what
// the host last copied there. Mirrored by
// cosig_tpu_torch/kernels/binding.py FRAME_DATA; all fields are 4 bytes.
struct FrameData {
  float u[UNIFORMS_LEN];
  int n_mats, n_lights;
  float mats[MAX_MATS * 8];      // color rgb, ambient, diffuse, specular, refraction, ior
  float lights[MAX_LIGHTS * 8];  // position xyz, rgb, pad, pad
};

// A launch's own parameters, by value (the kernel's constant parameter
// bank): the static configuration, the band, the thread count, the
// bounce, and the frame data's address. Mirrored by
// cosig_tpu_torch/kernels/binding.py Frame.
struct Frame {
  int flags;
  int width, height, band, aa, grid_w, grid_h;
  float aspect;  // float32(width / height)
  int n_rays;
  int depth, is_last;
  const FrameData* data;
};

// Uniform slot i of the frame.
__device__ __forceinline__ float uni(const Frame& f, int i) { return __ldg(f.data->u + i); }

struct RayState {
  float ox, oy, oz, dx, dy, dz;
  float at_r, at_g, at_b;
  float col_r, col_g, col_b;
  float count;
  bool alive;
};

__device__ __forceinline__ void rsqrt3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float pow32(float x) {
  const float x2 = x * x;
  const float x4 = x2 * x2;
  const float x8 = x4 * x4;
  const float x16 = x8 * x8;
  return x16 * x16;
}

// random_unit_vector (compute:124-131).
__device__ __forceinline__ void random_unit(float sx, float sy, float sz, float& rx,
                                            float& ry, float& rz) {
  float h0, h1, h2;
  hash33(sx, sy, sz, h0, h1, h2);
  const float z = h2 * 2.0f - 1.0f;
  const float a = h0 * TWO_PI;
  const float r = sqrtf(nan_max(0.0f, 1.0f - z * z));
  rx = r * cosf(a);
  ry = r * sinf(a);
  rz = z;
}

// The closest-hit half of a bounce (kernel_core.py bounce_trace): count a
// live ray and trace it. frustum (the same in every thread) runs the block
// walk's frustum pre-cull, for coherent rays.
template <class Walk>
__device__ __forceinline__ Hit bounce_trace(Walk& walk, RayState& st, bool frustum) {
  st.count = st.count + (st.alive ? 1.0f : 0.0f);
  return walk.closest(st.ox, st.oy, st.oz, st.dx, st.dy, st.dz, st.alive, frustum);
}

// The shade half (kernel_core.py:1089-1270 after the trace): the hit h of
// the ray, then the background or the shading, the shadow rays through
// `walk`, and the secondary ray. px/py/s are the RNG seeds, depth the
// bounce index; is_last retires the ray after shading; frustum runs the
// frustum pre-cull in the shadow rays' walks. PAIRS: the shadow rays take
// the compacted any hit (traverse_tile.cuh any_pairs; the exact shade
// kernel's), else any().
template <bool PAIRS = false, class Walk>
__device__ __forceinline__ void bounce_shade(const Frame& f, Walk& walk, RayState& st,
                                             const Hit& h, float px, float py, float s,
                                             float depth, bool is_last, bool frustum) {
  const float bg_r = uni(f, U_BG), bg_g = uni(f, U_BG + 1), bg_b = uni(f, U_BG + 2);
  const float intensity = uni(f, U_INTENSITY);
  const float light_size = uni(f, U_LIGHT_SIZE);
  const float roughness = uni(f, U_ROUGHNESS);
  const float ox = st.ox, oy = st.oy, oz = st.oz;
  const float dx = st.dx, dy = st.dy, dz = st.dz;
  float at_r = st.at_r, at_g = st.at_g, at_b = st.at_b;
  bool alive = st.alive;
  const float t = h.t, nx = h.nx, ny = h.ny, nz = h.nz;

  const bool miss = alive && !h.hit;
  float col_r = st.col_r + (miss ? at_r * bg_r : 0.0f);
  float col_g = st.col_g + (miss ? at_g * bg_g : 0.0f);
  float col_b = st.col_b + (miss ? at_b * bg_b : 0.0f);
  alive = alive && h.hit;

  const float hx = ox + t * dx;
  const float hy = oy + t * dy;
  const float hz = oz + t * dz;

  // Material select, defaults for a miss or an out-of-range index.
  float cr = 1.0f, cg = 1.0f, cb = 1.0f, ka = 0.1f, kd = 0.7f, ks = 0.0f, krefr = 0.0f,
        ior = 1.0f;
  // The one m in [0, n_mats) with h.mat == m, read directly: a NaN or a
  // fractional h.mat matches none.
  const int m = (int)h.mat;
  if (m >= 0 && m < __ldg(&f.data->n_mats) && (float)m == h.mat) {
    const float* __restrict__ mm = f.data->mats + m * 8;
    cr = __ldg(mm + 0); cg = __ldg(mm + 1); cb = __ldg(mm + 2); ka = __ldg(mm + 3);
    kd = __ldg(mm + 4); ks = __ldg(mm + 5); krefr = __ldg(mm + 6); ior = __ldg(mm + 7);
  }

  const bool ambient = f.flags & F_AMBIENT;
  float loc_r = ambient ? cr * ka : 0.0f;
  float loc_g = ambient ? cg * ka : 0.0f;
  float loc_b = ambient ? cb * ka : 0.0f;

  const int n_lights = __ldg(&f.data->n_lights);
  for (int li = 0; li < n_lights; ++li) {
    const float* __restrict__ L = f.data->lights + li * 8;
    float lpx = __ldg(L + 0), lpy = __ldg(L + 1), lpz = __ldg(L + 2);
    if (f.flags & F_SOFT_SHADOWS) {
      float jx, jy, jz;
      random_unit(px + s * 9.0f, py + s * 4.0f + depth, s, jx, jy, jz);
      lpx = lpx + jx * light_size;
      lpy = lpy + jy * light_size;
      lpz = lpz + jz * light_size;
    }
    const float tlx = lpx - hx;
    const float tly = lpy - hy;
    const float tlz = lpz - hz;
    const float dist_l = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    float ldx = tlx, ldy = tly, ldz = tlz;
    rsqrt3(ldx, ldy, ldz);
    const float ndl = nan_max(0.0f, nx * ldx + ny * ldy + nz * ldz);

    if (f.flags & F_DIFFUSE) {
      const bool shadow_active = alive && (ndl > 0.0f);
      st.count = st.count + (shadow_active ? 1.0f : 0.0f);
      bool occluded;
      if constexpr (PAIRS) {
        occluded = walk.any_pairs(hx + nx * OFFSET, hy + ny * OFFSET, hz + nz * OFFSET, ldx, ldy,
                                  ldz, dist_l, shadow_active, frustum);
      } else {
        occluded = walk.any(hx + nx * OFFSET, hy + ny * OFFSET, hz + nz * OFFSET, ldx, ldy, ldz,
                            dist_l, shadow_active, frustum);
      }
      const bool gate = !occluded && (ndl > 0.0f) && alive;
      float dr = cr * kd * ndl;
      float dg = cg * kd * ndl;
      float db = cb * kd * ndl;
      if (f.flags & F_SPECULAR) {
        float hvx = ldx - dx, hvy = ldy - dy, hvz = ldz - dz;
        rsqrt3(hvx, hvy, hvz);
        const float spec = pow32(nan_max(nx * hvx + ny * hvy + nz * hvz, 0.0f));
        dr = dr + ks * spec;
        dg = dg + ks * spec;
        db = db + ks * spec;
      }
      if (f.flags & F_MULTI_LIGHT) {
        dr = dr * __ldg(L + 3);
        dg = dg * __ldg(L + 4);
        db = db * __ldg(L + 5);
      }
      loc_r = loc_r + (gate ? dr : 0.0f);
      loc_g = loc_g + (gate ? dg : 0.0f);
      loc_b = loc_b + (gate ? db : 0.0f);
    }
  }

  st.col_r = col_r + (alive ? at_r * loc_r * intensity : 0.0f);
  st.col_g = col_g + (alive ? at_g * loc_g * intensity : 0.0f);
  st.col_b = col_b + (alive ? at_b * loc_b * intensity : 0.0f);

  if (is_last) {
    st.alive = false;  // no secondary rays after the final bounce
    return;
  }

  // ---- secondary ray (compute:420-455) ----
  const bool should_reflect = ks > 0.0f;
  const bool should_refract = (f.flags & F_REFRACTION) && (krefr > 0.0f);

  const float cos_in = dx * nx + dy * ny + dz * nz;
  const bool exiting = cos_in > 0.0f;
  const float fnx = exiting ? -nx : nx;
  const float fny = exiting ? -ny : ny;
  const float fnz = exiting ? -nz : nz;
  const float eta = exiting ? ior : 1.0f / ior;
  const float cosv = -(dx * fnx + dy * fny + dz * fnz);
  const float kk = 1.0f - eta * eta * (1.0f - cosv * cosv);
  const bool tir = kk < 0.0f;
  const float coef = eta * cosv - sqrtf(nan_max(kk, 0.0f));
  const float rfx = eta * dx + coef * fnx;
  const float rfy = eta * dy + coef * fny;
  const float rfz = eta * dz + coef * fnz;
  const float dot_f = dx * fnx + dy * fny + dz * fnz;
  const float tirx = dx - 2.0f * dot_f * fnx;
  const float tiry = dy - 2.0f * dot_f * fny;
  const float tirz = dz - 2.0f * dot_f * fnz;
  const float rpx = dx - 2.0f * cos_in * nx;
  const float rpy = dy - 2.0f * cos_in * ny;
  const float rpz = dz - 2.0f * cos_in * nz;

  float ndx = should_refract ? (tir ? tirx : rfx) : rpx;
  float ndy = should_refract ? (tir ? tiry : rfy) : rpy;
  float ndz = should_refract ? (tir ? tirz : rfz) : rpz;
  const float amr = should_refract ? (tir ? cr * ks : cr * krefr) : cr * ks;
  const float amg = should_refract ? (tir ? cg * ks : cg * krefr) : cg * ks;
  const float amb = should_refract ? (tir ? cb * ks : cb * krefr) : cb * ks;
  const float sox = should_refract ? (tir ? hx + fnx * OFFSET : hx + rfx * OFFSET)
                                   : hx + nx * OFFSET;
  const float soy = should_refract ? (tir ? hy + fny * OFFSET : hy + rfy * OFFSET)
                                   : hy + ny * OFFSET;
  const float soz = should_refract ? (tir ? hz + fnz * OFFSET : hz + rfz * OFFSET)
                                   : hz + nz * OFFSET;

  if (f.flags & F_GLOSSY) {
    float gx, gy, gz;
    random_unit(px + s * 55.0f + depth, py + s * 22.0f, 13.0f * depth, gx, gy, gz);
    ndx = ndx + gx * roughness;
    ndy = ndy + gy * roughness;
    ndz = ndz + gz * roughness;
  }

  const bool cont = alive && (should_reflect || should_refract);
  rsqrt3(ndx, ndy, ndz);
  if (cont) {
    at_r = at_r * amr;
    at_g = at_g * amg;
    at_b = at_b * amb;
    st.ox = sox; st.oy = soy; st.oz = soz;
    st.dx = ndx; st.dy = ndy; st.dz = ndz;
  }
  st.at_r = at_r;
  st.at_g = at_g;
  st.at_b = at_b;
  st.alive = cont && (nan_max(nan_max(at_r, at_g), at_b) > 0.0f);
}

// One bounce on a live ray (kernel_core.py bounce_core): trace, then shade,
// both through `walk`.
template <class Walk>
__device__ __forceinline__ void bounce_core(const Frame& f, Walk& walk, RayState& st,
                                            float px, float py, float s,
                                            float depth, bool is_last, bool frustum) {
  const Hit h = bounce_trace(walk, st, frustum);
  bounce_shade(f, walk, st, h, px, py, s, depth, is_last, frustum);
}

// One bounce whose shadow rays walk a separate cluster set: trace through
// `walk`, hand the block's shared memory to `shadow`, shade through it.
template <class Walk, class ShadowWalk>
__device__ __forceinline__ void bounce_core(const Frame& f, Walk& walk, ShadowWalk& shadow,
                                            RayState& st, float px, float py, float s,
                                            float depth, bool is_last, bool frustum) {
  const Hit h = bounce_trace(walk, st, frustum);
  handoff(walk, shadow);
  bounce_shade(f, shadow, st, h, px, py, s, depth, is_last, frustum);
}

}  // namespace cosig
