// Deterministic hash RNG (BVHRayTracing.compute:108-131), float32.
//
// Device twin of cosig_tpu_torch/ops/rng.py and cosig_tpu/ops/rng.py: the
// same operations in the same order. Built with --fmad=false, so no
// multiply-add is contracted and every result is bit-equal to the plain
// PyTorch version.
#pragma once

namespace cosig {

constexpr float TWO_PI = 6.2831853f;

__device__ __forceinline__ float frac(float x) { return x - floorf(x); }

// compute:108-113
__device__ __forceinline__ void hash22(float px, float py, float& h0, float& h1) {
  float p3x = frac(px * 0.1031f);
  float p3y = frac(py * 0.1030f);
  float p3z = frac(px * 0.0973f);
  float d = p3x * (p3y + 33.33f) + p3y * (p3z + 33.33f) + p3z * (p3x + 33.33f);
  p3x = p3x + d;
  p3y = p3y + d;
  p3z = p3z + d;
  h0 = frac((p3x + p3y) * p3z);
  h1 = frac((p3x + p3z) * p3y);
}

// compute:116-121
__device__ __forceinline__ void hash33(float px, float py, float pz,
                                       float& h0, float& h1, float& h2) {
  float x = frac(px * 0.1031f);
  float y = frac(py * 0.1030f);
  float z = frac(pz * 0.0973f);
  float d = x * (y + 33.33f) + y * (x + 33.33f) + z * (z + 33.33f);
  x = x + d;
  y = y + d;
  z = z + d;
  h0 = frac((x + y) * z);
  h1 = frac((x + x) * y);
  h2 = frac((y + x) * x);
}

}  // namespace cosig
