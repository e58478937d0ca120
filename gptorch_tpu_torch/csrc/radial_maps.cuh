// The radial maps of gptorch_tpu/ops/gpr_fast.py:82-136 and the arithmetic
// helpers they need, shared by the kernels that recompute a radial Gram
// entry from r2 = |xs_i - xs_j|^2 (radial_contract.cu, radial_mvm.cu,
// lowrank_contract.cu).
//
//   G = k(r2) / var          the noiseless Gram at var = 1
//   E = -2 dk/dr2 / var      the map of d/d log ell (dK_ij/d log ell_q = E_ij (xs_iq - xs_jq)^2)
//   F = dk/d log alpha / var rq only (else 0)
//
// In float32 exp(c x) is the hardware's ex2.approx.ftz of x c log2(e), the
// constant folded: two instructions; log, square root and reciprocal are the
// approx.ftz instructions too, within about 2^-22 relative (log2: absolute
// near 1).  In float64 IEEE's.

#pragma once

#include <cuda_runtime.h>
#include <float.h>

namespace radial {

constexpr double kLog2e = 1.4426950408889634;

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3, kRq = 4 };

// exp(c * x) for a constant c: in float32 one multiply (c log2(e) folded) and
// the hardware exp2, which flushes results below 2^-126 to 0.
__device__ __forceinline__ float exp_scaled(float x, float c) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * (c * float(kLog2e))));
  return y;
}
__device__ __forceinline__ double exp_scaled(double x, double c) { return exp(c * x); }
__device__ __forceinline__ float log_t(float v) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y * float(1.0 / kLog2e);
}
__device__ __forceinline__ double log_t(double v) { return log(v); }
__device__ __forceinline__ float sqrt_t(float v) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }
__device__ __forceinline__ float rcp_t(float v) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}
__device__ __forceinline__ double rcp_t(double v) { return 1.0 / v; }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// One 16-byte shared load into 16 / sizeof(T) values.
__device__ __forceinline__ void lds16(float (&dst)[4], const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}
__device__ __forceinline__ void lds16(double (&dst)[2], const double* src) {
  const double2 v = *reinterpret_cast<const double2*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
}

// _r_floor (gpr_fast.py:76-79): max(1e-40, the dtype's smallest normal).
template <typename T> struct Floor;
template <> struct Floor<float> { static __device__ __forceinline__ float value() { return FLT_MIN; } };
template <> struct Floor<double> { static __device__ __forceinline__ double value() { return 1e-40; } };

// The radial maps at var = 1; half_ia = 1 / (2 alpha).
template <typename T, int KIND>
__device__ __forceinline__ void maps(T r2, T alpha, T half_ia, T& G, T& E, T& F) {
  const T sqrt3 = T(1.7320508075688772);
  const T sqrt5 = T(2.23606797749979);
  F = T(0);
  if (KIND == kRbf) {
    G = exp_scaled(r2, T(-0.5));
    E = G;
  } else if (KIND == kRq) {
    const T u = fma_t(r2, half_ia, T(1));
    const T iu = rcp_t(u);
    const T lu = log_t(u);
    G = exp_scaled(lu, -alpha);
    E = G * iu;
    F = G * (T(0.5) * r2 * iu - alpha * lu);
  } else {
    const T r2_floor = Floor<T>::value();
    const T r = sqrt_t(r2 > r2_floor ? r2 : r2_floor);
    if (KIND == kMatern12) {
      G = exp_scaled(r, T(-1));
      E = r2 > r2_floor ? G * rcp_t(r) : T(0);
    } else if (KIND == kMatern32) {
      const T e = exp_scaled(r, -sqrt3);
      G = (T(1) + sqrt3 * r) * e;
      E = T(3) * e;
    } else {
      const T e = exp_scaled(r, -sqrt5);
      G = (T(1) + sqrt5 * r + T(5.0 / 3.0) * r2) * e;
      E = T(5.0 / 3.0) * (T(1) + sqrt5 * r) * e;
    }
  }
}

// G alone (the MVM needs no derivative maps; the compiler drops the rest).
template <typename T, int KIND>
__device__ __forceinline__ T gram(T r2, T alpha, T half_ia) {
  T G, E, F;
  maps<T, KIND>(r2, alpha, half_ia, G, E, F);
  return G;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace radial
