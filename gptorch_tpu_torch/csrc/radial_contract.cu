// Backward contraction of the fused exact-GP NLML (radial kernels) on Hopper:
//
//   W      = dy * Kinv - A A^T                (n x n, never stored)
//   svar   = sum_ij W_ij G_ij                 (for d/d log var)
//   rowsum = (W o E) 1                        (n,)
//   MX     = (W o E) xs                       (n, d)
//   sextra = sum_ij W_ij F_ij                 (rq only: d/d log alpha)
//
// with G, E, F the radial maps of r2_ij = |xs_i - xs_j|^2 on length-scale
// scaled inputs xs (gptorch_tpu/ops/gpr_fast.py:82-136): G the noiseless
// Gram, E = -2 dk/dr2, F = dk/d log alpha.
//
// Replaces gptorch_tpu/ops/gpr_fast.py:_contractions (gpr_fast.py:300-367),
// which XLA fuses on the TPU; there is no Pallas original.  Eager PyTorch
// would make about seven passes over n^2 data (r2, G, E, W, W*G, W*E, the
// product with [1 | xs]); this kernel reads Kinv once and writes nothing
// n^2-sized.
//
// What bounds it.  The read of Kinv: n^2 elements, 4.29 GB in float32 at
// n = 32768, 1.28 ms at 3.35 TB/s.  The arithmetic is about 40-60
// operations per element (d differences and fused multiply-adds for r2, the
// radial map, d fused multiply-adds for MX), 0.7-0.9 ms at 67 TFLOP/s, so
// the kernel is bytes-bound at d = 8, with little room: the design keeps
// the inner loop free of shared-memory traffic that scales with rows.
//
// Design.
//  * Each block of 256 threads (8 warps) owns a strip of 8 * ROWS rows and
//    loops over all n columns in tiles of 64.  Warp w owns ROWS rows; its
//    lanes take neighbouring columns, so every Kinv read is a coalesced
//    128-byte (f32) row segment.  The next tile's Kinv values are loaded
//    into registers while the current tile is computed.
//  * xs rows of the strip live in registers; the tile's xs and A columns are
//    staged in shared memory, transposed, and each lane loads its column's
//    xs once for all of its ROWS rows.  Coordinates beyond d, rows and
//    columns beyond n are zeros: they contribute W = 0 and need no branch.
//  * r2 comes from direct differences, as in rbf_gram.cu: an exact 0 on the
//    diagonal, which matern12's E mask (r2 > floor) relies on.
//  * W is formed on the fly from the streamed Kinv value and A.
//  * rowsum and MX accumulate in registers per lane and are reduced across
//    the warp once, at the end: each row is owned by one warp, so there is
//    no cross-block reduction.
//  * svar and sextra are summed per tile in the working type, then in
//    double per lane, per block (fixed order), and over blocks by a second
//    one-block kernel in a fixed order.  No float atomics: a gradient is the
//    same from run to run.
//
// Plain C interface, loaded with ctypes.  The entry point launches both
// kernels on the given stream, does not synchronise, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 64;
constexpr int kColsPerLane = kTileCols / 32;
constexpr int kMaxDy = 32;
constexpr int kMaxD = 32;
constexpr int kFinishThreads = 256;

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3, kRq = 4 };

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float log_t(float v) { return logf(v); }
__device__ __forceinline__ double log_t(double v) { return log(v); }
__device__ __forceinline__ float sqrt_t(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// _r_floor (gpr_fast.py:76-79): max(1e-40, the dtype's smallest normal).
template <typename T> struct Floor;
template <> struct Floor<float> { static __device__ __forceinline__ float value() { return FLT_MIN; } };
template <> struct Floor<double> { static __device__ __forceinline__ double value() { return 1e-40; } };

// The radial maps of gpr_fast.py:82-136.
template <typename T, int KIND>
__device__ __forceinline__ void radial(T r2, T var, T alpha, T& G, T& E, T& F) {
  const T sqrt3 = T(1.7320508075688772);
  const T sqrt5 = T(2.23606797749979);
  F = T(0);
  if (KIND == kRbf) {
    G = var * exp_t(T(-0.5) * r2);
    E = G;
  } else if (KIND == kRq) {
    const T u = T(1) + r2 / (T(2) * alpha);
    const T lu = log_t(u);
    G = var * exp_t(-alpha * lu);
    E = G / u;
    F = G * (r2 / (T(2) * u) - alpha * lu);
  } else {
    const T r2_floor = Floor<T>::value();
    const T r = sqrt_t(r2 > r2_floor ? r2 : r2_floor);
    if (KIND == kMatern12) {
      G = var * exp_t(-r);
      E = r2 > r2_floor ? G / r : T(0);
    } else if (KIND == kMatern32) {
      const T e = exp_t(-sqrt3 * r);
      G = var * (T(1) + sqrt3 * r) * e;
      E = T(3) * var * e;
    } else {
      const T e = exp_t(-sqrt5 * r);
      G = var * (T(1) + sqrt5 * r + T(5.0 / 3.0) * r2) * e;
      E = T(5.0 / 3.0) * var * (T(1) + sqrt5 * r) * e;
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The Kinv values of one column tile for a warp's ROWS rows: lane l takes
// columns j0 + l and j0 + 32 + l; out of range is 0.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(T (&dst)[ROWS][kColsPerLane], const T* __restrict__ kinv,
                                          int row, int lane, int j0, int n) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int col = j0 + c * 32 + lane;
      dst[r][c] = (row + r < n && col < n) ? __ldg(kinv + (int64_t)(row + r) * n + col) : T(0);
    }
  }
}

template <int MAXD> struct RowsPerWarp { static constexpr int value = MAXD <= 8 ? 4 : (MAXD <= 16 ? 2 : 1); };

template <typename T, int KIND, int MAXD>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
contract_kernel(const T* __restrict__ kinv, const T* __restrict__ a,
                const T* __restrict__ xs, const T* __restrict__ scal,
                T* __restrict__ rowsum, T* __restrict__ mx,
                double* __restrict__ part, int n, int d, int dy) {
  constexpr int ROWS = RowsPerWarp<MAXD>::value;
  constexpr int kStrip = kWarps * ROWS;
  __shared__ T sx[MAXD][kTileCols + 1];      // tile's xs columns, transposed
  __shared__ T sa[kMaxDy][kTileCols + 1];    // tile's A columns, transposed
  __shared__ T sai[kStrip][kMaxDy + 1];      // the strip's A rows
  __shared__ double sred[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * kStrip;
  const int wr = warp * ROWS;               // the warp's first row in the strip
  const T var = scal[0];
  const T alpha = scal[1];
  const T dyf = T(dy);

  for (int e = tid; e < kStrip * kMaxDy; e += kThreads) {
    const int r = e / kMaxDy, k = e % kMaxDy;
    const int row = row0 + r;
    sai[r][k] = (row < n && k < dy) ? a[(int64_t)row * dy + k] : T(0);
  }

  T xi[ROWS][MAXD];
  T acc_row[ROWS];
  T acc_mx[ROWS][MAXD];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + wr + r;
    acc_row[r] = T(0);
#pragma unroll
    for (int q = 0; q < MAXD; ++q) {
      xi[r][q] = (row < n && q < d) ? xs[(int64_t)row * d + q] : T(0);
      acc_mx[r][q] = T(0);
    }
  }

  T kv[ROWS][kColsPerLane], kn[ROWS][kColsPerLane];
  load_tile<T, ROWS>(kv, kinv, row0 + wr, lane, 0, n);

  double svar = 0.0, sextra = 0.0;
  for (int j0 = 0; j0 < n; j0 += kTileCols) {
    load_tile<T, ROWS>(kn, kinv, row0 + wr, lane, j0 + kTileCols, n);
    __syncthreads();  // the previous tile's shared reads are done
    for (int e = tid; e < kTileCols * MAXD; e += kThreads) {
      const int c = e / MAXD, q = e % MAXD;
      const int col = j0 + c;
      sx[q][c] = (col < n && q < d) ? xs[(int64_t)col * d + q] : T(0);
    }
    for (int e = tid; e < kTileCols * dy; e += kThreads) {
      const int c = e / dy, k = e % dy;
      const int col = j0 + c;
      sa[k][c] = col < n ? a[(int64_t)col * dy + k] : T(0);
    }
    __syncthreads();

    T ts = T(0), te = T(0);
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int cl = c * 32 + lane;
      T xj[MAXD];
#pragma unroll
      for (int q = 0; q < MAXD; ++q) xj[q] = sx[q][cl];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        T r2 = T(0);
#pragma unroll
        for (int q = 0; q < MAXD; ++q) {
          const T df = xi[r][q] - xj[q];
          r2 = fma_t(df, df, r2);
        }
        T w = dyf * kv[r][c];
        for (int k = 0; k < dy; ++k) w = fma_t(-sai[wr + r][k], sa[k][cl], w);
        T G, E, F;
        radial<T, KIND>(r2, var, alpha, G, E, F);
        ts = fma_t(w, G, ts);
        if (KIND == kRq) te = fma_t(w, F, te);
        const T m = w * E;
        acc_row[r] += m;
#pragma unroll
        for (int q = 0; q < MAXD; ++q) acc_mx[r][q] = fma_t(m, xj[q], acc_mx[r][q]);
      }
    }
    svar += static_cast<double>(ts);
    sextra += static_cast<double>(te);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) kv[r][c] = kn[r][c];
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + wr + r;
    const T rs = warp_sum(acc_row[r]);
    if (lane == 0 && row < n) rowsum[row] = rs;
#pragma unroll
    for (int q = 0; q < MAXD; ++q) {
      const T v = warp_sum(acc_mx[r][q]);
      if (lane == 0 && row < n && q < d) mx[(int64_t)row * d + q] = v;
    }
  }
  svar = warp_sum(svar);
  sextra = warp_sum(sextra);
  if (lane == 0) {
    sred[0][warp] = svar;
    sred[1][warp] = sextra;
  }
  __syncthreads();
  if (tid == 0) {
    double s = 0.0, x = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      s += sred[0][w];
      x += sred[1][w];
    }
    part[2 * blockIdx.x] = s;
    part[2 * blockIdx.x + 1] = x;
  }
}

// Second pass: the per-block partials of svar and sextra, summed in a fixed
// order by one block, written as out[0], out[1].
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ part, int nparts, T* __restrict__ out) {
  __shared__ double s[2][kFinishThreads];
  const int t = threadIdx.x;
  double a = 0.0, b = 0.0;
  for (int i = t; i < nparts; i += kFinishThreads) {
    a += part[2 * i];
    b += part[2 * i + 1];
  }
  s[0][t] = a;
  s[1][t] = b;
  __syncthreads();
  for (int stride = kFinishThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) {
      s[0][t] += s[0][t + stride];
      s[1][t] += s[1][t + stride];
    }
    __syncthreads();
  }
  if (t == 0) {
    out[0] = static_cast<T>(s[0][0]);
    out[1] = static_cast<T>(s[1][0]);
  }
}

int max_d_for(int d) { return d <= 8 ? 8 : (d <= 16 ? 16 : 32); }

int num_blocks(int n, int d) {
  const int m = max_d_for(d);
  const int strip = kWarps * (m <= 8 ? 4 : (m <= 16 ? 2 : 1));
  return (n + strip - 1) / strip;
}

template <typename T, int KIND, int MAXD>
void launch_kind(const T* kinv, const T* a, const T* xs, const T* scal, T* rowsum,
                 T* mx, double* part, int n, int d, int dy, cudaStream_t stream) {
  contract_kernel<T, KIND, MAXD><<<num_blocks(n, d), kThreads, 0, stream>>>(
      kinv, a, xs, scal, rowsum, mx, part, n, d, dy);
}

template <typename T, int MAXD>
void launch_width(const T* kinv, const T* a, const T* xs, const T* scal, T* rowsum,
                  T* mx, double* part, int n, int d, int dy, int kind, cudaStream_t s) {
  switch (kind) {
    case kRbf: launch_kind<T, kRbf, MAXD>(kinv, a, xs, scal, rowsum, mx, part, n, d, dy, s); break;
    case kMatern12: launch_kind<T, kMatern12, MAXD>(kinv, a, xs, scal, rowsum, mx, part, n, d, dy, s); break;
    case kMatern32: launch_kind<T, kMatern32, MAXD>(kinv, a, xs, scal, rowsum, mx, part, n, d, dy, s); break;
    case kMatern52: launch_kind<T, kMatern52, MAXD>(kinv, a, xs, scal, rowsum, mx, part, n, d, dy, s); break;
    default: launch_kind<T, kRq, MAXD>(kinv, a, xs, scal, rowsum, mx, part, n, d, dy, s); break;
  }
}

template <typename T>
int launch(const T* kinv, const T* a, const T* xs, const T* scal, T* rowsum, T* mx,
           double* part, T* out, int n, int d, int dy, int kind, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD || dy <= 0 || dy > kMaxDy || kind < 0 || kind > kRq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (max_d_for(d)) {
    case 8: launch_width<T, 8>(kinv, a, xs, scal, rowsum, mx, part, n, d, dy, kind, s); break;
    case 16: launch_width<T, 16>(kinv, a, xs, scal, rowsum, mx, part, n, d, dy, kind, s); break;
    default: launch_width<T, 32>(kinv, a, xs, scal, rowsum, mx, part, n, d, dy, kind, s); break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<T><<<1, kFinishThreads, 0, s>>>(part, num_blocks(n, d), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kinv (n, n), a (n, dy), xs (n, d), scal = [var, alpha] on the device;
// writes rowsum (n,), mx (n, d), out = [svar, sextra]; part is scratch of
// 2 * radial_contract_num_blocks(n, d) doubles.
int radial_contract_f32(const float* kinv, const float* a, const float* xs,
                        const float* scal, float* rowsum, float* mx, double* part,
                        float* out, int n, int d, int dy, int kind, void* stream) {
  return launch<float>(kinv, a, xs, scal, rowsum, mx, part, out, n, d, dy, kind, stream);
}

int radial_contract_f64(const double* kinv, const double* a, const double* xs,
                        const double* scal, double* rowsum, double* mx, double* part,
                        double* out, int n, int d, int dy, int kind, void* stream) {
  return launch<double>(kinv, a, xs, scal, rowsum, mx, part, out, n, d, dy, kind, stream);
}

int radial_contract_num_blocks(int n, int d) { return num_blocks(n, d); }

int radial_contract_max_d() { return kMaxD; }

int radial_contract_max_dy() { return kMaxDy; }

const char* radial_contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
