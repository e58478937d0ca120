// Radial (RBF) Gram matrices on Hopper, B of them in one launch:
//
//   out[b, i, j] = var[b] * exp(-0.5 * max(sum_q (x1[b, i, q] - x2[b, j, q])^2, 0))
//                  (+ diag[b] where i == j, when sym != 0)
//
// for x1 (B, n1, d), x2 (B, n2, d), out (B, n1, n2), all contiguous; a
// single Gram is the case B = 1.
//
// Replaces the Pallas TPU kernel gptorch_tpu/ops/pallas_gram.py:_rbf_tile_kernel
// (called through rbf_gram there).  Same function, not the same blocking.
//
// What bounds it.  At d = 8 the kernel does about 3d + 3 = 27 flops for every
// output element it writes, far below the card's float32 rate per byte, so
// the n1 * n2 write is the bound: for n = 32768 in float32 that is 4.29 GB,
// about 1.28 ms at 3.35 TB/s; for a fleet of 256 Grams of 512^2 it is
// 268 MB, about 0.080 ms.  The design therefore writes every output once,
// coalesced, and reads the inputs only from shared memory inside the loop.
// One launch covers the whole batch: a fleet's 256 small Grams would
// otherwise be 256 launches of 64 blocks each, too few to fill 132 SMs.
//
// Design.
//  * One block of 256 threads computes one 64 x 64 output tile.  Thread
//    (ty, tx) = (tid / 64, tid % 64) owns column tx and rows ty, ty + 4, ...,
//    ty + 60 of the tile, so each warp writes 32 neighbouring elements of
//    one row: full 128-byte segments in float32.
//  * The tile's rows of x1 and x2 are staged in shared memory in chunks of 8
//    coordinates.  x2 is stored transposed (one coordinate per row) so the
//    threads of a warp read neighbouring words; x1 is read as a broadcast
//    (all threads of a warp share one row).  Out-of-range rows and
//    coordinates are staged as 0 and contribute nothing.
//  * r^2 is summed from direct differences, not from |a|^2 + |b|^2 - 2 a.b:
//    no cancellation, and an exact 0 on the diagonal of a symmetric Gram
//    (the matmul identity leaves +-eps there).  The clamp at 0 stays anyway.
//  * var[b] and diag[b] come from a (B, 2) device array, so changing them
//    needs no host synchronisation and no rebuild.
//  * The member b is blockIdx.z; a grid holds at most 65535 in z, so a
//    larger batch repeats the row tiles along y (b = blockIdx.z + gridDim.z *
//    (blockIdx.y / row tiles)).  Each block offsets its three pointers to
//    its member once, 64-bit (B * n1 * n2 passes 2^31 for a fleet of 256
//    Grams of 4096^2), and then runs the single Gram's tile unchanged.  One
//    Gram launches an instance without that indexing (kBatched false), the
//    single-Gram kernel as it was: a version that indexed every launch ran
//    the flagship Gram markedly slower (PERF.md §6).
//  * Ragged n1, n2 are masked at the store; no divisibility is required.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kThreads = 256;
constexpr int kRowStride = kThreads / kTileN;             // 4
constexpr int kRowsPerThread = kTileM / kRowStride;       // 16
constexpr int kChunk = 8;                                 // coordinates per stage
constexpr int kMaxGrid = 65535;                           // grid y and z

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kThreads)
rbf_gram_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                const T* __restrict__ scal, T* __restrict__ out,
                int batch, int n1, int n2, int d, int sym, int row_tiles) {
  __shared__ T s1[kTileM][kChunk];        // x1 rows of the tile
  __shared__ T s2[kChunk][kTileN + 1];    // x2 rows of the tile, transposed

  // The member: blockIdx.z, plus gridDim.z for each time the row tiles
  // repeat along y (a batch past the grid's 65535 in z).  One Gram
  // (kBatched false) compiles to the single-Gram kernel, member 0.
  int b = 0;
  int tile_y = blockIdx.y;
  if (kBatched) {
    b = blockIdx.z + gridDim.z * (blockIdx.y / row_tiles);
    if (b >= batch) return;  // the same for the whole block
    tile_y = blockIdx.y % row_tiles;
    x1 += (int64_t)b * n1 * d;
    x2 += (int64_t)b * n2 * d;
    out += (int64_t)b * n1 * n2;
  }

  const int tid = threadIdx.x;
  const int tx = tid % kTileN;
  const int ty = tid / kTileN;
  const int row0 = tile_y * kTileM;
  const int col0 = blockIdx.x * kTileN;

  T acc[kRowsPerThread];
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) acc[a] = T(0);

  for (int q0 = 0; q0 < d; q0 += kChunk) {
    for (int e = tid; e < kTileM * kChunk; e += kThreads) {
      const int r = e / kChunk;
      const int q = e % kChunk;
      const int gq = q0 + q;
      const int gr = row0 + r;
      const int gc = col0 + r;
      s1[r][q] = (gr < n1 && gq < d) ? x1[(int64_t)gr * d + gq] : T(0);
      s2[q][r] = (gc < n2 && gq < d) ? x2[(int64_t)gc * d + gq] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const T bq = s2[q][tx];
#pragma unroll
      for (int a = 0; a < kRowsPerThread; ++a) {
        const T diff = s1[ty + a * kRowStride][q] - bq;
        acc[a] = fma_t(diff, diff, acc[a]);
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= n2) return;
  const T var = scal[2 * (int64_t)b];
  const T dg = scal[2 * (int64_t)b + 1];
#pragma unroll
  for (int a = 0; a < kRowsPerThread; ++a) {
    const int row = row0 + ty + a * kRowStride;
    if (row < n1) {
      const T r2 = acc[a] < T(0) ? T(0) : acc[a];  // keeps a NaN a NaN
      T v = var * exp_t(T(-0.5) * r2);
      if (sym && row == col) v += dg;
      out[(int64_t)row * n2 + col] = v;
    }
  }
}

template <typename T>
int launch(const T* x1, const T* x2, const T* scal, T* out, int batch, int n1,
           int n2, int d, int sym, void* stream) {
  const int row_tiles = (n1 + kTileM - 1) / kTileM;
  const int z = batch < kMaxGrid ? batch : kMaxGrid;
  const int64_t y = (int64_t)row_tiles * ((batch + z - 1) / z);
  if (y > kMaxGrid) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((n2 + kTileN - 1) / kTileN, static_cast<unsigned>(y), z);
  auto kernel = batch == 1 ? rbf_gram_kernel<T, false> : rbf_gram_kernel<T, true>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, scal, out, batch, n1, n2, d, sym, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rbf_gram_f32(const float* x1, const float* x2, const float* scal,
                 float* out, int batch, int n1, int n2, int d, int sym,
                 void* stream) {
  return launch<float>(x1, x2, scal, out, batch, n1, n2, d, sym, stream);
}

int rbf_gram_f64(const double* x1, const double* x2, const double* scal,
                 double* out, int batch, int n1, int n2, int d, int sym,
                 void* stream) {
  return launch<double>(x1, x2, scal, out, batch, n1, n2, d, sym, stream);
}

const char* rbf_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows of x1 one launch can cover for one Gram (gridDim.y is at most 65535;
// a batch past 65535 Grams takes row tiles times ceil(B / 65535) of it, and
// a launch past that returns cudaErrorInvalidConfiguration).
int rbf_gram_max_rows() { return 65535 * kTileM; }

}  // extern "C"
