// Matrix-free product with the noisy radial Gram on Hopper (K3):
//
//   out = (var * G + noise * I) V,   G_ij = g(|xs_i - xs_j|^2)   (n x n, never stored)
//
// for V (n, k), the radial map g of one of the five kinds (radial_maps.cuh)
// on length-scale scaled inputs xs (n, d), and noise = sigma_n^2 + jitter.
//
// Replaces gptorch_tpu/ops/iterative.py:radial_mvm (iterative.py:92-127,
// with _gram_slab :73-89), which XLA fuses on the TPU into two GEMMs per row
// slab; there is no Pallas original.  It is the operator of every CG and
// Lanczos step of the matrix-free exact GP: about 130 launches per loss at
// n = 100000.
//
// What bounds it.  Operations: the function needs, per pair (i, j), 2d + 3
// flops for r2 by the norm identity (a d-long dot product, two adds and the
// doubling), about 2 for the map and 2k for the product: 39 at d = 8, k = 9,
// 3.9e11 at n = 100000, 5.8 ms at the card's 67 TFLOP/s in float32.  This
// kernel spends 3d on r2 (direct differences, below), 44 in all.  Bytes are
// negligible: xs and V are read once from device memory (3.6 MB at
// n = 100000, k = 9) and re-read from L2.
//
// Design.  Memory: nothing n^2 is stored; a Gram entry lives in one
// register for the k multiply-adds that use it.
//  * One thread owns one output row i (its xs row in registers); a block of
//    256 threads owns a strip of 256 rows and walks every column j of the
//    Gram in tiles of 256.  The grid's second dimension splits V's columns
//    into chunks of KC = 1, 8 or 16 (the smallest that holds k, else 16),
//    each chunk with its accumulators in registers.
//  * A tile's records (x_j padded to MAXD = 8, 16 or 32 coordinates, then
//    the chunk's V_j values, zero-padded) are copied into shared memory by
//    cp.async, one element per copy (rows of xs and V need not be 16-byte
//    aligned), into one of two buffers while the block computes on the
//    other: one __syncthreads per tile.  Every thread reads the same record
//    at a time, so each shared load is a 16-byte broadcast.  Records beyond
//    n are zeros: V_j = 0 adds nothing.
//  * r2 comes from direct differences, as in rbf_gram.cu and
//    radial_contract.cu: an exact 0 on the diagonal, which the matern kinds'
//    kink at r = 0 needs (iterative.py:82-87 zeroes it for the same reason).
//  * Each row's sums are its own thread's, in a fixed order (a tile's 256
//    terms in the working type, then tile by tile): no atomics, no
//    reduction across threads, and a result is the same from run to run.
//  * var, alpha (rq) and noise come from a 3-element device array, so a new
//    hyperparameter needs no host synchronisation and no rebuild.
//
// Plain C interface, loaded with ctypes.  The entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns the
// launch's CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "radial_maps.cuh"

namespace {

using namespace cp_async;
using namespace radial;

constexpr int kThreads = 256;  // rows per block, and columns per tile
constexpr int kMaxD = 32;

// Values a record reserves for KC chunk columns: a whole number of 16-byte loads.
template <typename T, int KC>
__host__ __device__ constexpr int padded_cols() {
  return (KC + 16 / int(sizeof(T)) - 1) / (16 / int(sizeof(T))) * (16 / int(sizeof(T)));
}

template <typename T, int KIND, int MAXD, int KC>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 1)
mvm_kernel(const T* __restrict__ xs, const T* __restrict__ v, const T* __restrict__ scal, T* __restrict__ out,
           int n, int d, int k) {
  constexpr int CPT = 16 / sizeof(T);
  constexpr int KCP = padded_cols<T, KC>();
  constexpr int S = MAXD + KCP;  // a record's values
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // two tiles of kThreads records

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const int c0 = blockIdx.y * KC;
  const int kc = min(KC, k - c0);
  const T alpha = scal[1];
  const T half_ia = T(0.5) / alpha;
  const int tiles = (n + kThreads - 1) / kThreads;

  // Thread tid copies record tid of a tile: x_j's MAXD coordinates and the
  // chunk's KCP values of V_j (zeros beyond d, kc and n).
  auto issue = [&](int t) {
    T* rec = buf + (t & 1) * (kThreads * S) + tid * S;
    const int j = t * kThreads + tid;
    const bool in = j < n;
    const T* xj = xs + int64_t(in ? j : 0) * d;
    const T* vj = v + int64_t(in ? j : 0) * k + c0;
#pragma unroll
    for (int q = 0; q < MAXD; ++q) {
      const bool ok = in && q < d;
      cp_async_elem<sizeof(T)>(rec + q, ok ? xj + q : xs, ok ? int(sizeof(T)) : 0);
    }
#pragma unroll
    for (int c = 0; c < KCP; ++c) {
      const bool ok = in && c < kc;
      cp_async_elem<sizeof(T)>(rec + MAXD + c, ok ? vj + c : v, ok ? int(sizeof(T)) : 0);
    }
    cp_async_commit();
  };

  issue(0);
  T xi[MAXD];
#pragma unroll
  for (int q = 0; q < MAXD; ++q) xi[q] = (i < n && q < d) ? xs[int64_t(i) * d + q] : T(0);
  T acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = T(0);

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every thread is done with tile t - 1's buffer
    if (t + 1 < tiles) issue(t + 1);
    const T* tile = buf + (t & 1) * (kThreads * S);
    const int jn = min(kThreads, n - t * kThreads);
    T tacc[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) tacc[c] = T(0);
#pragma unroll 2
    for (int jj = 0; jj < jn; ++jj) {
      const T* rec = tile + jj * S;
      T r2 = T(0);
#pragma unroll
      for (int q = 0; q < MAXD; q += CPT) {
        T xj[CPT];
        lds16(xj, rec + q);
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          const T df = xi[q + e] - xj[e];
          r2 = fma_t(df, df, r2);
        }
      }
      const T g = gram<T, KIND>(r2, alpha, half_ia);
#pragma unroll
      for (int c = 0; c < KCP; c += CPT) {
        T vj[CPT];
        lds16(vj, rec + MAXD + c);
#pragma unroll
        for (int e = 0; e < CPT; ++e)
          if (c + e < KC) tacc[c + e] = fma_t(g, vj[e], tacc[c + e]);
      }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] += tacc[c];
  }

  if (i < n) {
    const T var = scal[0], noise = scal[2];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c < kc) {
        const int64_t e = int64_t(i) * k + c0 + c;
        out[e] = fma_t(var, acc[c], noise * v[e]);
      }
    }
  }
}

template <typename T, int KIND, int MAXD, int KC>
cudaError_t launch_chunk(const T* xs, const T* v, const T* scal, T* out, int n, int d, int k, cudaStream_t s) {
  auto kernel = mvm_kernel<T, KIND, MAXD, KC>;
  const size_t smem = size_t(2) * kThreads * (MAXD + padded_cols<T, KC>()) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kThreads - 1) / kThreads, (k + KC - 1) / KC);
  kernel<<<grid, kThreads, smem, s>>>(xs, v, scal, out, n, d, k);
  return cudaGetLastError();
}

template <typename T, int KIND, int MAXD>
cudaError_t launch_width(const T* xs, const T* v, const T* scal, T* out, int n, int d, int k, cudaStream_t s) {
  if (k == 1) return launch_chunk<T, KIND, MAXD, 1>(xs, v, scal, out, n, d, k, s);
  if (k <= 8) return launch_chunk<T, KIND, MAXD, 8>(xs, v, scal, out, n, d, k, s);
  return launch_chunk<T, KIND, MAXD, 16>(xs, v, scal, out, n, d, k, s);
}

template <typename T, int KIND>
cudaError_t launch_kind(const T* xs, const T* v, const T* scal, T* out, int n, int d, int k, cudaStream_t s) {
  if (d <= 8) return launch_width<T, KIND, 8>(xs, v, scal, out, n, d, k, s);
  if (d <= 16) return launch_width<T, KIND, 16>(xs, v, scal, out, n, d, k, s);
  return launch_width<T, KIND, 32>(xs, v, scal, out, n, d, k, s);
}

template <typename T>
int launch(const T* xs, const T* v, const T* scal, T* out, int n, int d, int k, int kind, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD || k <= 0 || kind < kRbf || kind > kRq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRbf: return static_cast<int>(launch_kind<T, kRbf>(xs, v, scal, out, n, d, k, s));
    case kMatern12: return static_cast<int>(launch_kind<T, kMatern12>(xs, v, scal, out, n, d, k, s));
    case kMatern32: return static_cast<int>(launch_kind<T, kMatern32>(xs, v, scal, out, n, d, k, s));
    case kMatern52: return static_cast<int>(launch_kind<T, kMatern52>(xs, v, scal, out, n, d, k, s));
    default: return static_cast<int>(launch_kind<T, kRq>(xs, v, scal, out, n, d, k, s));
  }
}

}  // namespace

extern "C" {

// xs (n, d), v (n, k), scal = [var, alpha, noise] on the device, all
// row-major and contiguous; writes out (n, k).
int radial_mvm_f32(const float* xs, const float* v, const float* scal, float* out, int n, int d, int k, int kind,
                   void* stream) {
  return launch<float>(xs, v, scal, out, n, d, k, kind, stream);
}

int radial_mvm_f64(const double* xs, const double* v, const double* scal, double* out, int n, int d, int k,
                   int kind, void* stream) {
  return launch<double>(xs, v, scal, out, n, d, k, kind, stream);
}

int radial_mvm_max_d() { return kMaxD; }

const char* radial_mvm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
