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
// n = 100000, 384 per LOVE posterior of rank 256.
//
// What bounds it.  Operations: the function needs, per pair (i, j), 2d + 3
// flops for r2 by the norm identity, 2 for the map and 2k for the product:
// 5.8 ms at n = 100000, d = 8, k = 9 on an H100 at 67 TFLOP/s in float32.
// The card runs out of instruction issue first (128 a clock per SM): this
// kernel issues, per pair, d fused multiply-adds and one add for the
// exponent, a clamp, ex2, KC = k rounded up to a multiple of 4 fused
// multiply-adds (1 for k = 1), and a 16-byte shared load per TM pairs for
// every 4 values of a record (1.5 a pair at k = 9): about 24.5 issue slots
// a pair at d = 8, k = 9, 12.8 at k = 1, 7.3 and 3.8 ms at full issue.
// The exps alone need 1e10 / (16 a clock x 132 SMs x 1.98 GHz) = 2.4 ms on
// the MUFU pipe.  Bytes are negligible: the records (3.6 MB at n = 100000,
// k = 9) are read once from device memory and re-read from L2.
//
// Records.  The wrapper (ops/mvm.py: _mvm_records, _pack_records) writes,
// in one torch pass, one aligned record per point j and pass of V's
// columns: [y_j (MAXD, zero beyond d) | beta_j | V_j's KC columns of the
// pass (zero beyond k) | zeros to a 16-byte multiple].  With xc the inputs
// less their column means, s = sqrt(log2(e) / 2) and sign = -1 for rbf,
// x' = s xc, beta = -|x'|^2, y = 2 x'; for the other kinds x' = xc,
// beta = |x'|^2, y = -2 x'.  Then
//
//   t_ij = beta_i + beta_j + x'_i . y_j = c |xs_i - xs_j|^2,
//
// c = -log2(e) / 2 for rbf (g = ex2(min(t, 0)): the reference's clamp of r2
// at 0, the constant folded) and c = 1 otherwise (g = map(max(t, 0))).  The
// row side x'_i = y_i / (-2 sign) is exact, so t_ij and t_ji are the same
// bits: the operator is symmetric in floating point, as CG assumes.
//
// Precision.  This is the reference's formula (iterative.py:76-80), and
// like it the float32 result loses digits where the inputs spread far wider
// than the distances that matter: t's rounding error is about
// u (|x'_i|^2 + |x'_j|^2), u = 2^-24.  Centring makes that the data's
// spread and not its offset (r2 does not change under a translation): at
// d = 8 and unit-variance inputs about 1e-6 of a Gram entry; inputs offset
// by 40 without centring would lose 2e-3.  The diagonal's r2 is exactly 0,
// as the reference sets it (iterative.py:82-87): only a warp whose rows
// cross a tile's columns takes the (uniform) branch that compares i with j.
//
// Design.  Memory: nothing n^2 is stored; a Gram entry lives in a register
// for the KC multiply-adds that use it.
//  * A block of 128 threads (four warps) owns a strip of ROWS = 256 rows
//    (128 where a thread holds one row) and walks a range of the Gram's
//    columns in tiles of TILE = 256 records (128 where two buffers of 256
//    would pass 112 KB).  Each thread owns TM rows (4 in float32, 2 in
//    float64, fewer where TM (MAXD + KC) would pass 160 registers): their
//    x' and beta stay in registers with TM x KC accumulators, so one record
//    read from shared memory serves TM pairs.  Where TM = 4, two warps
//    share a strip's rows and take half of each tile's columns each; their
//    sums are added in shared memory in a fixed order at the end.  Every
//    lane of a warp reads the same record at a time: each shared load is a
//    16-byte broadcast.
//  * Any k <= 32 goes in one pass over the Gram: r2 and the map once per
//    pair.  Wider blocks go in passes of 32 columns, a launch each.
//  * Tiles arrive by 16-byte cp.async into a ring of two buffers while the
//    block computes on the other: one __syncthreads per tile.  Records
//    beyond n are zero-filled: V_j = 0 adds nothing.
//  * Filling the card.  The column range is split into `splits` ranges of
//    whole tiles, chosen at launch from the SM count and the occupancy the
//    runtime reports, to minimise waves x tiles per block (the last wave as
//    full as whole tiles allow).  At n = 100000, d = 8 in float32, 391
//    strips: at k = 9 (128 registers, four blocks an SM, 528 resident) 4
//    ranges of 98 tiles, 1564 blocks in 2.96 waves; at k = 1 (72
//    registers, seven blocks an SM) 7 ranges, 2737 blocks in 2.96 waves;
//    at k = 17 (168 registers, three) one range, 391 blocks in 0.99 of a
//    wave.  A range writes its partial sums to a workspace, and a second
//    kernel adds the ranges in order and applies var and noise.
//    (Registers and spills of every instance: chip_smoke.py prints
//    ptxas's report.)
//  * Each output's sum is a fixed sequence: a thread's running sum over
//    its columns of the range (as a GEMM accumulates), the two warps' sums,
//    then the ranges in order.  No atomics: a result is the same from run
//    to run.
//  * var, alpha (rq) and noise come from a 3-element device array, so a new
//    hyperparameter needs no host synchronisation and no rebuild.
//
// Plain C interface, loaded with ctypes.  radial_mvm_plan gives the record
// layout and the workspace size; the entry points launch on the given
// stream, do not synchronise, allocate nothing, and return the first CUDA
// error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "radial_maps.cuh"

namespace {

using namespace cp_async;
using namespace radial;

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 32;
constexpr int kMaxChunk = 32;  // V's columns in one pass
constexpr int kMaxSplits = 32;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Rows a thread owns: 4 in float32, 2 in float64, halved while its inputs
// and accumulators would pass 160 registers.
template <typename T>
__host__ __device__ constexpr int rows_per_thread(int maxd, int kc) {
  int tm = sizeof(T) == 4 ? 4 : 2;
  while (tm > 1 && tm * (maxd + kc) * int(sizeof(T) / 4) > 160) tm /= 2;
  return tm;
}

template <typename T, int MAXD, int KC>
struct Shape {
  static constexpr int CPT = 16 / int(sizeof(T));   // values per 16-byte copy
  static constexpr int S = MAXD + round_up(KC + 1, CPT);  // a record: y, then beta and the pass's columns
  static constexpr int TM = rows_per_thread<T>(MAXD, KC);
  static constexpr int CG = TM >= 2 ? TM / 2 : 1;  // warps sharing rows, splitting a tile's columns
  static constexpr int RG = kWarps / CG;
  static constexpr int ROWS = RG * 32 * TM;
  static constexpr int TILE = 2 * 256 * S * int(sizeof(T)) <= 112 * 1024 ? 256 : 128;
  static constexpr int COLS = TILE / CG;
  static constexpr int CHUNKS = TILE * S / CPT;  // 16-byte copies a tile
  static constexpr int SMEM = 2 * TILE * S * int(sizeof(T));
  // float32 instances whose rows and sums take at most 80 registers, k > 1
  static constexpr bool DENSE = sizeof(T) == 4 && KC > 1 && TM * (MAXD + KC) <= 80;
  static_assert(CHUNKS % kThreads == 0, "a tile's copies split evenly over the threads");
  static_assert(KC * ROWS <= 2 * TILE * S, "the warps' sums fit in the tile buffers");
};

__device__ __forceinline__ float exp2_t(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double exp2_t(double x) { return exp2(x); }
// min(x, 0) and max(x, 0), a NaN propagated (as the reference's clamp does).
__device__ __forceinline__ float min0(float x) {
  float y;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(0.0f));
  return y;
}
__device__ __forceinline__ double min0(double x) { return x > 0.0 ? 0.0 : x; }
__device__ __forceinline__ float max0(float x) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(0.0f));
  return y;
}
__device__ __forceinline__ double max0(double x) { return x < 0.0 ? 0.0 : x; }

// The Gram entry at var = 1 from t = c r2.
template <typename T, int KIND>
__device__ __forceinline__ T entry(T t, T alpha, T half_ia) {
  if constexpr (KIND == kRbf) {
    return exp2_t(min0(t));
  } else {
    return gram<T, KIND>(max0(t), alpha, half_ia);
  }
}

// One warp's pairs of a tile: COLS records at `tile` (columns j0, ...)
// against the thread's TM rows (row, row + 32, ...).
template <typename T, int KIND, int MAXD, int KC, bool DIAG>
__device__ __forceinline__ void tile_pairs(const T* __restrict__ tile, const T (&u)[Shape<T, MAXD, KC>::TM][MAXD],
                                           const T (&a)[Shape<T, MAXD, KC>::TM],
                                           T (&acc)[Shape<T, MAXD, KC>::TM][KC], int row, int j0, T alpha,
                                           T half_ia) {
  using Sh = Shape<T, MAXD, KC>;
  constexpr int TM = Sh::TM, CPT = Sh::CPT, S = Sh::S;
#pragma unroll 2
  for (int jj = 0; jj < Sh::COLS; ++jj) {
    const T* rec = tile + jj * S;
    T bv[CPT];  // beta_j, then the first columns of V_j
    lds16(bv, rec + MAXD);
    T t[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) t[m] = a[m] + bv[0];
#pragma unroll
    for (int q = 0; q < MAXD; q += CPT) {
      T y[CPT];
      lds16(y, rec + q);
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
#pragma unroll
        for (int m = 0; m < TM; ++m) t[m] = fma_t(u[m][q + e], y[e], t[m]);
      }
    }
    T g[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      if (DIAG && row + 32 * m == j0 + jj) t[m] = T(0);
      g[m] = entry<T, KIND>(t[m], alpha, half_ia);
    }
#pragma unroll
    for (int c = 0; c < S - MAXD; c += CPT) {
      T v[CPT];
      if (c == 0) {
#pragma unroll
        for (int e = 0; e < CPT; ++e) v[e] = bv[e];
      } else {
        lds16(v, rec + MAXD + c);
      }
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        const int col = c + e - 1;
        if (col >= 0 && col < KC) {
#pragma unroll
          for (int m = 0; m < TM; ++m) acc[m][col] = fma_t(g[m], v[e], acc[m][col]);
        }
      }
    }
  }
}

// Block (strip, range): the strip's rows against the range's columns, for
// the pass of V's columns [c0, c0 + kc) in the records.  With part, writes
// the range's sums to part[range][i][0..KC); else out's columns.
template <typename T, int KIND, int MAXD, int KC>
__device__ __forceinline__ void mvm_block(const T* __restrict__ rec, const T* __restrict__ scal,
                                          T* __restrict__ part, T* __restrict__ out, int n, int k, int c0, int kc,
                                          int tiles_per_split) {
  using Sh = Shape<T, MAXD, KC>;
  constexpr int TM = Sh::TM, S = Sh::S, TILE = Sh::TILE, CPT = Sh::CPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // two tiles of TILE records

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int rg = warp % Sh::RG;
  const int cg = warp / Sh::RG;
  const int rlo = blockIdx.x * Sh::ROWS + rg * 32 * TM;  // the warp's rows: rlo + 32 m + lane
  const int tiles = (n + TILE - 1) / TILE;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(tiles, t0 + tiles_per_split);
  const T alpha = scal[1];
  const T half_ia = T(0.5) / alpha;
  const int64_t rec_end = int64_t(n) * S;

  // A tile is TILE consecutive records: one contiguous run of the array.
  auto issue = [&](int t) {
    T* dst = buf + (t & 1) * (TILE * S);
    const int64_t base = int64_t(t) * TILE * S;
#pragma unroll
    for (int s = 0; s < Sh::CHUNKS / kThreads; ++s) {
      const int e = s * kThreads + tid;
      const int64_t off = base + int64_t(e) * CPT;
      const bool ok = off < rec_end;
      cp_async16(dst + e * CPT, rec + (ok ? off : 0), ok ? 16 : 0);
    }
    cp_async_commit();
  };

  if (t0 < t1) issue(t0);
  // The rows' x' = y / (-2 sign), exact, and beta.
  constexpr T kRowScale = KIND == kRbf ? T(0.5) : T(-0.5);
  T u[TM][MAXD], a[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = rlo + 32 * m + lane;
    const bool in = i < n;
    const T* r = rec + int64_t(in ? i : 0) * S;
#pragma unroll
    for (int q = 0; q < MAXD; ++q) u[m][q] = in ? r[q] * kRowScale : T(0);
    a[m] = in ? r[MAXD] : T(0);
  }
  T acc[TM][KC];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[m][c] = T(0);
  }

  for (int t = t0; t < t1; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1's buffer
    if (t + 1 < t1) issue(t + 1);
    const int j0 = t * TILE + cg * Sh::COLS;
    const T* tile = buf + (t & 1) * (TILE * S) + cg * Sh::COLS * S;
    if (j0 < rlo + 32 * TM && rlo < j0 + Sh::COLS) {
      tile_pairs<T, KIND, MAXD, KC, true>(tile, u, a, acc, rlo + lane, j0, alpha, half_ia);
    } else {
      tile_pairs<T, KIND, MAXD, KC, false>(tile, u, a, acc, rlo + lane, j0, alpha, half_ia);
    }
  }

  // The column groups' sums, added into group 0's in order.
  __syncthreads();  // every warp is done with the tile buffers; no copy is in flight
  T* red = buf;     // [KC][ROWS]
  const int rl = rg * 32 * TM + lane;
  for (int g = 1; g < Sh::CG; ++g) {
    if (cg == g) {
#pragma unroll
      for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int c = 0; c < KC; ++c) red[c * Sh::ROWS + rl + 32 * m] = acc[m][c];
      }
    }
    __syncthreads();
    if (cg == 0) {
#pragma unroll
      for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[m][c] += red[c * Sh::ROWS + rl + 32 * m];
      }
    }
    __syncthreads();
  }

  if (cg != 0) return;
  const T var = scal[0], noise = scal[2];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int i = rlo + 32 * m + lane;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (c >= kc) continue;
      if (part != nullptr) {
        part[(int64_t(blockIdx.y) * n + i) * KC + c] = acc[m][c];
      } else {
        out[int64_t(i) * k + c0 + c] = fma_t(var, acc[m][c], noise * rec[int64_t(i) * S + MAXD + 1 + c]);
      }
    }
  }
}

// The kernel, and the same with at most 128 registers a thread (four blocks
// an SM) for the narrow instances whose rows and sums fit there
// (Shape::DENSE): unbidden, ptxas takes 148 at d = 8, k = 9, which leaves
// three blocks an SM and less latency hidden.
template <typename T, int KIND, int MAXD, int KC>
__global__ void __launch_bounds__(kThreads)
mvm_kernel(const T* __restrict__ rec, const T* __restrict__ scal, T* __restrict__ part, T* __restrict__ out, int n,
           int k, int c0, int kc, int tiles_per_split) {
  mvm_block<T, KIND, MAXD, KC>(rec, scal, part, out, n, k, c0, kc, tiles_per_split);
}
template <typename T, int KIND, int MAXD, int KC>
__global__ void __launch_bounds__(kThreads, 4)
mvm_kernel_dense(const T* __restrict__ rec, const T* __restrict__ scal, T* __restrict__ part, T* __restrict__ out,
                 int n, int k, int c0, int kc, int tiles_per_split) {
  mvm_block<T, KIND, MAXD, KC>(rec, scal, part, out, n, k, c0, kc, tiles_per_split);
}

// out's columns [c0, c0 + kc) from the ranges' partial sums, added in order.
template <typename T>
__global__ void finish_kernel(const T* __restrict__ part, const T* __restrict__ rec, const T* __restrict__ scal,
                              T* __restrict__ out, int n, int k, int c0, int kc, int KC, int S, int MAXD,
                              int splits) {
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= int64_t(n) * kc) return;
  const int i = int(e / kc), c = int(e % kc);
  T s = part[int64_t(i) * KC + c];
  for (int p = 1; p < splits; ++p) s += part[(int64_t(p) * n + i) * KC + c];
  out[int64_t(i) * k + c0 + c] = fma_t(scal[0], s, scal[2] * rec[int64_t(i) * S + MAXD + 1 + c]);
}

struct Plan {
  int maxd, kc, width, passes, strips, splits, tiles_per_split;
  int64_t work_bytes;
};

int max_d_for(int d) { return d <= 8 ? 8 : (d <= 16 ? 16 : 32); }

// Columns of V a pass takes: k rounded up to a multiple of 4 (float32; 8,
// 16 or 32 in float64), or 1; wider blocks in passes of 32.
template <typename T>
int chunk_for(int k) {
  if (k == 1) return 1;
  if (k > kMaxChunk) return kMaxChunk;
  if (sizeof(T) == 4) return round_up(k, 4);
  return k <= 8 ? 8 : (k <= 16 ? 16 : 32);
}

template <typename T, int KIND, int MAXD, int KC>
struct Instance {
  using Sh = Shape<T, MAXD, KC>;

  static constexpr auto kernel() {
    if constexpr (Sh::DENSE) {
      return mvm_kernel_dense<T, KIND, MAXD, KC>;
    } else {
      return mvm_kernel<T, KIND, MAXD, KC>;
    }
  }

  static cudaError_t plan(int n, int k, Plan& p) {
    auto kernel = Instance::kernel();
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, Sh::SMEM);
    if (err != cudaSuccess) return err;
    p.maxd = MAXD;
    p.kc = KC;
    p.width = Sh::S;
    p.passes = (k + KC - 1) / KC;
    p.strips = (n + Sh::ROWS - 1) / Sh::ROWS;
    const int tiles = (n + Sh::TILE - 1) / Sh::TILE;
    const int64_t resident = sms * per_sm > 0 ? int64_t(sms) * per_sm : 1;
    int64_t best = -1;
    for (int s = 1; s <= (tiles < kMaxSplits ? tiles : kMaxSplits); ++s) {
      const int per = (tiles + s - 1) / s;
      const int splits = (tiles + per - 1) / per;
      const int64_t cost = (int64_t(p.strips) * splits + resident - 1) / resident * per;  // waves x tiles
      if (best < 0 || cost < best) {
        best = cost;
        p.splits = splits;
        p.tiles_per_split = per;
      }
    }
    p.work_bytes = p.splits > 1 ? int64_t(p.splits) * n * KC * int64_t(sizeof(T)) : 0;
    return cudaSuccess;
  }

  static cudaError_t launch(const T* rec, const T* scal, T* work, T* out, int n, int k, const Plan& p,
                            cudaStream_t s) {
    const auto kern = kernel();
    for (int pass = 0; pass < p.passes; ++pass) {
      const int c0 = pass * KC;
      const int kc = k - c0 < KC ? k - c0 : KC;
      const T* r = rec + int64_t(pass) * n * Sh::S;
      kern<<<dim3(p.strips, p.splits), kThreads, Sh::SMEM, s>>>(
          r, scal, p.splits > 1 ? work : nullptr, out, n, k, c0, kc, p.tiles_per_split);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      if (p.splits > 1) {
        const int64_t total = int64_t(n) * kc;
        finish_kernel<T><<<unsigned((total + 255) / 256), 256, 0, s>>>(work, r, scal, out, n, k, c0, kc, KC, Sh::S,
                                                                       MAXD, p.splits);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
    }
    return cudaSuccess;
  }
};

template <typename T, int KIND, int MAXD, typename F>
cudaError_t by_chunk(int kc, F& f) {
  if constexpr (sizeof(T) == 4) {
    switch (kc) {
      case 1: return f(Instance<T, KIND, MAXD, 1>());
      case 4: return f(Instance<T, KIND, MAXD, 4>());
      case 8: return f(Instance<T, KIND, MAXD, 8>());
      case 12: return f(Instance<T, KIND, MAXD, 12>());
      case 16: return f(Instance<T, KIND, MAXD, 16>());
      case 20: return f(Instance<T, KIND, MAXD, 20>());
      case 24: return f(Instance<T, KIND, MAXD, 24>());
      case 28: return f(Instance<T, KIND, MAXD, 28>());
      default: return f(Instance<T, KIND, MAXD, 32>());
    }
  } else {
    switch (kc) {
      case 1: return f(Instance<T, KIND, MAXD, 1>());
      case 8: return f(Instance<T, KIND, MAXD, 8>());
      case 16: return f(Instance<T, KIND, MAXD, 16>());
      default: return f(Instance<T, KIND, MAXD, 32>());
    }
  }
}

template <typename T, int KIND, typename F>
cudaError_t by_width(int maxd, int kc, F& f) {
  switch (maxd) {
    case 8: return by_chunk<T, KIND, 8>(kc, f);
    case 16: return by_chunk<T, KIND, 16>(kc, f);
    default: return by_chunk<T, KIND, 32>(kc, f);
  }
}

// Calls f(Instance<T, kind, MAXD, KC>()) for the instance that serves (d, k).
template <typename T, typename F>
cudaError_t dispatch(int kind, int d, int k, F&& f) {
  const int maxd = max_d_for(d), kc = chunk_for<T>(k);
  switch (kind) {
    case kRbf: return by_width<T, kRbf>(maxd, kc, f);
    case kMatern12: return by_width<T, kMatern12>(maxd, kc, f);
    case kMatern32: return by_width<T, kMatern32>(maxd, kc, f);
    case kMatern52: return by_width<T, kMatern52>(maxd, kc, f);
    default: return by_width<T, kRq>(maxd, kc, f);
  }
}

template <typename T>
cudaError_t plan_of(int n, int d, int k, int kind, Plan& p) {
  if (n <= 0 || d <= 0 || d > kMaxD || k <= 0 || kind < kRbf || kind > kRq) return cudaErrorInvalidValue;
  return dispatch<T>(kind, d, k, [&](auto inst) { return decltype(inst)::plan(n, k, p); });
}

template <typename T>
int launch(const T* rec, const T* scal, void* work, T* out, int n, int d, int k, int kind, void* stream) {
  Plan p;
  cudaError_t err = plan_of<T>(n, d, k, kind, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (reinterpret_cast<uintptr_t>(rec) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (p.splits > 1 && work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* w = static_cast<T*>(work);
  return static_cast<int>(
      dispatch<T>(kind, d, k, [&](auto inst) { return decltype(inst)::launch(rec, scal, w, out, n, k, p, s); }));
}

}  // namespace

extern "C" {

// The layout for (n, d, k, kind) in the working type of `itemsize` bytes on
// the current device: plan = [MAXD, KC, record width, workspace bytes].
// The records are (ceil(k / KC), n, width), row-major, 16-byte aligned:
// pass p's record j is [y_j (MAXD) | beta_j | V_j's columns pKC ..
// pKC + KC - 1 | zeros].
int radial_mvm_plan(int itemsize, int n, int d, int k, int kind, int64_t* plan) {
  Plan p;
  cudaError_t err = itemsize == 4   ? plan_of<float>(n, d, k, kind, p)
                    : itemsize == 8 ? plan_of<double>(n, d, k, kind, p)
                                    : cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = p.maxd;
  plan[1] = p.kc;
  plan[2] = p.width;
  plan[3] = p.work_bytes;
  return 0;
}

// rec: the records above; scal = [var, alpha, noise] on the device; work:
// the plan's workspace bytes of scratch; writes out (n, k), row-major.
int radial_mvm_f32(const float* rec, const float* scal, void* work, float* out, int n, int d, int k, int kind,
                   void* stream) {
  return launch<float>(rec, scal, work, out, n, d, k, kind, stream);
}

int radial_mvm_f64(const double* rec, const double* scal, void* work, double* out, int n, int d, int k, int kind,
                   void* stream) {
  return launch<double>(rec, scal, work, out, n, d, k, kind, stream);
}

int radial_mvm_max_d() { return kMaxD; }

const char* radial_mvm_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
