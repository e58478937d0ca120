// Backward contraction of the matrix-free exact-GP NLML on Hopper (K4): for
// a low-rank, possibly asymmetric W = Wl Wr^T (Wl, Wr: n x r; W never stored)
//
//   svar       = sum_ij W_ij G_ij                           (d/d log var)
//   grad_ell_q = sum_ij W_ij E_ij (xs_iq - xs_jq)^2          (d/d log ell_q)
//   sextra     = sum_ij W_ij F_ij                           (rq only: d/d log alpha)
//
// with G, E, F the radial maps of r2_ij = |xs_i - xs_j|^2 (radial_maps.cuh)
// on length-scale scaled inputs xs (n, d).
//
// Replaces gptorch_tpu/ops/iterative.py:_lowrank_contractions
// (iterative.py:454-517), which XLA fuses on the TPU into slab GEMMs; there
// is no Pallas original.  It runs once per backward of the iterative NLML
// (W = (dy/t) U V^T - A A^T, r = t + dy) and once per backward of the
// differentiable matrix-free product (W = g V^T).
//
// What bounds it.  Operations: the function needs, per pair (i, j), 2d + 3
// flops for r2 by the norm identity, 2r for W_ij, about 3 for the maps, 2
// for svar, 1 for W_ij E_ij and 2d + 2 for the length-scale sums by the JAX
// formula (M xs, one fused multiply-add per coordinate, and the row and
// column sums of M = W o E): about 61 at d = 8, r = 9, 6.1e11 at n = 100000,
// 9.1 ms at 67 TFLOP/s in float32.  This kernel spends 3d on r2 and 3d on
// the sums (direct differences, below), about 72 in all.  Bytes are
// negligible: xs, Wl and Wr are read once from device memory and re-read
// from L2.
//
// Design.  Memory: nothing n^2 is stored; W_ij, G, E, F live in registers for
// the pair that uses them.
//  * One thread owns one row i (its xs and Wl rows in registers); a block of
//    256 threads owns a strip of 256 rows and a range of the columns, walked
//    in tiles of 256.  The grid's second dimension splits the columns into
//    ranges so that a launch has enough blocks to fill the card evenly (the
//    outputs are sums over all pairs, so any split of the pairs adds up to
//    them).  A tile is 256 columns, or 128 where two buffers of 256 would
//    not fit in shared memory (float64 at d > 16 and r > 16).  r is handled in chunks of RW = 8, 16 or 32 columns of Wl and
//    Wr, a launch each, summed on the host side.
//  * A tile's records (x_j padded to MAXD coordinates, then Wr_j padded to
//    RW) are copied into shared memory by cp.async, one element per copy,
//    into one of two buffers while the block computes on the other: one
//    __syncthreads per tile; every shared load is a 16-byte broadcast.
//    Records beyond n are zeros: Wr_j = 0 gives W_ij = 0.
//  * The column sums of the JAX formula (iterative.py:509-516, which writes
//    grad_ell with the norm identity and needs colsum(W o E), a sum across
//    strips) are not needed: each pair's (xs_iq - xs_jq)^2 is formed from the
//    differences r2 is summed from, so every output is a plain sum over
//    pairs.  r2 from direct differences is also exactly 0 on the diagonal.
//  * Sums: a tile's terms in the working type per thread, then in double per
//    thread, across the block in a fixed order, per block into a workspace,
//    and over blocks by a one-block kernel in a fixed order.  No atomics: a
//    gradient is the same from run to run.
//
// Plain C interface, loaded with ctypes.  The entry point launches its two
// kernels on the given stream, does not synchronise, allocates nothing (the
// caller passes lowrank_contract_workspace_bytes of scratch), and returns
// the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "radial_maps.cuh"

namespace {

using namespace cp_async;
using namespace radial;

constexpr int kThreads = 256;  // rows per block (and columns per tile: tile_for)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 32;
constexpr int kTargetBlocks = 132 * 32;  // about 16 waves of two blocks per SM of an H100

int max_d_for(int d) { return d <= 8 ? 8 : (d <= 16 ? 16 : 32); }
int rank_for(int r) { return r <= 8 ? 8 : (r <= 16 ? 16 : 32); }

// Records per column tile: one per thread, or one per two threads where two
// buffers of kThreads records would not fit in shared memory (float64 with
// 32 coordinates and 32 columns of Wr: 256 KB).
__host__ __device__ constexpr int tile_for(int itemsize, int maxd, int rw) {
  return 2 * kThreads * (maxd + rw) * itemsize <= 200 * 1024 ? kThreads : kThreads / 2;
}

// The grid: row strips x column ranges of whole tiles.
struct Grid {
  int strips, tiles, tiles_per_split, splits;
};

Grid grid_for(int n, int tile) {
  Grid g;
  g.strips = (n + kThreads - 1) / kThreads;
  g.tiles = (n + tile - 1) / tile;
  int splits = (kTargetBlocks + g.strips - 1) / g.strips;
  splits = splits < 1 ? 1 : (splits > g.tiles ? g.tiles : splits);
  g.tiles_per_split = (g.tiles + splits - 1) / splits;
  g.splits = (g.tiles + g.tiles_per_split - 1) / g.tiles_per_split;
  return g;
}

// One block's partial sums: [svar, sextra, grad_ell_0 .. grad_ell_{MAXD-1}]
// at part + block * (2 + kMaxD).
constexpr int kParts = 2 + kMaxD;

template <typename T, int KIND, int MAXD, int RW>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 2 : 1)
lowrank_kernel(const T* __restrict__ xs, const T* __restrict__ wl, const T* __restrict__ wr,
               const T* __restrict__ scal, double* __restrict__ part, int n, int d, int ld, int r,
               int tiles_per_split) {
  constexpr int CPT = 16 / sizeof(T);
  constexpr int S = MAXD + RW;  // a record's values
  constexpr int TILE = tile_for(sizeof(T), MAXD, RW);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double sred[kParts][kWarps];
  T* buf = reinterpret_cast<T*>(smem_raw);  // two tiles of TILE records

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i = blockIdx.x * kThreads + tid;
  const int tiles = (n + TILE - 1) / TILE;
  const int t0 = blockIdx.y * tiles_per_split;
  const int t1 = min(tiles, t0 + tiles_per_split);
  const T alpha = scal[1];
  const T half_ia = T(0.5) / alpha;

  auto issue = [&](int t) {
    if (tid < TILE) {
      T* rec = buf + ((t - t0) & 1) * (TILE * S) + tid * S;
      const int j = t * TILE + tid;
      const bool in = j < n;
      const T* xj = xs + int64_t(in ? j : 0) * d;
      const T* wj = wr + int64_t(in ? j : 0) * ld;
#pragma unroll
      for (int q = 0; q < MAXD; ++q) {
        const bool ok = in && q < d;
        cp_async_elem<sizeof(T)>(rec + q, ok ? xj + q : xs, ok ? int(sizeof(T)) : 0);
      }
#pragma unroll
      for (int c = 0; c < RW; ++c) {
        const bool ok = in && c < r;
        cp_async_elem<sizeof(T)>(rec + MAXD + c, ok ? wj + c : wr, ok ? int(sizeof(T)) : 0);
      }
    }
    cp_async_commit();
  };

  if (t0 < t1) issue(t0);
  T xi[MAXD], wli[RW];
#pragma unroll
  for (int q = 0; q < MAXD; ++q) xi[q] = (i < n && q < d) ? xs[int64_t(i) * d + q] : T(0);
#pragma unroll
  for (int c = 0; c < RW; ++c) wli[c] = (i < n && c < r) ? wl[int64_t(i) * ld + c] : T(0);
  double s_var = 0.0, s_extra = 0.0, s_ell[MAXD];
#pragma unroll
  for (int q = 0; q < MAXD; ++q) s_ell[q] = 0.0;

  for (int t = t0; t < t1; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; every thread is done with tile t - 1's buffer
    if (t + 1 < t1) issue(t + 1);
    const T* tile = buf + ((t - t0) & 1) * (TILE * S);
    const int jn = min(TILE, n - t * TILE);
    T tv = T(0), te = T(0), tl[MAXD];
#pragma unroll
    for (int q = 0; q < MAXD; ++q) tl[q] = T(0);
    for (int jj = 0; jj < jn; ++jj) {
      const T* rec = tile + jj * S;
      T df[MAXD];
      T r2 = T(0);
#pragma unroll
      for (int q = 0; q < MAXD; q += CPT) {
        T xj[CPT];
        lds16(xj, rec + q);
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          df[q + e] = xi[q + e] - xj[e];
          r2 = fma_t(df[q + e], df[q + e], r2);
        }
      }
      T w = T(0);
#pragma unroll
      for (int c = 0; c < RW; c += CPT) {
        T wj[CPT];
        lds16(wj, rec + MAXD + c);
#pragma unroll
        for (int e = 0; e < CPT; ++e) w = fma_t(wli[c + e], wj[e], w);
      }
      T G, E, F;
      maps<T, KIND>(r2, alpha, half_ia, G, E, F);
      tv = fma_t(w, G, tv);
      if (KIND == kRq) te = fma_t(w, F, te);
      const T m = w * E;
#pragma unroll
      for (int q = 0; q < MAXD; ++q) tl[q] = fma_t(m * df[q], df[q], tl[q]);
    }
    s_var += static_cast<double>(tv);
    if (KIND == kRq) s_extra += static_cast<double>(te);
#pragma unroll
    for (int q = 0; q < MAXD; ++q) s_ell[q] += static_cast<double>(tl[q]);
  }

  // The block's sums, in a fixed order: across each warp, then warp by warp.
  auto reduce = [&](int slot, double v) {
    v = warp_sum(v);
    if (lane == 0) sred[slot][warp] = v;
  };
  reduce(0, s_var);
  reduce(1, s_extra);
#pragma unroll
  for (int q = 0; q < MAXD; ++q) reduce(2 + q, s_ell[q]);
  __syncthreads();
  if (tid < kParts) {
    double s = 0.0;
    if (tid < 2 + MAXD)
      for (int w = 0; w < kWarps; ++w) s += sred[tid][w];
    part[(int64_t(blockIdx.y) * gridDim.x + blockIdx.x) * kParts + tid] = s;
  }
}

// Second pass: the blocks' partial sums, summed in a fixed order (thread v
// sums slot v over every block) and scaled by var: out = [svar,
// grad_ell_0 .. grad_ell_{d-1}, sextra].
template <typename T>
__global__ void __launch_bounds__(64)
finish_kernel(const double* __restrict__ part, int nblocks, const T* __restrict__ scal, T* __restrict__ out, int d) {
  const int v = threadIdx.x;
  if (v >= 2 + d) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += part[int64_t(b) * kParts + v];
  s *= static_cast<double>(scal[0]);
  const int slot = v == 0 ? 0 : (v == 1 ? d + 1 : v - 1);
  out[slot] = static_cast<T>(s);
}

template <typename T, int KIND, int MAXD, int RW>
cudaError_t launch_chunk(const T* xs, const T* wl, const T* wr, const T* scal, double* part, int n, int d, int ld,
                         int r, cudaStream_t s) {
  auto kernel = lowrank_kernel<T, KIND, MAXD, RW>;
  constexpr int TILE = tile_for(sizeof(T), MAXD, RW);
  const size_t smem = size_t(2) * TILE * (MAXD + RW) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const Grid g = grid_for(n, TILE);
  kernel<<<dim3(g.strips, g.splits), kThreads, smem, s>>>(xs, wl, wr, scal, part, n, d, ld, r, g.tiles_per_split);
  return cudaGetLastError();
}

template <typename T, int KIND, int MAXD>
cudaError_t launch_width(const T* xs, const T* wl, const T* wr, const T* scal, double* part, int n, int d, int ld,
                         int r, cudaStream_t s) {
  switch (rank_for(r)) {
    case 8: return launch_chunk<T, KIND, MAXD, 8>(xs, wl, wr, scal, part, n, d, ld, r, s);
    case 16: return launch_chunk<T, KIND, MAXD, 16>(xs, wl, wr, scal, part, n, d, ld, r, s);
    default: return launch_chunk<T, KIND, MAXD, 32>(xs, wl, wr, scal, part, n, d, ld, r, s);
  }
}

template <typename T, int KIND>
cudaError_t launch_kind(const T* xs, const T* wl, const T* wr, const T* scal, double* part, int n, int d, int ld,
                        int r, cudaStream_t s) {
  switch (max_d_for(d)) {
    case 8: return launch_width<T, KIND, 8>(xs, wl, wr, scal, part, n, d, ld, r, s);
    case 16: return launch_width<T, KIND, 16>(xs, wl, wr, scal, part, n, d, ld, r, s);
    default: return launch_width<T, KIND, 32>(xs, wl, wr, scal, part, n, d, ld, r, s);
  }
}

template <typename T>
int launch(const T* xs, const T* wl, const T* wr, const T* scal, void* work, T* out, int n, int d, int ld, int r,
           int kind, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD || r <= 0 || r > 32 || ld < r || kind < kRbf || kind > kRq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(work);
  cudaError_t err;
  switch (kind) {
    case kRbf: err = launch_kind<T, kRbf>(xs, wl, wr, scal, part, n, d, ld, r, s); break;
    case kMatern12: err = launch_kind<T, kMatern12>(xs, wl, wr, scal, part, n, d, ld, r, s); break;
    case kMatern32: err = launch_kind<T, kMatern32>(xs, wl, wr, scal, part, n, d, ld, r, s); break;
    case kMatern52: err = launch_kind<T, kMatern52>(xs, wl, wr, scal, part, n, d, ld, r, s); break;
    default: err = launch_kind<T, kRq>(xs, wl, wr, scal, part, n, d, ld, r, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const Grid g = grid_for(n, tile_for(sizeof(T), max_d_for(d), rank_for(r)));
  finish_kernel<T><<<1, 64, 0, s>>>(part, g.strips * g.splits, scal, out, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// xs (n, d); wl, wr: the first of r <= 32 columns of two (n, ld) row-major
// factors; scal = [var, alpha] on the device.  Writes out (d + 2,) =
// [svar, grad_ell (d), sextra]; work is scratch of
// lowrank_contract_workspace_bytes(n) bytes.
int lowrank_contract_f32(const float* xs, const float* wl, const float* wr, const float* scal, void* work,
                         float* out, int n, int d, int ld, int r, int kind, void* stream) {
  return launch<float>(xs, wl, wr, scal, work, out, n, d, ld, r, kind, stream);
}

int lowrank_contract_f64(const double* xs, const double* wl, const double* wr, const double* scal, void* work,
                         double* out, int n, int d, int ld, int r, int kind, void* stream) {
  return launch<double>(xs, wl, wr, scal, work, out, n, d, ld, r, kind, stream);
}

int64_t lowrank_contract_workspace_bytes(int n) {
  if (n <= 0) return -1;
  // every grid_for(n, tile) has at most strips x min(target splits, tiles of the smaller tile) blocks
  const Grid g = grid_for(n, kThreads / 2);
  const int splits = (kTargetBlocks + g.strips - 1) / g.strips;
  return int64_t(g.strips) * (splits < g.tiles ? splits : g.tiles) * kParts * int64_t(sizeof(double));
}

int lowrank_contract_max_d() { return kMaxD; }

int lowrank_contract_max_rank() { return 32; }

const char* lowrank_contract_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
