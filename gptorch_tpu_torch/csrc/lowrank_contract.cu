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
// What bounds it.  Operations: G, E and F are symmetric in (i, j) and every
// output is a global sum over pairs, so the function needs each unordered
// pair once, weighted by S_ij = W_ij + W_ji (W_ii on the diagonal):
// 2d + 3 flops for r2 by the norm identity, 4r for S_ij, about 3 for the
// maps, 2 for svar, 1 for S_ij E_ij and 2d + 2 for the length-scale sums by
// the reference's formula (M xs and the row and column sums of M = W o E):
// n (n + 1) / 2 (4d + 4r + 11) flops, 5.9 ms at n = 100000, d = 8, r = 9 on
// an H100 at 67 TFLOP/s in float32.  The card runs out of instruction issue
// first (128 a clock per SM): this kernel issues, per unordered pair, d
// subtractions, d squares and d - 1 adds for r2 (direct differences, below),
// P fused multiply-adds and an add for S_ij (P = 2r rounded up to 4: 20 at
// r = 9), ex2 and two for svar and S_ij E_ij (rbf), d fused multiply-adds for
// the length-scale sums, and a 16-byte shared load per R pairs for every 4
// values of a record: about 57 at d = 8, r = 9, R = 4, 8.5 ms at full issue
// for n = 100000.  Bytes are negligible: the records (11 MB at n = 100000,
// r = 9) are read from device memory once and re-read from L2.
//
// Records.  The wrapper (ops/lowrank_contract.py: _lowrank_records) writes,
// in one torch pass, one aligned record per point j and chunk of at most
// kMaxRank columns of the factors: [x'_j (MAXD, zero beyond d) | Wl_j0, Wr_j0,
// Wl_j1, Wr_j1, ... (P, zero beyond 2r)], x' = xs, and for rbf x' = s xs
// with s = sqrt(log2(e) / 2), so that G = ex2(-|x'_i - x'_j|^2) takes no
// multiply; the length-scale sums are then s^2 times the reference's, and
// the finishing kernel divides it out.  A row keeps its record in registers
// with each pair of factor values swapped, [Wr_i0, Wl_i0, ...], so that
// S_ij = W_ji + W_ij is one dot product of length P with the column's record,
// in two chains (even and odd terms) for latency.
//
// Design.  Memory: nothing n^2 is stored; S_ij, G, E, F live in registers for
// the pair that uses them.
//  * Each unordered pair once.  A block of 128 threads (four warps) takes
//    a strip of ROWS = 128 R rows; each thread owns R rows (rows_per_thread:
//    four at the matrix-free backward's d = 8, r = 9, where ptxas gives 212
//    registers and no spills, two blocks an SM; one in float64), row + 32 m,
//    and their records sit in registers.  The strip is paired with the
//    column tiles of kTile = 128 records at or below its diagonal: strip I
//    with tiles J < (ROWS / kTile) (I + 1).  A
//    warp whose rows all lie above a tile's columns runs the plain loop; a
//    warp that crosses the tile takes a uniform branch to a loop that
//    weights each pair by 1 (j < i), 1/2 (j = i: S_ii = 2 W_ii) or 0
//    (j > i); a warp wholly below the tile skips it.  r2 by direct
//    differences is exactly 0 on the diagonal.
//  * The triangle's (strip, tile) items, in strip order, are split into
//    equal contiguous ranges, one per block, with as many blocks as the
//    card holds at once (SM count times the occupancy the runtime reports):
//    one wave, every block the same number of items.  A block reloads its
//    rows when its range crosses into the next strip.
//  * Tiles arrive by 16-byte cp.async into a ring of two buffers while the
//    block computes on the other: one __syncthreads per item; every lane of
//    a warp reads the same record at a time, so each shared load is a
//    16-byte broadcast that serves R pairs.  Records beyond n are
//    zero-filled, and rows beyond n have S = 0.
//  * Sums: the outputs are d + 2 global sums, so a thread keeps one set of
//    sums whatever R is: an item's terms (at most 128 R) in the working type,
//    then a double running sum per thread; at the end across each warp,
//    across the warps in order, per block into a workspace, and over the
//    blocks by a one-block kernel in order.  No atomics: a gradient is the
//    same from run to run.
//  * r goes in chunks of kMaxRank columns, a launch each (the wrapper adds
//    the chunks' outputs in order).
//
// Plain C interface, loaded with ctypes.  lowrank_contract_plan gives the
// record layout, the workspace size and the grid; the entry points take
// that plan (they check it and do not query the card again), launch their two
// kernels on the given stream, do not synchronise, allocate nothing, and
// return the first CUDA error.

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
constexpr int kMaxRank = 16;  // columns of Wl and Wr in one launch: P <= 32
constexpr int kTile = 128;    // records of a column tile
// One block's partial sums: [svar, sextra, grad_ell_0 .. grad_ell_{MAXD-1}].
constexpr int kParts = 2 + kMaxD;
// 2 / log2(e): rbf's records are scaled by s = sqrt(log2(e) / 2), so its
// length-scale sums come out s^2 times too large.
constexpr double kRbfEllScale = 1.3862943611198906;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Rows a thread owns: their records take at most 112 registers in float32
// (four rows at d <= 8 and r <= 10, the matrix-free backward's r = 9; two
// at d <= 8 and r <= 16), one row in float64.
template <typename T>
__host__ __device__ constexpr int rows_per_thread(int s) {
  if (sizeof(T) != 4) return 1;
  return 4 * s <= 112 ? 4 : (2 * s <= 80 ? 2 : 1);
}

template <typename T, int MAXD, int P>
struct Shape {
  static constexpr int CPT = 16 / int(sizeof(T));  // values per 16-byte copy
  static constexpr int S = MAXD + P;               // a record
  static constexpr int R = rows_per_thread<T>(MAXD + P);
  static constexpr int ROWS = kThreads * R;
  static constexpr int C = ROWS / kTile;  // column tiles per strip of rows
  static constexpr int CHUNKS = kTile * S / CPT;  // 16-byte copies a tile
  static constexpr int SMEM = 2 * kTile * S * int(sizeof(T));
  static_assert(P % 4 == 0 && MAXD % 4 == 0, "records are whole 16-byte copies");
  static_assert(CHUNKS % kThreads == 0, "a tile's copies split evenly over the threads");
};

// 2^-t: rbf's map on scaled records.
__device__ __forceinline__ float exp2_neg(float t) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(-t));
  return y;
}
__device__ __forceinline__ double exp2_neg(double t) { return exp2(-t); }

// The sum of v[0 .. N) as a balanced tree (no long dependent chain).
template <int N, typename T>
__device__ __forceinline__ T tree_sum(const T* v) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    return tree_sum<N / 2>(v) + tree_sum<N - N / 2>(v + N / 2);
  }
}

// One warp's pairs of a tile: jn records at `tile` (columns j0, ...) against
// the thread's R rows (row, row + 32, ...), their records xr (the inputs)
// and ar (the factors, pairwise swapped).  DIAG weights each pair by its
// place against the diagonal.
template <typename T, int KIND, int MAXD, int P, bool DIAG>
__device__ __forceinline__ void tile_pairs(const T* __restrict__ tile, int jn,
                                           const T (&xr)[Shape<T, MAXD, P>::R][MAXD],
                                           const T (&ar)[Shape<T, MAXD, P>::R][P], int row, int j0, T alpha,
                                           T half_ia, T& tv, T& te, T (&tl)[MAXD]) {
  using Sh = Shape<T, MAXD, P>;
  constexpr int R = Sh::R, CPT = Sh::CPT, S = Sh::S;
  constexpr int kUnroll = DIAG ? 1 : 2;
#pragma unroll kUnroll
  for (int jj = 0; jj < jn; ++jj) {
    const T* rec = tile + jj * S;
    T xj[MAXD], wj[P];
#pragma unroll
    for (int q = 0; q < MAXD; q += CPT) {
      T v[CPT];
      lds16(v, rec + q);
#pragma unroll
      for (int e = 0; e < CPT; ++e) xj[q + e] = v[e];
    }
#pragma unroll
    for (int k = 0; k < P; k += CPT) {
      T v[CPT];
      lds16(v, rec + MAXD + k);
#pragma unroll
      for (int e = 0; e < CPT; ++e) wj[k + e] = v[e];
    }
#pragma unroll
    for (int m = 0; m < R; ++m) {
      T sq[MAXD];
#pragma unroll
      for (int q = 0; q < MAXD; ++q) {
        const T df = xr[m][q] - xj[q];
        sq[q] = df * df;
      }
      const T r2 = tree_sum<MAXD>(sq);
      T s0 = ar[m][0] * wj[0], s1 = ar[m][1] * wj[1];  // W_ji's and W_ij's terms
#pragma unroll
      for (int k = 2; k < P; k += 2) {
        s0 = fma_t(ar[m][k], wj[k], s0);
        s1 = fma_t(ar[m][k + 1], wj[k + 1], s1);
      }
      T s = s0 + s1;
      if (DIAG) {
        const int i = row + 32 * m, j = j0 + jj;
        s = j < i ? s : (j == i ? T(0.5) * s : T(0));
      }
      T mm;
      if constexpr (KIND == kRbf) {
        mm = s * exp2_neg(r2);  // E = G
        tv += mm;
      } else {
        T G, E, F;
        maps<T, KIND>(r2, alpha, half_ia, G, E, F);
        tv = fma_t(s, G, tv);
        if (KIND == kRq) te = fma_t(s, F, te);
        mm = s * E;
      }
#pragma unroll
      for (int q = 0; q < MAXD; ++q) tl[q] = fma_t(mm, sq[q], tl[q]);
    }
  }
}

// Strip I and the first item of a block's range: items before strip I are
// C I (I + 1) / 2.
__device__ __forceinline__ void locate(int64_t p, int c, int& I, int& J) {
  int64_t i = static_cast<int64_t>((sqrt(8.0 * double(p) / c + 1.0) - 1.0) * 0.5);
  while (i > 0 && c * i * (i + 1) / 2 > p) --i;
  while (c * (i + 1) * (i + 2) / 2 <= p) ++i;
  I = static_cast<int>(i);
  J = static_cast<int>(p - c * i * (i + 1) / 2);
}

template <typename T, int KIND, int MAXD, int P>
__global__ void __launch_bounds__(kThreads)
lowrank_kernel(const T* __restrict__ rec, const T* __restrict__ scal, double* __restrict__ part, int n,
               int64_t items, int64_t per_block) {
  using Sh = Shape<T, MAXD, P>;
  constexpr int R = Sh::R, S = Sh::S, CPT = Sh::CPT, C = Sh::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double sred[kParts][kWarps];
  T* buf = reinterpret_cast<T*>(smem_raw);  // two tiles of kTile records

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t p0 = int64_t(blockIdx.x) * per_block;
  const int64_t p1 = items < p0 + per_block ? items : p0 + per_block;
  const T alpha = scal[1];
  const T half_ia = T(0.5) / alpha;
  const int64_t rec_end = int64_t(n) * S;

  // A tile is kTile consecutive records: one contiguous run of the array.
  auto issue = [&](int64_t p, int J) {
    T* dst = buf + ((p - p0) & 1) * (kTile * S);
    const int64_t base = int64_t(J) * kTile * S;
#pragma unroll
    for (int s = 0; s < Sh::CHUNKS / kThreads; ++s) {
      const int e = s * kThreads + tid;
      const int64_t off = base + int64_t(e) * CPT;
      const bool ok = off < rec_end;
      cp_async16(dst + e * CPT, rec + (ok ? off : 0), ok ? 16 : 0);
    }
    cp_async_commit();
  };

  int I = 0, J = 0;
  if (p0 < p1) {
    locate(p0, C, I, J);
    issue(p0, J);
  }
  T xr[R][MAXD], ar[R][P];
  int rows_of = -1;  // the strip whose rows xr and ar hold
  double s_var = 0.0, s_extra = 0.0, s_ell[MAXD];
#pragma unroll
  for (int q = 0; q < MAXD; ++q) s_ell[q] = 0.0;

  for (int64_t p = p0; p < p1; ++p) {
    int nI = I, nJ = J + 1;  // the next item
    if (nJ == C * (I + 1)) {
      ++nI;
      nJ = 0;
    }
    cp_async_wait_all();
    __syncthreads();  // item p's tile has landed; every warp is done with item p - 1's buffer
    if (p + 1 < p1) issue(p + 1, nJ);
    const int rlo = I * Sh::ROWS + warp * 32 * R;  // the warp's rows: rlo + 32 m + lane
    if (I != rows_of) {
      rows_of = I;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int i = rlo + 32 * m + lane;
        const bool in = i < n;
        const T* ri = rec + int64_t(in ? i : 0) * S;
#pragma unroll
        for (int q = 0; q < MAXD; ++q) xr[m][q] = in ? ri[q] : T(0);
#pragma unroll
        for (int k = 0; k < P; ++k) ar[m][k] = in ? ri[MAXD + (k ^ 1)] : T(0);
      }
    }
    const int j0 = J * kTile;
    const int jn = n - j0 < kTile ? n - j0 : kTile;
    const T* tile = buf + ((p - p0) & 1) * (kTile * S);
    T tv = T(0), te = T(0), tl[MAXD];
#pragma unroll
    for (int q = 0; q < MAXD; ++q) tl[q] = T(0);
    if (j0 + kTile <= rlo) {
      tile_pairs<T, KIND, MAXD, P, false>(tile, jn, xr, ar, rlo + lane, j0, alpha, half_ia, tv, te, tl);
    } else if (j0 < rlo + 32 * R) {
      tile_pairs<T, KIND, MAXD, P, true>(tile, jn, xr, ar, rlo + lane, j0, alpha, half_ia, tv, te, tl);
    }
    s_var += static_cast<double>(tv);
    if (KIND == kRq) s_extra += static_cast<double>(te);
#pragma unroll
    for (int q = 0; q < MAXD; ++q) s_ell[q] += static_cast<double>(tl[q]);
    I = nI;
    J = nJ;
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
    part[int64_t(blockIdx.x) * kParts + tid] = s;
  }
}

// Second pass: the blocks' partial sums, summed in a fixed order (thread v
// sums slot v over every block) and scaled by var (and the length-scale
// sums by ell_scale): out = [svar, grad_ell_0 .. grad_ell_{d-1}, sextra].
template <typename T>
__global__ void __launch_bounds__(64)
finish_kernel(const double* __restrict__ part, int nblocks, const T* __restrict__ scal, T* __restrict__ out, int d,
              double ell_scale) {
  const int v = threadIdx.x;
  if (v >= 2 + d) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += part[int64_t(b) * kParts + v];
  s *= static_cast<double>(scal[0]);
  if (v >= 2) s *= ell_scale;
  const int slot = v == 0 ? 0 : (v == 1 ? d + 1 : v - 1);
  out[slot] = static_cast<T>(s);
}

struct Plan {
  int maxd, p, width, grid;
  int64_t items, per_block, work_bytes;
};

int max_d_for(int d) { return d <= 8 ? 8 : (d <= 16 ? 16 : 32); }

// The factor columns of a record: 2r rounded up to 4 (float32) or 8
// (float64, fewer instances off the main path).
template <typename T>
int width_for(int r) {
  return round_up(2 * r, sizeof(T) == 4 ? 4 : 8);
}

template <typename T, int KIND, int MAXD, int P>
struct Instance {
  using Sh = Shape<T, MAXD, P>;

  static cudaError_t plan(int n, Plan& pl) {
    auto kernel = lowrank_kernel<T, KIND, MAXD, P>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, Sh::SMEM);
    if (err != cudaSuccess) return err;
    pl.maxd = MAXD;
    pl.p = P;
    pl.width = Sh::S;
    pl.items = items(n);
    const int64_t resident = sms * per_sm > 0 ? int64_t(sms) * per_sm : 1;
    pl.per_block = (pl.items + resident - 1) / resident;
    pl.grid = static_cast<int>((pl.items + pl.per_block - 1) / pl.per_block);
    pl.work_bytes = int64_t(pl.grid) * kParts * int64_t(sizeof(double));
    return cudaSuccess;
  }

  // The triangle's (strip, tile) items: the strips' tiles at or below their diagonal.
  static int64_t items(int n) {
    const int64_t strips = (int64_t(n) + Sh::ROWS - 1) / Sh::ROWS;
    return Sh::C * strips * (strips + 1) / 2;
  }

  // plan: lowrank_contract_plan's [MAXD, P, width, workspace bytes, grid, items a block].
  static cudaError_t launch(const T* rec, const T* scal, double* part, T* out, int n, int d, const int64_t* plan,
                            cudaStream_t s) {
    const int64_t all = items(n), per_block = plan[5], grid = plan[4];
    if (plan[0] != MAXD || plan[1] != P || plan[2] != Sh::S || per_block < 1 || grid > INT32_MAX ||
        grid != (all + per_block - 1) / per_block || plan[3] < grid * kParts * int64_t(sizeof(double)))
      return cudaErrorInvalidValue;
    lowrank_kernel<T, KIND, MAXD, P><<<static_cast<int>(grid), kThreads, Sh::SMEM, s>>>(rec, scal, part, n, all,
                                                                                        per_block);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    finish_kernel<T><<<1, 64, 0, s>>>(part, static_cast<int>(grid), scal, out, d,
                                      KIND == kRbf ? kRbfEllScale : 1.0);
    return cudaGetLastError();
  }
};

template <typename T, int KIND, int MAXD, typename F>
cudaError_t by_rank(int p, F& f) {
  if constexpr (sizeof(T) == 4) {
    switch (p) {
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
    switch (p) {
      case 8: return f(Instance<T, KIND, MAXD, 8>());
      case 16: return f(Instance<T, KIND, MAXD, 16>());
      case 24: return f(Instance<T, KIND, MAXD, 24>());
      default: return f(Instance<T, KIND, MAXD, 32>());
    }
  }
}

template <typename T, int KIND, typename F>
cudaError_t by_width(int maxd, int p, F& f) {
  switch (maxd) {
    case 8: return by_rank<T, KIND, 8>(p, f);
    case 16: return by_rank<T, KIND, 16>(p, f);
    default: return by_rank<T, KIND, 32>(p, f);
  }
}

// Calls f(Instance<T, kind, MAXD, P>()) for the instance that serves (d, r).
template <typename T, typename F>
cudaError_t dispatch(int kind, int d, int r, F&& f) {
  const int maxd = max_d_for(d), p = width_for<T>(r);
  switch (kind) {
    case kRbf: return by_width<T, kRbf>(maxd, p, f);
    case kMatern12: return by_width<T, kMatern12>(maxd, p, f);
    case kMatern32: return by_width<T, kMatern32>(maxd, p, f);
    case kMatern52: return by_width<T, kMatern52>(maxd, p, f);
    default: return by_width<T, kRq>(maxd, p, f);
  }
}

template <typename T>
cudaError_t plan_of(int n, int d, int r, int kind, Plan& pl) {
  if (n <= 0 || d <= 0 || d > kMaxD || r <= 0 || r > kMaxRank || kind < kRbf || kind > kRq)
    return cudaErrorInvalidValue;
  return dispatch<T>(kind, d, r, [&](auto inst) { return decltype(inst)::plan(n, pl); });
}

// Launches with the plan that lowrank_contract_plan gave for these
// arguments; the instance checks that it is its own, so the occupancy query
// runs once a launch, in the plan.
template <typename T>
int launch(const T* rec, const T* scal, void* work, T* out, int n, int d, int r, int kind, const int64_t* plan,
           void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD || r <= 0 || r > kMaxRank || kind < kRbf || kind > kRq || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(rec) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (work == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* part = static_cast<double*>(work);
  return static_cast<int>(
      dispatch<T>(kind, d, r, [&](auto inst) { return decltype(inst)::launch(rec, scal, part, out, n, d, plan, s); }));
}

}  // namespace

extern "C" {

// The layout for (n, d, r <= 16, kind) in the working type of `itemsize`
// bytes on the current device: plan = [MAXD, P, record width, workspace
// bytes, grid, items a block]; the entry points launch with it.  The records are (n, width), row-major, 16-byte aligned: record j
// is [x'_j (MAXD) | Wl_j0, Wr_j0, ..., Wl_j(r-1), Wr_j(r-1) | zeros to P].
int lowrank_contract_plan(int itemsize, int n, int d, int r, int kind, int64_t* plan) {
  Plan pl;
  cudaError_t err = itemsize == 4   ? plan_of<float>(n, d, r, kind, pl)
                    : itemsize == 8 ? plan_of<double>(n, d, r, kind, pl)
                                    : cudaErrorInvalidValue;
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[0] = pl.maxd;
  plan[1] = pl.p;
  plan[2] = pl.width;
  plan[3] = pl.work_bytes;
  plan[4] = pl.grid;
  plan[5] = pl.per_block;
  return 0;
}

// rec: the records above; scal = [var, alpha] on the device; work: the
// plan's workspace bytes of scratch; plan: lowrank_contract_plan's for the
// same (n, d, r, kind) on the current device.  Writes out (d + 2,) = [svar,
// grad_ell (d), sextra].
int lowrank_contract_f32(const float* rec, const float* scal, void* work, float* out, int n, int d, int r, int kind,
                         const int64_t* plan, void* stream) {
  return launch<float>(rec, scal, work, out, n, d, r, kind, plan, stream);
}

int lowrank_contract_f64(const double* rec, const double* scal, void* work, double* out, int n, int d, int r,
                         int kind, const int64_t* plan, void* stream) {
  return launch<double>(rec, scal, work, out, n, d, r, kind, plan, stream);
}

int lowrank_contract_max_d() { return kMaxD; }

int lowrank_contract_max_rank() { return kMaxRank; }

const char* lowrank_contract_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
