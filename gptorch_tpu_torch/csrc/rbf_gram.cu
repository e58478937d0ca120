// Radial (RBF) Gram matrices on Hopper, B of them in one launch (K1):
//
//   out[b, i, j] = var[b] * exp(-0.5 * max(sum_q (x1[b, i, q] - x2[b, j, q])^2, 0))
//                  (+ diag[b] where i == j, for a symmetric Gram given a diagonal)
//
// for x1 (B, n1, d), x2 (B, n2, d), out (B, n1, n2), all contiguous; a
// single Gram is the case B = 1, a symmetric one passes x2 = x1.
//
// Replaces the Pallas TPU kernel gptorch_tpu/ops/pallas_gram.py:_rbf_tile_kernel
// (called through rbf_gram there).  Same function, not the same blocking.
//
// What bounds it.  At d = 8 the function does 3d + 3 = 27 flops for every
// output element it writes, so the n1 * n2 write is the bound: for
// n = 32768 in float32 that is 4.29 GB, 1.28 ms at 3.35 TB/s.  The card's
// issue rate is not far behind: r^2 from direct differences, the clamp, the
// exp (a range reduction around the MUFU's ex2) and the scale are ~27
// instructions an element in float32, ~1 ms at 32768^2 on 132 SMs, and in
// float64 (half the rate, exp in software) ~3 ms, more than its 2.56 ms of
// writes.  So the design writes every output once with wide streaming
// stores, keeps the arithmetic of one tile under the stores of the last,
// and computes a symmetric Gram's lower triangle only.
//
// Numerics (every mapping below gives the same bits for an element):
// r^2 is summed from direct differences over q in ascending order (no
// cancellation; an exact 0 on the diagonal of a symmetric Gram, whose two
// triangles are bitwise equal since (a - b)^2 == (b - a)^2), clamped at 0
// by a comparison that keeps a NaN a NaN, scaled by var after the exp, and
// the diagonal is added last.
//
// Mappings (the wrapper, ops/gram.py:plan, picks one from B, n1 and n2):
//  * Tiles: TM x 64 output tiles of a cross Gram (TM = 128 in float32 past
//    64 rows, else 64), walked in grid-stride order.  The wrapper sizes the
//    grid: for float32's 16-byte 128-row tiles, past four waves of them, a
//    persistent grid (SMs x resident blocks, from the occupancy API), whose
//    blocks stage the next tile's x rows by cp.async while this one's
//    arithmetic and stores run; for the other tiles a block a tile, which
//    the H100 runs faster (float64's and scalar stores' tiles cost more or
//    less from tile to tile, and the card's block scheduler balances them;
//    a few waves end more evenly).  A thread owns an 8 x 4 or 4 x 4
//    (float32) or 8 x 2 (float64) block of rows and columns, so each of its
//    stores is 16 bytes (st.global.cs: the Gram is not read back here, so
//    its lines are marked evict-first) and a warp stores whole 256- or
//    512-byte row segments.  Rows whose start is not 16-byte aligned
//    (n2 % 4 != 0 in float32, n2 odd in float64) take an instance with
//    scalar stores, its threads' columns strided so that a warp's store
//    covers neighbouring columns.  The x rows of a tile are staged into
//    shared memory, 8 coordinates a stage, transposed, by cp.async in two
//    buffers.  A member's tiles and the member are found once a tile,
//    never per element.
//  * Halved symmetric tiles (every symmetric Gram past 32 x 32): only the
//    64 x 64 tiles (I, J), I >= J, are computed, a block a tile; an
//    off-diagonal tile is stored, then staged in shared memory (16-byte
//    blocks XOR-swizzled by row, no bank conflicts either way) and stored
//    again transposed at (J, I).
//  * Packed members (n1, n2 <= 32, e.g. the Vecchia chunk's 32 x 32): a
//    warp per member (and group of 8 rows for a batch under 1024), lane j
//    one column, rows in turn; a block of 8 warps writes 8 members.
//  * Rows (n2 = 1): a thread per output row.
//  * Columns (a cross Gram of at most 16 rows against many points): a
//    thread per output column.
//
// Plain C interface, loaded with ctypes.  Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 64;        // output tile columns
constexpr int kChunk = 8;        // coordinates a stage
constexpr int kPackedMax = 32;   // members of at most this many rows and columns are packed a warp each
constexpr int kColumnsMax = 16;  // cross Grams of at most this many rows take a thread a column
constexpr int kShortRows = 64;   // float32 cross Grams of at most this many rows take 64-row tiles
constexpr int kMaxRows = 1 << 30;
constexpr int64_t kMaxTiles = INT32_MAX;

// The wrapper's mapping codes (ops/gram.py).
enum Mapping {
  kMapTiles = 0, kMapTilesVec = 1, kMapHalf = 2, kMapHalfVec = 3, kMapPacked = 4, kMapRows = 5, kMapColumns = 6,
  kMappings = 7
};

template <typename T>
struct Args {
  const T* x1;
  const T* x2;    // x1 for a symmetric Gram
  const T* var;   // var[b * var_stride]
  const T* diag;  // diag[b * diag_stride]; null for none (always null for a cross Gram)
  T* out;
  int64_t var_stride, diag_stride;
  int batch, n1, n2, d;
};

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// var * exp(-r2 / 2) from the summed r2, clamped at 0 (a NaN stays a NaN).
template <typename T>
__device__ __forceinline__ T radial(T acc, T var) {
  const T r2 = acc < T(0) ? T(0) : acc;
  return var * exp_t(T(-0.5) * r2);
}

// 16-byte moves of 16 / sizeof(T) values.
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void ld16(const double* p, double* v) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x, v[1] = t.y;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
// Streaming (evict-first) stores to device memory.
__device__ __forceinline__ void st16_cs(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void st16_cs(double* p, const double* v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// A tile of TM rows and kCols columns.  Thread (ty, tx) owns rows
// ty * kRowsPerThread + r and kVec columns (col_of).  A float32 cross Gram
// of more than 64 rows takes TM = 128 (32 values a thread: the tile's
// fixed costs, its staging, barriers and walk step, spread over twice the
// elements); TM = 64 otherwise, a mirrored tile square.
template <typename T, int TM>
struct TileShape {
  static constexpr int kVec = 16 / int(sizeof(T));                // columns a 16-byte store holds: 4, 2
  static constexpr int kLanesPerRow = kCols / kVec;               // 16, 32
  static constexpr int kRowsPerPass = kThreads / kLanesPerRow;    // 16, 8
  static constexpr int kRowsPerThread = TM / kRowsPerPass;        // 4 or 8 (float32), 8 (float64)
  static constexpr int kStage = (TM + kCols) * kChunk;           // elements of a stage: x1's and x2's rows
};

// Column k of thread tx: tx * V + k, contiguous, where 16-byte stores
// write them; tx + k * lanes, strided, where stores are scalar (rows not
// 16-byte aligned), so that a warp's scalar store covers neighbouring
// columns (measured faster on the H100 than contiguous ones, and than one
// column a thread).  A mirrored tile keeps them contiguous.
template <typename T, bool kStrided>
__device__ __forceinline__ int col_of(int tx, int k) {
  constexpr int V = 16 / int(sizeof(T));
  return kStrided ? tx + k * (kCols / V) : tx * V + k;
}

// Resident blocks an SM the registers are cut for: 4 in float32 (64
// registers a thread); in float64, whose values take two registers each
// (its accumulators spill at 64), 3 (85) for a cross Gram's tiles and 2
// (128) for mirrored ones, whose transposed pass holds a tile's column too
// (no spills there).
template <typename T, bool kHalf>
constexpr int min_blocks() {
  return sizeof(T) == 4 ? 4 : (kHalf ? 2 : 3);
}

// The row tile: 128 for a float32 cross Gram of more than 64 rows, 64
// otherwise (ops/gram.py:plan counts tiles the same way).
inline int row_tile(int itemsize, bool half, int n1) { return itemsize == 4 && !half && n1 > kShortRows ? 128 : 64; }

// A packed warp's rows of its member: all 32 for a large batch, 8 (four
// warps a member) when the batch alone would leave the card idle.
__host__ __device__ inline int packed_rows(int batch) { return batch >= 1024 ? 32 : 8; }

// Two stages, and a tile buffer for a mirrored tile.
template <typename T, int TM>
constexpr int tile_smem_bytes(bool half) {
  return (2 * (TM + kCols) * kChunk + (half ? TM * kCols : 0)) * int(sizeof(T));
}

// A tile of the walk: member b, first row r0 and column c0, whether it
// holds part of the diagonal, and whether (halved symmetric) it is also
// stored transposed.
struct TileAt {
  int b, r0, c0;
  bool on_diag, mirror;
};

// A block's walk over the launch's tiles t = blockIdx.x + k gridDim.x, in
// 32 bits (a launch has fewer than 2^31 tiles): member b's tile r, r
// row-major over (I, J) or, halved, I (I + 1) / 2 + J with J <= I.  The
// first tile takes two divisions; each step adds gridDim.x as whole
// members and a remainder of tiles.
struct Walk {
  unsigned per, cols, step_b, step_r, b, r;
};

__device__ __forceinline__ Walk walk_start(unsigned per_member, unsigned col_tiles) {
  Walk w;
  w.per = per_member;
  w.cols = col_tiles;
  w.b = blockIdx.x / per_member;
  w.r = blockIdx.x - w.b * per_member;
  w.step_b = gridDim.x / per_member;
  w.step_r = gridDim.x - w.step_b * per_member;
  return w;
}

__device__ __forceinline__ void walk_step(Walk& w) {
  w.r += w.step_r;
  w.b += w.step_b;
  if (w.r >= w.per) w.r -= w.per, ++w.b;
}

template <int TM, bool kHalf>
__device__ __forceinline__ TileAt tile_of(const Walk& w) {
  unsigned I, J;
  if (kHalf) {
    I = static_cast<unsigned>((sqrtf(8.0f * static_cast<float>(w.r) + 1.0f) - 1.0f) * 0.5f);
    while (uint64_t(I) * (I + 1) / 2 > w.r) --I;
    while (uint64_t(I + 1) * (I + 2) / 2 <= w.r) ++I;
    J = w.r - static_cast<unsigned>(uint64_t(I) * (I + 1) / 2);
  } else {
    I = w.r / w.cols;
    J = w.r - I * w.cols;
  }
  const int r0 = static_cast<int>(I) * TM, c0 = static_cast<int>(J) * kCols;
  return TileAt{static_cast<int>(w.b), r0, c0, r0 < c0 + kCols && c0 < r0 + TM, kHalf && I != J};
}

// Issues the cp.async copies of coordinates [q0, q0 + kChunk) of the tile's
// TM x1 rows and kCols x2 rows into the stage s = [x1: kChunk][TM] then
// [x2: kChunk][kCols] (transposed); rows and coordinates out of range are
// stored as 0 and add nothing to r^2.
template <typename T, int TM>
__device__ __forceinline__ void stage(T* s, const Args<T>& a, const TileAt& at, int q0) {
  const T* x1 = a.x1 + int64_t(at.b) * a.n1 * a.d;
  const T* x2 = a.x2 + int64_t(at.b) * a.n2 * a.d;
#pragma unroll
  for (int j = 0; j < (TM + kCols) * kChunk / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const bool second = e >= kChunk * TM;
    const int f = second ? e - kChunk * TM : e;
    const int width = second ? kCols : TM;
    const int q = f / width, r = f % width;
    const int row = (second ? at.c0 : at.r0) + r;
    const T* base = second ? x2 : x1;
    if (row < (second ? a.n2 : a.n1) && q0 + q < a.d)
      cp_async::cp_async_elem<int(sizeof(T))>(s + e, base + int64_t(row) * a.d + q0 + q, int(sizeof(T)));
    else
      s[e] = T(0);  // visible to the block after the barrier that follows the wait
  }
}

// Stores a thread's values of one row, at columns c0 + col_of(tx, k).
template <typename T, bool kVecStore, bool kStrided>
__device__ __forceinline__ void store_row(T* row_ptr, int c0, int tx, int n2, const T* v) {
  constexpr int V = 16 / int(sizeof(T));
  if (kVecStore) {
    if (c0 + tx * V < n2) st16_cs(row_ptr + c0 + tx * V, v);  // n2 % V == 0: all V columns are in or all out
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int col = c0 + col_of<T, kStrided>(tx, k);
      if (col < n2) __stcs(row_ptr + col, v[k]);
    }
  }
}

// The finished tile: var * exp(-r2 / 2) (+ diag) stored from registers, and
// for a mirrored tile once more, transposed, through shared memory.
template <typename T, int TM, bool kVecStore, bool kHalf, int V = TileShape<T, TM>::kVec,
          int RPT = TileShape<T, TM>::kRowsPerThread>
__device__ __forceinline__ void finish_tile(const Args<T>& a, const TileAt& at, T (&acc)[RPT][V], T* tile, int ty,
                                            int tx) {
  constexpr bool kStrided = !kVecStore && !kHalf;
  const T var = a.var[at.b * a.var_stride];
  T* out = a.out + int64_t(at.b) * a.n1 * a.n2;
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[r][k] = radial(acc[r][k], var);
  // Only a mirrored tile holds a diagonal (a cross Gram's diag is null).
  // The scalar-store instances test diag at run time all the same: without
  // the test nvcc schedules their strided stores so that the H100 runs
  // them up to 23 % slower (4099 x 1031, float32), while the 16-byte
  // instances run ~9 % faster without it (PERF.md).
  if ((kHalf || !kVecStore) && a.diag != nullptr && at.on_diag) {
    const T dg = a.diag[at.b * a.diag_stride];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (at.r0 + ty * RPT + r == at.c0 + col_of<T, kStrided>(tx, k)) acc[r][k] += dg;
  }
  const int row0 = at.r0 + ty * RPT;
  // the thread's rows, one row (n2 elements) apart
  T* row_ptr = out + int64_t(row0) * a.n2;
#pragma unroll
  for (int r = 0; r < RPT; ++r, row_ptr += a.n2)
    if (row0 + r < a.n1) store_row<T, kVecStore, kStrided>(row_ptr, at.c0, tx, a.n2, acc[r]);
  if constexpr (kHalf) {
    static_assert(TM == kCols, "a mirrored tile is square");
    if (!at.mirror) return;
    // tile[i][block p ^ swz(i)] holds the tile's row i, 16-byte block p;
    // swz(i) = (i / V) % 8 spreads both the row-wise writes here and the
    // column-wise reads below over distinct banks.
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = ty * RPT + r;
      st16(tile + i * kCols + ((tx ^ ((i / V) & 7)) * V), acc[r]);
    }
    __syncthreads();
    // The transposed tile: rows c0 + ty * RPT + r (all below n1, since
    // c0 + 64 <= r0), columns r0 + tx * V + k (masked at n1).
    T w[V][RPT];  // w[k][r] = tile[tx * V + k][ty * RPT + r]
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = tx * V + k;
#pragma unroll
      for (int m = 0; m < RPT / V; ++m)
        ld16(tile + i * kCols + ((((ty * RPT) / V + m) ^ ((i / V) & 7)) * V), &w[k][m * V]);
    }
    T* mirror_ptr = out + int64_t(at.c0 + ty * RPT) * a.n2;
#pragma unroll
    for (int r = 0; r < RPT; ++r, mirror_ptr += a.n2) {
      T v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = w[k][r];
      store_row<T, kVecStore, false>(mirror_ptr, at.r0, tx, a.n2, v);
    }
    __syncthreads();  // the tile buffer is free for the next mirrored tile
  }
}

template <typename T, int TM, bool kVecStore, bool kHalf>
__global__ void __launch_bounds__(kThreads, min_blocks<T, kHalf>())
rbf_gram_kernel_tiles(const Args<T> a, unsigned per_member, unsigned col_tiles, unsigned total) {
  using S = TileShape<T, TM>;
  constexpr int V = S::kVec, RPT = S::kRowsPerThread;
  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);
  T* tile = stages + 2 * S::kStage;  // mirrored tiles only

  unsigned t = blockIdx.x;
  if (t >= total) return;
  const int ty = threadIdx.x / S::kLanesPerRow;
  const int tx = threadIdx.x % S::kLanesPerRow;
  const int chunks = a.d > kChunk ? (a.d + kChunk - 1) / kChunk : 1;  // d = 0: one empty stage, r^2 = 0

  Walk walk = walk_start(per_member, col_tiles);
  TileAt at = tile_of<TM, kHalf>(walk);
  stage<T, TM>(stages, a, at, 0);
  cp_async::cp_async_commit();

  T acc[RPT][V];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[r][k] = T(0);

  // Steps (tile, chunk) in order; each issues the next step's stage into
  // the other buffer before it computes its own.
  int c = 0, buf = 0;
  for (;;) {
    int next_c = c + 1;
    unsigned next_t = t;
    if (next_c == chunks) next_c = 0, next_t = t + gridDim.x;
    const bool more = next_t < total;  // total + gridDim.x < 2^32: no wrap
    TileAt next = at;
    if (more) {
      if (next_t != t) {
        walk_step(walk);
        next = tile_of<TM, kHalf>(walk);
      }
      stage<T, TM>(stages + (buf ^ 1) * S::kStage, a, next, next_c * kChunk);
    }
    cp_async::cp_async_commit();
    cp_async_wait_one();  // this step's stage has landed; the next may be in flight
    __syncthreads();

    const T* s1 = stages + buf * S::kStage;
    const T* s2 = s1 + kChunk * TM;
    const int qn = a.d - c * kChunk;
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (q < qn) {
        T xa[RPT], xb[V];
#pragma unroll
        for (int m = 0; m < RPT / V; ++m) ld16(s1 + q * TM + ty * RPT + m * V, xa + m * V);
        if constexpr (!kVecStore && !kHalf) {
#pragma unroll
          for (int k = 0; k < V; ++k) xb[k] = s2[q * kCols + col_of<T, true>(tx, k)];
        } else {
          ld16(s2 + q * kCols + tx * V, xb);
        }
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const T diff = xa[r] - xb[k];
            acc[r][k] = fma_t(diff, diff, acc[r][k]);
          }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is refilled

    if (c == chunks - 1) {
      finish_tile<T, TM, kVecStore, kHalf>(a, at, acc, tile, ty, tx);
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int k = 0; k < V; ++k) acc[r][k] = T(0);
    }
    if (!more) break;
    t = next_t;
    at = next;
    c = next_c;
    buf ^= 1;
  }
}

// Members of at most 32 x 32: a warp per member and group of R rows
// (packed_rows; grid-stride over both), lane j the column, the rows in
// turn.  For d <= KD (4 or 8) lane i holds row i of x1 and row j of x2 in
// registers, zero past d (a zero difference adds exactly nothing), and row
// i reaches the other lanes by shuffles; KD = 0 reads the rows for each
// element (L1).
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads) rbf_gram_kernel_packed(const Args<T> a) {
  const int lane = threadIdx.x & 31;
  const int R = packed_rows(a.batch), groups = (a.n1 + R - 1) / R;
  const int64_t items = int64_t(a.batch) * groups, stride = int64_t(gridDim.x) * kWarps;
  for (int64_t w = int64_t(blockIdx.x) * kWarps + threadIdx.x / 32; w < items; w += stride) {
    const int64_t b = w / groups;
    const int i0 = int(w - b * groups) * R, i1 = min(a.n1, i0 + R);
    const T* x1 = a.x1 + b * a.n1 * a.d;
    const T* x2 = a.x2 + b * a.n2 * a.d;
    T* out = a.out + b * a.n1 * a.n2;
    const T var = a.var[b * a.var_stride];
    const T dg = a.diag != nullptr ? a.diag[b * a.diag_stride] : T(0);
    T xr[KD > 0 ? KD : 1], xc[KD > 0 ? KD : 1];
#pragma unroll
    for (int q = 0; q < KD; ++q) {
      xr[q] = lane < a.n1 && q < a.d ? __ldg(x1 + lane * a.d + q) : T(0);
      xc[q] = lane < a.n2 && q < a.d ? __ldg(x2 + lane * a.d + q) : T(0);
    }
#pragma unroll 2
    for (int i = i0; i < i1; ++i) {
      T acc = T(0);
      if (KD > 0) {
#pragma unroll
        for (int q = 0; q < KD; ++q) {
          const T diff = __shfl_sync(0xffffffffu, xr[q], i) - xc[q];
          acc = fma_t(diff, diff, acc);
        }
      } else if (lane < a.n2) {
        for (int q = 0; q < a.d; ++q) {
          const T diff = __ldg(x1 + i * a.d + q) - __ldg(x2 + lane * a.d + q);
          acc = fma_t(diff, diff, acc);
        }
      }
      if (lane < a.n2) {
        T v = radial(acc, var);
        if (a.diag != nullptr && i == lane) v += dg;
        __stcs(out + i * a.n2 + lane, v);
      }
    }
  }
}

// Cross Grams of at most kColumnsMax rows (a few queries against many
// points): a thread per output column j (grid-stride over B n2), x2's row j
// in registers for d <= KD = 8 (KD = 0 reads it for each element), the rows
// of x1 in turn (broadcast loads); a warp's store covers 32 neighbouring
// columns of a row.
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads) rbf_gram_kernel_columns(const Args<T> a) {
  const int64_t cols = int64_t(a.batch) * a.n2;
  const bool narrow = cols <= INT32_MAX;
  for (int64_t c = int64_t(blockIdx.x) * kThreads + threadIdx.x; c < cols; c += int64_t(gridDim.x) * kThreads) {
    const int64_t b = narrow ? int64_t(unsigned(c) / unsigned(a.n2)) : c / a.n2;
    const T* x1 = a.x1 + b * a.n1 * a.d;
    const T* xj = a.x2 + c * a.d;  // member b's row j, j = c - b n2
    T* out = a.out + b * a.n1 * a.n2 + (c - b * a.n2);
    const T var = a.var[b * a.var_stride];
    T xc[KD > 0 ? KD : 1];
#pragma unroll
    for (int q = 0; q < KD; ++q) xc[q] = q < a.d ? __ldg(xj + q) : T(0);
    for (int i = 0; i < a.n1; ++i) {
      T acc = T(0);
      if (KD > 0) {
#pragma unroll
        for (int q = 0; q < KD; ++q) {
          if (q < a.d) {
            const T diff = __ldg(x1 + i * a.d + q) - xc[q];
            acc = fma_t(diff, diff, acc);
          }
        }
      } else {
        for (int q = 0; q < a.d; ++q) {
          const T diff = __ldg(x1 + i * a.d + q) - __ldg(xj + q);
          acc = fma_t(diff, diff, acc);
        }
      }
      __stcs(out + int64_t(i) * a.n2, radial(acc, var));
    }
  }
}

// n2 = 1: a thread per output row (grid-stride), out[b, i, 0] at b * n1 + i.
template <typename T>
__global__ void __launch_bounds__(kThreads) rbf_gram_kernel_rows(const Args<T> a) {
  const int64_t rows = int64_t(a.batch) * a.n1;
  const bool narrow = rows <= INT32_MAX;
  for (int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x; r < rows; r += int64_t(gridDim.x) * kThreads) {
    const int64_t b = narrow ? int64_t(unsigned(r) / unsigned(a.n1)) : r / a.n1;
    const T* xi = a.x1 + r * a.d;
    const T* xj = a.x2 + b * a.d;
    T acc = T(0);
    for (int q = 0; q < a.d; ++q) {
      const T diff = __ldg(xi + q) - __ldg(xj + q);
      acc = fma_t(diff, diff, acc);
    }
    T v = radial(acc, a.var[b * a.var_stride]);
    if (a.diag != nullptr && r == b * a.n1) v += a.diag[b * a.diag_stride];  // symmetric: n1 = n2 = 1
    __stcs(a.out + r, v);
  }
}

template <typename K>
cudaError_t resident_grid(K kernel, int smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  *grid = sms * per_sm;
  return err;
}

template <typename T, int TM, bool kVecStore, bool kHalf>
cudaError_t tiles_grid(int* grid) {
  return resident_grid(rbf_gram_kernel_tiles<T, TM, kVecStore, kHalf>, tile_smem_bytes<T, TM>(kHalf), grid);
}

// The smaller of two instances' resident grids (a mapping's row tiles).
template <typename T, bool kVecStore>
cudaError_t cross_grid(int* grid) {
  cudaError_t err = tiles_grid<T, 64, kVecStore, false>(grid);
  if constexpr (sizeof(T) == 4) {
    int other = 0;
    if (err == cudaSuccess) err = tiles_grid<T, 128, kVecStore, false>(&other);
    *grid = other < *grid ? other : *grid;
  }
  return err;
}

// The resident blocks of a mapping's main instance (a grid past them only
// queues, as for the packed kernel of d > 8).
template <typename T>
cudaError_t grid_limit(int mapping, int* grid) {
  switch (mapping) {
    case kMapTiles: return cross_grid<T, false>(grid);
    case kMapTilesVec: return cross_grid<T, true>(grid);
    case kMapHalf: return tiles_grid<T, 64, false, true>(grid);
    case kMapHalfVec: return tiles_grid<T, 64, true, true>(grid);
    case kMapPacked: return resident_grid(rbf_gram_kernel_packed<T, 8>, 0, grid);
    case kMapRows: return resident_grid(rbf_gram_kernel_rows<T>, 0, grid);
    case kMapColumns: return resident_grid(rbf_gram_kernel_columns<T, 8>, 0, grid);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int TM, bool kVecStore, bool kHalf>
void launch_tiles(const Args<T>& a, unsigned per_member, unsigned col_tiles, unsigned total, int grid,
                  cudaStream_t s) {
  rbf_gram_kernel_tiles<T, TM, kVecStore, kHalf>
      <<<grid, kThreads, tile_smem_bytes<T, TM>(kHalf), s>>>(a, per_member, col_tiles, total);
}

// A cross Gram's tiles of TM rows: 16-byte or scalar stores.
template <typename T, int TM>
void launch_cross(const Args<T>& a, int mapping, unsigned per, unsigned ct, unsigned all, int grid, cudaStream_t s) {
  if (mapping == kMapTilesVec)
    launch_tiles<T, TM, true, false>(a, per, ct, all, grid, s);
  else
    launch_tiles<T, TM, false, false>(a, per, ct, all, grid, s);
}

template <typename T>
int launch(const T* x1, const T* x2, const T* var, int64_t var_stride, const T* diag, int64_t diag_stride, T* out,
           int batch, int n1, int n2, int d, int sym, int mapping, int grid, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr int V = 16 / int(sizeof(T));
  if (batch < 1 || n1 < 1 || n2 < 1 || d < 0 || grid < 1 || n1 > kMaxRows || n2 > kMaxRows ||
      (sym && n1 != n2) || (!sym && diag != nullptr) || mapping < 0 || mapping >= kMappings)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{x1, sym ? x1 : x2, var, diag, out, var_stride, diag_stride, batch, n1, n2, d};
  if (mapping == kMapPacked) {
    if (n1 > kPackedMax || n2 > kPackedMax) return static_cast<int>(cudaErrorInvalidValue);
    if (d <= 4)
      rbf_gram_kernel_packed<T, 4><<<grid, kThreads, 0, s>>>(a);
    else if (d <= kChunk)
      rbf_gram_kernel_packed<T, 8><<<grid, kThreads, 0, s>>>(a);
    else
      rbf_gram_kernel_packed<T, 0><<<grid, kThreads, 0, s>>>(a);
  } else if (mapping == kMapRows) {
    if (n2 != 1) return static_cast<int>(cudaErrorInvalidValue);
    rbf_gram_kernel_rows<T><<<grid, kThreads, 0, s>>>(a);
  } else if (mapping == kMapColumns) {
    if (n1 > kColumnsMax || sym) return static_cast<int>(cudaErrorInvalidValue);
    if (d <= kChunk)
      rbf_gram_kernel_columns<T, 8><<<grid, kThreads, 0, s>>>(a);
    else
      rbf_gram_kernel_columns<T, 0><<<grid, kThreads, 0, s>>>(a);
  } else {
    const bool half = mapping == kMapHalf || mapping == kMapHalfVec;
    const bool vec = mapping == kMapTilesVec || mapping == kMapHalfVec;
    if (half != (sym != 0) || (vec && (n2 % V != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    const int tm = row_tile(int(sizeof(T)), half, n1);
    const int rt = (n1 + tm - 1) / tm, ct = (n2 + kCols - 1) / kCols;
    const int64_t per_member = half ? int64_t(rt) * (rt + 1) / 2 : int64_t(rt) * ct;
    const int64_t total = per_member * batch;
    if (total > kMaxTiles) return static_cast<int>(cudaErrorInvalidConfiguration);
    const auto per = static_cast<unsigned>(per_member), all = static_cast<unsigned>(total);
    if (half)
      vec ? launch_tiles<T, 64, true, true>(a, per, ct, all, grid, s)
          : launch_tiles<T, 64, false, true>(a, per, ct, all, grid, s);
    else if constexpr (sizeof(T) == 4)
      tm == 128 ? launch_cross<T, 128>(a, mapping, per, ct, all, grid, s)
                : launch_cross<T, 64>(a, mapping, per, ct, all, grid, s);
    else
      launch_cross<T, 64>(a, mapping, per, ct, all, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch of ``mapping`` over ``grid`` blocks (ops/gram.py:plan).
int rbf_gram_f32(const float* x1, const float* x2, const float* var, long long var_stride, const float* diag,
                 long long diag_stride, float* out, int batch, int n1, int n2, int d, int sym, int mapping, int grid,
                 void* stream) {
  return launch<float>(x1, x2, var, var_stride, diag, diag_stride, out, batch, n1, n2, d, sym, mapping, grid,
                       stream);
}

int rbf_gram_f64(const double* x1, const double* x2, const double* var, long long var_stride, const double* diag,
                 long long diag_stride, double* out, int batch, int n1, int n2, int d, int sym, int mapping, int grid,
                 void* stream) {
  return launch<double>(x1, x2, var, var_stride, diag, diag_stride, out, batch, n1, n2, d, sym, mapping, grid,
                        stream);
}

// Blocks of ``mapping`` resident on the current device at once (SMs x
// blocks an SM), for float64 when ``f64``: the largest grid plan() asks
// for.  A CUDA error code, negated, on failure.
int rbf_gram_grid_limit(int f64, int mapping) {
  int grid = 0;
  const cudaError_t err = f64 ? grid_limit<double>(mapping, &grid) : grid_limit<float>(mapping, &grid);
  return err == cudaSuccess ? grid : -static_cast<int>(err);
}

const char* rbf_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows (n1 or n2) one launch takes.
int rbf_gram_max_rows() { return kMaxRows; }

}  // extern "C"
