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
// would make about seven passes over n^2 data; this kernel reads Kinv once
// and writes nothing n^2-sized.
//
// What bounds it.  Two limits of about the same size.  The read of Kinv:
// n^2 elements, 4.29 GB in float32 at n = 32768, 1.28 ms at 3.35 TB/s.  And
// the issue rate: a pair (i, j) costs about 29 float32 instructions at d = 8
// (d differences and d fused multiply-adds for r2, one for W, two for the
// exp, three for W*E and the row sum, d fused multiply-adds for MX), 1.07e9
// pairs in about 0.95 ms at 132 SMs x 128 lanes x 1.98 GHz.  Both have to run
// near their rate at once, so the design keeps many bytes in flight and
// spends few instructions on anything but the pair arithmetic.
//
// Design.
//  * A block of 256 threads (8 warps) owns a strip of RS = 8 * R rows and
//    walks all its columns in tiles of C = 32 * CPT columns, CPT = 16 bytes
//    of the type (4 in float32, 2 in float64); one block per strip.  (A
//    persistent grid that walked the strips measured slower: PERF.md.)
//  * A ring of kStages tiles in dynamic shared memory is filled with
//    cp.async: each stage holds the strip's Kinv tile (RS x C) and the
//    tile's columns of xs and A, both transposed and zero-padded to n_pad (a
//    multiple of C) by a small first kernel.  Rows of Kinv go by 16-byte
//    copies when n * itemsize and the base are 16-byte aligned, else by one
//    copy per element; columns and rows beyond n are zero-filled by the
//    copy's source size.  Each thread copies the Kinv values it computes
//    with, so only the xs and A columns are shared between warps.  One
//    __syncthreads per stage: after it every copy of the stage has landed
//    and every thread is done with the stage the next copies overwrite.  The
//    copies' addresses advance by C per stage: no division, no index
//    arithmetic beyond an add.
//  * Register micro-tiles: warp w owns R rows of the strip, lane l the CPT
//    consecutive columns l*CPT.., so each thread computes R x CPT pairs per
//    stage from one 16-byte shared load per row of Kinv and one per
//    coordinate of xs (read twice: for r2, then for MX).  The strip's xs
//    rows live in registers.  Coordinates beyond d, rows and columns beyond n
//    are zeros: they contribute W = 0 and need no branch.
//  * dy = 1 (one output, the common case) is a compile-time case with the
//    strip's A values in registers; dy > 1 loops over A's columns at run
//    time, the strip's A rows in shared memory.
//  * r2 comes from direct differences, as in rbf_gram.cu: an exact 0 on the
//    diagonal, which matern12's E mask (r2 > floor) relies on.
//  * The maps are computed with var = 1 (G, E and F are linear in var) and
//    the outputs scaled by var once.  In float32 exp(c x) is the hardware's
//    ex2.approx.ftz of x c log2(e), the constant folded: two instructions;
//    log, square root and reciprocal are the approx.ftz instructions too.
//    For rbf, G = E, so svar's terms are those of the row sums.
//  * rowsum and MX accumulate in registers per thread and are reduced across
//    the warp once per strip: each row is owned by one block, so there is no
//    cross-block reduction.  svar and sextra are summed per stage (a
//    thread's R x CPT terms) in the working type, then in double per thread,
//    per strip (fixed order), and over strips by a one-block kernel in a
//    fixed order.  No float atomics: a gradient is the same from run to run.
//
// Plain C interface, loaded with ctypes.  The entry point launches its three
// kernels on the given stream, does not synchronise, allocates nothing (the
// caller passes radial_contract_workspace_bytes of scratch), and returns
// the first CUDA error.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radial_maps.cuh"

namespace {

using namespace radial;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kMaxDy = 32;
constexpr int kMaxD = 32;
constexpr int kFinishThreads = 256;

// The tile shape for an item size and a padded feature width: columns per
// stage (a warp's 32 16-byte loads) and rows per strip (8 warps of R rows,
// R as the registers allow).
__host__ __device__ constexpr int cols_for(int itemsize) { return 32 * (16 / itemsize); }
__host__ __device__ constexpr int rows_for(int itemsize, int maxd) {
  return itemsize == 4 ? (maxd <= 8 ? 4 : (maxd <= 16 ? 2 : 1)) : (maxd <= 8 ? 2 : 1);
}
__host__ __device__ constexpr int strip_for(int itemsize, int maxd) { return kWarps * rows_for(itemsize, maxd); }
int max_d_for(int d) { return d <= 8 ? 8 : (d <= 16 ? 16 : 32); }
int64_t round_up(int64_t v, int64_t m) { return (v + m - 1) / m * m; }

// Asynchronous copies into shared memory; src_bytes < size zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes) : "memory");
}
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// xs and A transposed and zero-padded: xst (maxd, npad), at (dy, npad).
template <typename T>
__global__ void __launch_bounds__(kThreads)
pad_kernel(const T* __restrict__ xs, const T* __restrict__ a, T* __restrict__ xst, T* __restrict__ at,
           int n, int npad, int d, int maxd, int dy) {
  const int64_t total = int64_t(maxd + dy) * npad;
  for (int64_t e = blockIdx.x * int64_t(kThreads) + threadIdx.x; e < total; e += int64_t(gridDim.x) * kThreads) {
    const int q = static_cast<int>(e / npad), j = static_cast<int>(e % npad);
    if (q < maxd) {
      xst[e] = (j < n && q < d) ? xs[int64_t(j) * d + q] : T(0);
    } else {
      at[e - int64_t(maxd) * npad] = j < n ? a[int64_t(j) * dy + (q - maxd)] : T(0);
    }
  }
}

template <typename T, int KIND, int MAXD, bool DY1>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 && MAXD <= 8 ? 2 : 1)
contract_kernel(const T* __restrict__ kinv, const T* __restrict__ a, const T* __restrict__ xs,
                const T* __restrict__ xst, const T* __restrict__ at, const T* __restrict__ scal,
                T* __restrict__ rowsum, T* __restrict__ mx, double* __restrict__ part,
                int n, int npad, int d, int dy, int aligned) {
  constexpr int CPT = 16 / sizeof(T), C = cols_for(sizeof(T)), R = rows_for(sizeof(T), MAXD);
  constexpr int RS = strip_for(sizeof(T), MAXD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double sred[2][kWarps];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int dya = DY1 ? 1 : dy;                     // rows of A in a stage
  const int stage_elems = (RS + MAXD + dya) * C;
  T* sai = smem + kStages * stage_elems;            // (RS, kMaxDy): the strip's A rows, dy > 1

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wr = warp * R;                          // the warp's first row in the strip
  const int col = lane * CPT;                       // the lane's first column in a tile
  const int row0 = static_cast<int>(blockIdx.x) * RS;  // the block's strip
  const int tiles = npad / C;
  const T alpha = scal[1];
  const T half_ia = T(0.5) / alpha;
  const T dyf = T(dy);

  // The copy cursor: the next tile to start (its first column, its slot).
  // Each thread copies the Kinv values of its own micro-tile (R rows x CPT
  // columns) and rows warp, warp + 8, ... of the tile's xs^T and A^T.  Every
  // call commits one group, empty past the last tile.
  int i_j0 = 0, i_slot = 0;
  const T* krow = kinv + int64_t(row0 + wr) * n + col;
  auto issue = [&]() {
    if (i_j0 < npad) {
      T* base = smem + i_slot * stage_elems;
      const int c = i_j0 + col;
      const T* kp = krow + i_j0;
      if (aligned) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const bool ok = row0 + wr + r < n && c < n;
          cp_async16(base + (wr + r) * C + col, ok ? kp + int64_t(r) * n : kinv, ok ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int k = 0; k < CPT; ++k) {
            const bool ok = row0 + wr + r < n && c + k < n;
            cp_async_small<sizeof(T)>(base + (wr + r) * C + col + k, ok ? kp + int64_t(r) * n + k : kinv,
                                      ok ? int(sizeof(T)) : 0);
          }
      }
#pragma unroll
      for (int i = 0; i < MAXD / kWarps; ++i) {
        const int q = warp + i * kWarps;
        cp_async16(base + (RS + q) * C + col, xst + int64_t(q) * npad + c, 16);
      }
      for (int k = warp; k < dya; k += kWarps)
        cp_async16(base + (RS + MAXD + k) * C + col, at + int64_t(k) * npad + c, 16);
      i_slot = i_slot + 1 == kStages ? 0 : i_slot + 1;
      i_j0 += C;
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue();

  // The strip's rows into registers (and, for dy > 1, its A rows into
  // shared memory, each warp its own rows).
  T xi[R][MAXD];
  T ai[R];
  T acc_row[R];
  T acc_mx[R][MAXD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + wr + r;
    acc_row[r] = T(0);
    ai[r] = (DY1 && row < n) ? a[row] : T(0);
#pragma unroll
    for (int q = 0; q < MAXD; ++q) {
      xi[r][q] = (row < n && q < d) ? xs[int64_t(row) * d + q] : T(0);
      acc_mx[r][q] = T(0);
    }
  }
  if (!DY1) {
    for (int e = lane; e < R * kMaxDy; e += 32) {
      const int r = e / kMaxDy, k = e % kMaxDy;
      const int row = row0 + wr + r;
      sai[(wr + r) * kMaxDy + k] = (row < n && k < dy) ? a[int64_t(row) * dy + k] : T(0);
    }
    __syncwarp();
  }
  double svar = 0.0, sextra = 0.0;

  for (int jt = 0, slot = 0; jt < tiles; ++jt, slot = slot + 1 == kStages ? 0 : slot + 1) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile jt has landed; every thread is done with tile jt - 1's slot
    issue();

    const T* sk = smem + slot * stage_elems;
    const T* sx = sk + RS * C;
    const T* sa = sx + MAXD * C;

    T v[R][CPT];  // r2, then W * E
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) v[r][c] = T(0);
#pragma unroll
    for (int q = 0; q < MAXD; ++q) {
      T xj[CPT];
      lds16(xj, sx + q * C + col);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const T df = xi[r][q] - xj[c];
          v[r][c] = fma_t(df, df, v[r][c]);
        }
    }

    T a1[CPT];  // dy = 1: the tile's A values
    if (DY1) lds16(a1, sa + col);
    T ts = T(0), te = T(0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T w[CPT];  // W of the thread's pairs in row r
      lds16(w, sk + (wr + r) * C + col);
      if (DY1) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) w[c] = fma_t(-ai[r], a1[c], w[c]);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) w[c] *= dyf;
        for (int k = 0; k < dy; ++k) {
          T aj[CPT];
          lds16(aj, sa + k * C + col);
          const T aik = sai[(wr + r) * kMaxDy + k];
#pragma unroll
          for (int c = 0; c < CPT; ++c) w[c] = fma_t(-aik, aj[c], w[c]);
        }
      }
      T rs = T(0);  // rbf: the row's sum over the thread's columns of the stage
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        T G, E, F;
        maps<T, KIND>(v[r][c], alpha, half_ia, G, E, F);
        if (KIND != kRbf) ts = fma_t(w[c], G, ts);
        if (KIND == kRq) te = fma_t(w[c], F, te);
        const T m = w[c] * E;
        if (KIND == kRbf) {
          rs = c == 0 ? m : rs + m;
        } else {
          acc_row[r] += m;
        }
        v[r][c] = m;
      }
      if (KIND == kRbf) {  // G = E: svar's terms are the row sums'
        acc_row[r] += rs;
        ts += rs;
      }
    }
    svar += static_cast<double>(ts);
    if (KIND == kRq) sextra += static_cast<double>(te);

#pragma unroll
    for (int q = 0; q < MAXD; ++q) {
      T xj[CPT];
      lds16(xj, sx + q * C + col);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T s = acc_mx[r][q];
#pragma unroll
        for (int c = 0; c < CPT; ++c) s = fma_t(v[r][c], xj[c], s);
        acc_mx[r][q] = s;
      }
    }

  }
  cp_async_wait<0>();

  // The strip is done: reduce its rows across the warp and write them, and
  // its partial sums in a fixed order.
  const T var = scal[0];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + wr + r;
    const T rs = warp_sum(acc_row[r]);
    if (lane == 0 && row < n) rowsum[row] = var * rs;
#pragma unroll
    for (int q = 0; q < MAXD; ++q) {
      const T s = warp_sum(acc_mx[r][q]);
      if (lane == 0 && row < n && q < d) mx[int64_t(row) * d + q] = var * s;
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
    for (int i = 0; i < kWarps; ++i) {
      s += sred[0][i];
      x += sred[1][i];
    }
    part[2 * blockIdx.x] = s;
    part[2 * blockIdx.x + 1] = x;
  }
}

// Second pass: the per-strip partials of svar and sextra, summed in a fixed
// order by one block and scaled by var, written as out[0], out[1].
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const double* __restrict__ part, int nparts, const T* __restrict__ scal, T* __restrict__ out) {
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
    const double var = static_cast<double>(scal[0]);
    out[0] = static_cast<T>(var * s[0][0]);
    out[1] = static_cast<T>(var * s[1][0]);
  }
}

// The workspace: per-strip partials (2 doubles each), then xs^T (maxd, npad)
// and A^T (dy, npad) in the working type.
struct Layout {
  int maxd, npad, nstrips;
  int64_t part_bytes, xst_bytes, at_bytes;
};

Layout layout(int n, int d, int dy, int itemsize) {
  Layout l;
  l.maxd = max_d_for(d);
  l.npad = static_cast<int>(round_up(n, cols_for(itemsize)));
  l.nstrips = (n + strip_for(itemsize, l.maxd) - 1) / strip_for(itemsize, l.maxd);
  l.part_bytes = round_up(int64_t(2) * l.nstrips * sizeof(double), 256);
  l.xst_bytes = round_up(int64_t(l.maxd) * l.npad * itemsize, 256);
  l.at_bytes = round_up(int64_t(dy) * l.npad * itemsize, 256);
  return l;
}

// A launch's operands: the caller's, the workspace's and the shape.
template <typename T>
struct Args {
  const T *kinv, *a, *xs, *scal;
  T *rowsum, *mx, *out;
  double* part;
  T *xst, *at;
  int n, d, dy, kind;
  Layout l;
};

template <typename T, int KIND, int MAXD, bool DY1>
cudaError_t launch_kind(const Args<T>& p, cudaStream_t s) {
  auto kernel = contract_kernel<T, KIND, MAXD, DY1>;
  constexpr int RS = strip_for(sizeof(T), MAXD);
  const size_t smem = sizeof(T) * (size_t(kStages) * (RS + MAXD + (DY1 ? 1 : p.dy)) * cols_for(sizeof(T)) +
                                   (DY1 ? 0 : size_t(RS) * kMaxDy));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int aligned = (p.n * int(sizeof(T))) % 16 == 0 && reinterpret_cast<uintptr_t>(p.kinv) % 16 == 0;
  kernel<<<p.l.nstrips, kThreads, smem, s>>>(p.kinv, p.a, p.xs, p.xst, p.at, p.scal, p.rowsum, p.mx, p.part, p.n,
                                             p.l.npad, p.d, p.dy, aligned);
  return cudaGetLastError();
}

template <typename T, int MAXD, bool DY1>
cudaError_t launch_dy(const Args<T>& p, cudaStream_t s) {
  switch (p.kind) {
    case kRbf: return launch_kind<T, kRbf, MAXD, DY1>(p, s);
    case kMatern12: return launch_kind<T, kMatern12, MAXD, DY1>(p, s);
    case kMatern32: return launch_kind<T, kMatern32, MAXD, DY1>(p, s);
    case kMatern52: return launch_kind<T, kMatern52, MAXD, DY1>(p, s);
    default: return launch_kind<T, kRq, MAXD, DY1>(p, s);
  }
}

template <typename T, int MAXD>
cudaError_t launch_width(const Args<T>& p, cudaStream_t s) {
  return p.dy == 1 ? launch_dy<T, MAXD, true>(p, s) : launch_dy<T, MAXD, false>(p, s);
}

template <typename T>
int launch(const T* kinv, const T* a, const T* xs, const T* scal, T* rowsum, T* mx, void* work, T* out,
           int n, int d, int dy, int kind, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxD || dy <= 0 || dy > kMaxDy || kind < 0 || kind > kRq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(n, d, dy, sizeof(T));
  char* w = static_cast<char*>(work);
  const Args<T> p{kinv, a, xs, scal, rowsum, mx, out, reinterpret_cast<double*>(w),
                  reinterpret_cast<T*>(w + l.part_bytes), reinterpret_cast<T*>(w + l.part_bytes + l.xst_bytes),
                  n, d, dy, kind, l};
  const int64_t pad_blocks = (int64_t(l.maxd + dy) * l.npad + kThreads - 1) / kThreads;
  pad_kernel<T><<<int(pad_blocks < 1024 ? pad_blocks : 1024), kThreads, 0, s>>>(xs, a, p.xst, p.at, n, l.npad, d,
                                                                                l.maxd, dy);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (l.maxd) {
    case 8: err = launch_width<T, 8>(p, s); break;
    case 16: err = launch_width<T, 16>(p, s); break;
    default: err = launch_width<T, 32>(p, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_kernel<T><<<1, kFinishThreads, 0, s>>>(p.part, l.nstrips, scal, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kinv (n, n), a (n, dy), xs (n, d), scal = [var, alpha] on the device;
// writes rowsum (n,), mx (n, d), out = [svar, sextra]; work is scratch of
// radial_contract_workspace_bytes(n, d, dy, itemsize) bytes, 16-byte aligned.
int radial_contract_f32(const float* kinv, const float* a, const float* xs, const float* scal, float* rowsum,
                        float* mx, void* work, float* out, int n, int d, int dy, int kind, void* stream) {
  return launch<float>(kinv, a, xs, scal, rowsum, mx, work, out, n, d, dy, kind, stream);
}

int radial_contract_f64(const double* kinv, const double* a, const double* xs, const double* scal,
                        double* rowsum, double* mx, void* work, double* out, int n, int d, int dy, int kind,
                        void* stream) {
  return launch<double>(kinv, a, xs, scal, rowsum, mx, work, out, n, d, dy, kind, stream);
}

int64_t radial_contract_workspace_bytes(int n, int d, int dy, int itemsize) {
  if (n <= 0 || d <= 0 || d > kMaxD || dy <= 0 || dy > kMaxDy || (itemsize != 4 && itemsize != 8)) return -1;
  const Layout l = layout(n, d, dy, itemsize);
  return l.part_bytes + l.xst_bytes + l.at_bytes;
}

int radial_contract_max_d() { return kMaxD; }

int radial_contract_max_dy() { return kMaxDy; }

const char* radial_contract_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
