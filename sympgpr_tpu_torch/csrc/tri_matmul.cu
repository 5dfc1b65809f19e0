// Matrix products with a lower-triangular operand on Hopper (sm_90a): the
// batched triangular matmuls of the blocked triangular inverse and the syrk
// S = W^T W that forms Ky^{-1} from W = L^{-1}.
//
// Replaces two Pallas kernels:
//  * sympgpr_tpu/ops/pallas_trimm.py:40 _trimm_tile (batched A @ L and
//    L @ A, L lower) -> trimm_kernel<kRight> / <kLeft>;
//  * sympgpr_tpu/ops/pallas_syrk.py:33 _syrk_tile (W^T W, W lower)
//    -> tri_gemm_kernel<kSyrk>.
// The plain PyTorch versions are torch.tril(L) followed by torch.matmul
// (ops/cuda_trimm.py) and W.T @ W (ops/cuda_syrk.py).
//
// What bounds them: arithmetic.  A (64 x 64) output tile reads 2 x 16 x 64
// values per 16-deep k step and does 64 x 64 x 16 multiply-adds from them,
// 32 multiply-adds per value loaded from device memory, so the float32 (or
// float64) FMA pipes and the shared-memory reads that feed them set the
// time, not HBM.  The structural zeros are what the design saves: the triangular
// product needs half of a dense product's multiply-adds, the syrk a sixth.
//
// trimm_kernel (the triangular matmuls).  The first version was
// tri_gemm_kernel below in its kRight / kLeft modes; on an H100 it ran the
// 8 products of one n = 8192 inverse at 17.8 TFLOP/s against cuBLAS's 48.6
// on the dense products: 4 x 4 outputs per thread (2 FMAs per value read
// from shared memory), one stage with every load waiting on the FMAs, a
// 16-way bank conflict on the transposing A store, masks on every element.
// Those branches stay in that template, which the syrk shares, unused.
//  * Tile: 128 x 128 outputs per block of 256 threads (float32), 8 x 8 per
//    thread as 2 x 2 sub-tiles of 4 x 4.  Per 4 k-steps a thread reads its
//    8 A rows (one LDS.128 of 4 k each) and 4 x 2 B vectors, 16 LDS.128 =
//    64 values for 256 FMAs: 4 FMAs per value, so the FMA pipe and not
//    shared memory is the limit.  float64 runs the same code on 16-byte
//    vectors of 2: a 64 x 64 tile, 4 x 4 per thread.  One tile size for all
//    levels: at n = 8192 the two small levels (s = 512, 1024), where
//    128 x 128 fills fewer SMs, hold 6 % of the multiply-adds and ~10 % of
//    the time, so a 128 x 64 variant was not worth a second instance.
//  * Pipeline: k staged 32 deep (float32; 16 for float64), 2 stages of
//    dynamic shared memory (64 KB float32), one barrier per stage: the
//    copies of stage k+1 are issued right after the barrier and land while
//    stage k's FMAs run.  On an H100 16-deep stages ran 4-8 % slower, and a
//    third stage bought nothing at either depth.  Copies are cp.async
//    (16-byte .cg, async_copy.cuh) rather than TMA: the operands are strided
//    views whose triangle and ragged edge need zero fill, which cp.async's
//    src-size gives per chunk for any leading dimension, and a host build
//    can put a synchronous copy in its place; TMA would need a tensor map
//    per view built on the host for every call and a second pass for the
//    triangle.
//  * Registers: 168 a thread, one block per SM (8 warps).  Capped at 128
//    for two blocks per SM, ptxas spills and the products ran 3-10 %
//    slower, with either fragment order.
//  * Layout: both operands land in shared memory as they lie in device
//    memory, A row-major (k contiguous), B row-major (n contiguous), so
//    every copy is a 16-byte cp.async and nothing is transposed on the way.
//    A k-major A tile would cost 4-byte copies (or a trip through
//    registers) for A; here a thread instead reads an A fragment along k
//    (4 k-steps of one row per LDS.128) and holds 32 A values, which the
//    register budget of one block per SM affords.  A's 16-byte k-chunks are
//    XOR-swizzled by row group (slot q ^ (m / 4 % 8)), so the 4 rows a warp
//    reads at once fall on distinct banks, and every row a thread reads has
//    the same swizzle (one address per k-chunk, the rest immediates); a
//    quarter-warp reads 8 consecutive B vectors.  Reads and copies are
//    conflict-free.
//  * Masks only where they bite: a k-tile wholly inside the matrix and on
//    the stored side of the triangular operand's diagonal is copied with
//    unmasked 16-byte copies.  Only the k-tiles that straddle the diagonal
//    (the first 4 of a kRight tile, the last 4 of a kLeft tile) and those
//    at the ragged edge are masked, and there by element: the readable part
//    of a 4-element chunk of a row is a prefix (columns c <= r on and below
//    the diagonal, c < s inside the matrix), so one zero-filling copy of
//    that prefix reads no element above the diagonal or outside the matrix.
//    Operands whose rows are not 16-byte aligned (a leading dimension or
//    batch stride off a multiple of 4 floats, or a misaligned view) take
//    one copy per element everywhere (instance VEC = false).
//  * Heaviest tiles first: the 1-D grid is decoded so that the tiles with
//    the longest k-range run first (kRight: k >= col0, column tile 0 first;
//    kLeft: k < row0 + 128, the last row tile first), and the last wave
//    holds the shortest.  The structural k-skip is as before.
//  * Strided operands: each has a leading dimension and a batch stride, so
//    the blocked inverse passes views of its buffers, and a sign of +1 or
//    -1 (exact) is applied in the epilogue.
//  * Plain IEEE float32 FMAs accumulated in float32; no TF32, no fast math.
//
// tri_gemm_kernel (now the syrk only; first version, no wgmma or TMA):
//  * A classic shared-memory tiled GEMM: 64 x 64 output tile per block of
//    256 threads, each thread a 4 x 4 register tile, k in steps of 16
//    staged in shared memory.  Plain IEEE FMAs in float32 or float64; never
//    TF32 (a reduced-precision product turned real GP Choleskys into NaN,
//    docs/DESIGN.md section 3).
//  * The syrk accumulates float32 input in float64 (inputs converted,
//    DFMA, result rounded to float32 once).  S = Ky^{-1} feeds the trace
//    term of the NLL gradient, a sum over all (2N)^2 entries.  With this
//    kernel accumulating in float32 (one accumulator per output over k up
//    to 8192) the Adam fit at N = 4096 went NaN after ~30 steps and
//    escalated its jitter from 1e-2 to 1e-1 on an H100; with float64
//    accumulation it stays at 1e-2.  cuBLAS's float32 W.T @ W in its place
//    also stays at 1e-2 (another order of summation), so a float32
//    accumulation as accurate as cuBLAS's may suffice; not tried.  The
//    triangular matmuls keep float32 accumulation: W = L^{-1} from them is
//    within 4e-6 of float64 there.
//  * k-ranges skip the structural zeros: for C = A L tile column j0 only
//    accumulates k >= j0; for C = L A tile row i0 only k < i0 + 64; the syrk
//    tile (i, j), j <= i, only k >= i0.
//  * Every load of the triangular operand is masked by element (row >= col)
//    inside the tile, so no element above its diagonal is ever read: the
//    upper triangle may hold anything, NaN included.
//  * The syrk grid covers only the lower tile pairs (one block per pair, a
//    1-D grid decoded to (i, j)); each block writes its tile and the
//    mirrored upper tile, and a diagonal tile writes each element once.
//  * The ragged edge (n not a multiple of 64) is masked in the kernel.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {

constexpr int kBM = 64;  // output tile rows
constexpr int kBN = 64;  // output tile columns
constexpr int kBK = 16;  // k depth staged per step
constexpr int kTM = 4;   // rows per thread
constexpr int kTN = 4;   // columns per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);

constexpr int kRight = 0;  // C = A @ tril(B)
constexpr int kLeft = 1;   // C = tril(A) @ B
constexpr int kSyrk = 2;   // C = tril(A)^T @ tril(A), B == A

// accumulator type: float64 for the syrk, the data's type otherwise
template <typename T, int MODE>
using Acc = std::conditional_t<MODE == kSyrk, double, T>;

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    tri_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    T* __restrict__ C, int n, size_t batch_stride) {
  __shared__ T As[kBK][kBM];  // As[kk][m] = Aop[row0 + m][k0 + kk]
  __shared__ T Bs[kBK][kBN];  // Bs[kk][c] = Bop[k0 + kk][col0 + c]

  int bi, bj;
  if constexpr (MODE == kSyrk) {
    // lower tile pairs t = bi (bi + 1) / 2 + bj, bj <= bi
    const int t = blockIdx.x;
    bi = int((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
    while (bi * (bi + 1) / 2 > t) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
    bj = t - bi * (bi + 1) / 2;
  } else {
    bi = blockIdx.y;
    bj = blockIdx.x;
  }
  const size_t off = size_t(blockIdx.z) * batch_stride;
  A += off;
  B += off;
  C += off;
  const int row0 = bi * kBM, col0 = bj * kBN;
  int kbeg = 0, kend = n;
  if constexpr (MODE == kRight) kbeg = col0;
  if constexpr (MODE == kLeft) kend = min(n, row0 + kBM);
  if constexpr (MODE == kSyrk) kbeg = row0;

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  using A_t = Acc<T, MODE>;
  A_t acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[m][c] = A_t(0);

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      int m, kk;
      T v = T(0);
      if constexpr (MODE == kSyrk) {
        // Aop[m][kk] = W[k0 + kk][row0 + m]: coalesced along m
        m = e % kBM;
        kk = e / kBM;
        const int r = k0 + kk, c = row0 + m;
        if (r < n && c < n && r >= c) v = A[size_t(r) * n + c];
      } else {
        kk = e % kBK;
        m = e / kBK;
        const int r = row0 + m, c = k0 + kk;
        const bool tri = MODE == kLeft;  // Aop = tril(L)
        if (r < n && c < n && (!tri || r >= c)) v = A[size_t(r) * n + c];
      }
      As[kk][m] = v;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int c = e % kBN, kk = e / kBN;
      const int r = k0 + kk, cc = col0 + c;
      const bool tri = MODE != kLeft;  // Bop = tril(L) or tril(W)
      T v = T(0);
      if (r < n && cc < n && (!tri || r >= cc)) v = B[size_t(r) * n + cc];
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      A_t a[kTM], b[kTN];
#pragma unroll
      for (int m = 0; m < kTM; ++m) a[m] = A_t(As[kk][ty * kTM + m]);
#pragma unroll
      for (int c = 0; c < kTN; ++c) b[c] = A_t(Bs[kk][tx * kTN + c]);
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[m][c] = fma(a[m], b[c], acc[m][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int r = row0 + ty * kTM + m;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int cc = col0 + tx * kTN + c;
      if (r >= n || cc >= n) continue;
      const T v = T(acc[m][c]);
      if constexpr (MODE == kSyrk) {
        if (bi != bj || r >= cc) C[size_t(r) * n + cc] = v;
        if (bi != bj || r > cc) C[size_t(cc) * n + r] = v;  // mirror
      } else {
        C[size_t(r) * n + cc] = v;
      }
    }
  }
}

// --- trimm_kernel ---------------------------------------------------------

// Tile shape for one element type.  V elements make a 16-byte vector (4
// float32, 2 float64); each of the 16 x 16 threads holds 2 x 2 sub-tiles of
// V x V outputs, so the block tile is 32 V square, and a stage is 8 V deep:
// an A row of a stage is eight 16-byte chunks.
template <typename T>
struct TrimmTile {
  static constexpr int V = 16 / int(sizeof(T));
  static constexpr int TM = 2 * V;    // outputs per thread along each axis
  static constexpr int BM = 16 * TM;  // block tile, rows and columns
  static constexpr int BK = 8 * V;    // k depth of a stage
  static constexpr int Q = BK / V;    // 16-byte chunks of an A row
  static constexpr int STAGES = 2;
  static constexpr int STAGE = 2 * BM * BK;  // elements of one stage, A and B
  static constexpr int SMEM = STAGES * STAGE * int(sizeof(T));  // bytes
};
constexpr int kTrimmThreads = 256;

template <typename T>
struct TrimmArgs {
  const T* A;
  const T* B;
  T* C;
  long long lda, ldb, ldc;  // row strides, in elements
  long long sa, sb, sc;     // batch strides, in elements
  int s, nb, nt;            // size, batch, tiles per side
  T sign;                   // +1 or -1
};

__device__ __forceinline__ void ld16(float (&r)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
  r[3] = v.w;
}

__device__ __forceinline__ void ld16(double (&r)[2], const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  r[0] = v.x;
  r[1] = v.y;
}

__device__ __forceinline__ void st16(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}

__device__ __forceinline__ void st16(double* p, const double (&r)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(r[0], r[1]);
}

// Offset in a stage of A's 16-byte k-chunk q of tile row m (m >= 0): the
// chunk index is XORed with the row group m / V.
template <typename T>
__device__ __forceinline__ int a_slot(int m, int q) {
  using G = TrimmTile<T>;
  return m * G::BK + ((q ^ (unsigned(m) / G::V % G::Q)) * G::V);
}

// A chunk of V elements of which only the first n may be read (n clamped
// to 0..V); the rest of dst is zero-filled.  safe is any readable element.
template <typename T, bool VEC>
__device__ __forceinline__ void copy_prefix(T* dst, const T* src,
                                            const T* safe, int n) {
  constexpr int V = TrimmTile<T>::V, E = int(sizeof(T));
  n = max(0, min(V, n));
  if constexpr (VEC) {
    cp_async<16>(dst, n > 0 ? src : safe, n * E);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      cp_async<E>(dst + j, j < n ? src + j : safe, j < n ? E : 0);
  }
}

// One thread's share of a stage's copies, fixed for the block: CH 16-byte
// chunks of each operand tile, all at the same k-chunk of A rows ASTEP apart
// and the same columns of B rows BSTEP apart (so one source, one slot and
// one row per operand, the rest strides); a stage at k0 adds k0.
template <typename T, int MODE, bool VEC>
struct TrimmCopies {
  using G = TrimmTile<T>;
  static constexpr int CH = G::BM * G::BK / G::V / kTrimmThreads;
  static constexpr int ASTEP = kTrimmThreads / G::Q;
  static constexpr int BSTEP = kTrimmThreads / (G::BM / G::V);
  static_assert(CH * kTrimmThreads * G::V == G::BM * G::BK, "chunks");
  static_assert(kTrimmThreads % G::Q == 0 && ASTEP % (G::V * G::Q) == 0,
                "a thread's A chunks share the row group's swizzle");
  static_assert(kTrimmThreads % (G::BM / G::V) == 0, "B chunks");
  const T* a_src;  // A[a_row][a_k]
  const T* b_src;  // B[b_kk][b_col]
  long long a_step, b_step;  // ASTEP rows of A, BSTEP rows of B
  int a_dst, b_dst, a_row, a_k, b_kk, b_col;

  __device__ __forceinline__ TrimmCopies(const T* A, long long lda,
                                         const T* B, long long ldb,
                                         int row0, int col0) {
    const int e = int(threadIdx.x);
    const int m = e / G::Q, q = e % G::Q;
    a_row = row0 + m;
    a_k = q * G::V;
    a_src = A + a_row * lda + a_k;
    a_step = ASTEP * lda;
    a_dst = a_slot<T>(m, q);
    const int kk = e / (G::BM / G::V), c = e % (G::BM / G::V);
    b_kk = kk;
    b_col = col0 + c * G::V;
    b_src = B + kk * ldb + b_col;
    b_step = BSTEP * ldb;
    b_dst = G::BM * G::BK + kk * G::BM + c * G::V;
  }

  // Issue the copies of the k-tile at k0 into stage st.  Only where a mask
  // bites (the ragged edge, and the k-tile that straddles the triangular
  // operand's diagonal) is a chunk cut to its readable prefix.
  __device__ __forceinline__ void issue(T* st, const T* A, const T* B,
                                        long long ldb, int s, int row0,
                                        int col0, int k0) const {
    constexpr int BM = G::BM, BK = G::BK;
    const bool a_full = VEC && row0 + BM <= s && k0 + BK <= s &&
                        (MODE != kLeft || k0 + BK - 1 <= row0);
    const bool b_full = VEC && col0 + BM <= s && k0 + BK <= s &&
                        (MODE != kRight || col0 + BM - 1 <= k0);
    const T* asrc = a_src + k0;
    const T* bsrc = b_src + k0 * ldb;
    if (a_full) {
#pragma unroll
      for (int i = 0; i < CH; ++i)
        cp_async<16>(st + a_dst + i * ASTEP * BK, asrc + i * a_step, 16);
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int r = a_row + i * ASTEP;
        const int lim = r >= s ? 0 : MODE == kLeft ? min(s, r + 1) : s;
        copy_prefix<T, VEC>(st + a_dst + i * ASTEP * BK, asrc + i * a_step,
                            A, lim - k0 - a_k);
      }
    }
    if (b_full) {
#pragma unroll
      for (int i = 0; i < CH; ++i)
        cp_async<16>(st + b_dst + i * BSTEP * BM, bsrc + i * b_step, 16);
    } else {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int r = k0 + b_kk + i * BSTEP;
        const int lim = r >= s ? 0 : MODE == kRight ? min(s, r + 1) : s;
        copy_prefix<T, VEC>(st + b_dst + i * BSTEP * BM, bsrc + i * b_step,
                            B, lim - b_col);
      }
    }
  }
};

// C = sign * (A @ tril(B)) (kRight) or sign * (tril(A) @ B) (kLeft), one
// output tile per block.  VEC: every operand's rows are 16-byte aligned.
template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(kTrimmThreads, 1)
    trimm_kernel(const TrimmArgs<T> p) {
  using G = TrimmTile<T>;
  constexpr int V = G::V, TM = G::TM, BM = G::BM, BK = G::BK;
  constexpr int S = G::STAGES;
  // stage st: A tile rows (k-chunks at a_slot), then Bs[k][n]
  extern __shared__ float4 trimm_smem[];
  T* const smem = reinterpret_cast<T*>(trimm_smem);

  // heaviest tiles first, batch by batch within each k-range
  const int t = int(blockIdx.x), per = p.nt * p.nb;
  const int heavy = t / per, b = t % per / p.nt, light = t % p.nt;
  const int bi = MODE == kRight ? light : p.nt - 1 - heavy;
  const int bj = MODE == kRight ? heavy : light;
  const T* A = p.A + b * p.sa;
  const T* B = p.B + b * p.sb;
  T* C = p.C + b * p.sc;
  const int row0 = bi * BM, col0 = bj * BM;
  const int kbeg = MODE == kRight ? col0 : 0;
  const int kend = MODE == kRight ? p.s : min(p.s, row0 + BM);
  const int ntiles = (kend - kbeg + BK - 1) / BK;
  const TrimmCopies<T, MODE, VEC> cp(A, p.lda, B, p.ldb, row0, col0);

  // 16 x 16 threads; a warp covers 4 thread rows of 8 thread columns
  const int warp = int(threadIdx.x) / 32, lane = int(threadIdx.x) % 32;
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const int sw = ty % G::Q;
  static_assert(BM / 2 / V % G::Q == 0, "row groups ty and ty + BM / 2V");

  T acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[i][c] = T(0);

#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < ntiles)
      cp.issue(smem + st * G::STAGE, A, B, p.ldb, p.s, row0, col0,
               kbeg + st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<S - 2>();  // this thread's copies of k-tile kt are in
    __syncthreads();         // everyone's are; stage (kt - 1) % S is free
    const int next = kt + S - 1;
    if (next < ntiles)
      cp.issue(smem + (next % S) * G::STAGE, A, B, p.ldb, p.s, row0, col0,
               kbeg + next * BK);
    cp_async_commit();
    const T* as = smem + (kt % S) * G::STAGE;
    const T* bs = as + BM * BK;
#pragma unroll
    for (int q = 0; q < BK / V; ++q) {
      // the thread's rows ty V + i and BM / 2 + ty V + i share the row
      // group's swizzle, ty % Q: one address per q, the rest immediates
      const T* arow = as + ty * V * BK + ((q ^ sw) * V);
      T a[TM][V];  // the thread's TM rows at k = q V ... q V + V - 1
#pragma unroll
      for (int i = 0; i < TM; ++i)
        ld16(a[i], arow + ((i / V) * (BM / 2) + i % V) * BK);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T* brow = bs + (q * V + j) * BM + tx * V;
        T bv[2][V];
        ld16(bv[0], brow);
        ld16(bv[1], brow + BM / 2);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < TM; ++c)
            acc[i][c] = fma(a[i][j], bv[c / V][c % V], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i / V) * (BM / 2) + ty * V + i % V;
    if (r >= p.s) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = col0 + h * (BM / 2) + tx * V;
      T v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = p.sign * acc[i][h * V + j];
      T* dst = C + r * p.ldc + c0;
      if (VEC && c0 + V <= p.s) {
        st16(dst, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (c0 + j < p.s) dst[j] = v[j];
      }
    }
  }
}

template <typename T, int MODE, bool VEC>
cudaError_t trimm_launch(const TrimmArgs<T>& p, cudaStream_t st) {
  constexpr int smem = TrimmTile<T>::SMEM;
  auto kern = trimm_kernel<T, MODE, VEC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = unsigned(p.nt) * unsigned(p.nt) * unsigned(p.nb);
  kern<<<blocks, kTrimmThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
int trimm(const T* A, long long lda, long long sa, const T* B, long long ldb,
          long long sb, T* C, long long ldc, long long sc, int nb, int s,
          int right, int sign, void* stream) {
  constexpr int V = TrimmTile<T>::V, BM = TrimmTile<T>::BM;
  const TrimmArgs<T> p{A, B, C, lda, ldb, ldc, sa, sb, sc,
                       s, nb, (s + BM - 1) / BM, T(sign)};
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const bool vec = aligned(A) && aligned(B) && aligned(C) && lda % V == 0 &&
                   ldb % V == 0 && ldc % V == 0 && sa % V == 0 &&
                   sb % V == 0 && sc % V == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (right)
    return int(vec ? trimm_launch<T, kRight, true>(p, st)
                   : trimm_launch<T, kRight, false>(p, st));
  return int(vec ? trimm_launch<T, kLeft, true>(p, st)
                 : trimm_launch<T, kLeft, false>(p, st));
}

template <typename T>
int syrk(const T* W, T* S, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nt = unsigned((n + kBM - 1) / kBM);
  tri_gemm_kernel<T, kSyrk><<<nt * (nt + 1) / 2, kThreads, 0, st>>>(W, W, S,
                                                                     n, 0);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to
// row-major data.  trimm: A, B, C are nb matrices of s x s, each with a
// leading dimension (row stride) and a batch stride in elements, C not
// overlapping A or B; right != 0 computes C = sign * (A @ tril(B)),
// right == 0 computes C = sign * (tril(A) @ B), sign +1 or -1.  syrk: W and
// S are (n, n); S = tril(W)^T tril(W), full.  The return value is the
// cudaError_t of the launch (0 on success).
extern "C" int trimm_f32(const float* A, long long lda, long long sa,
                         const float* B, long long ldb, long long sb,
                         float* C, long long ldc, long long sc, int nb, int s,
                         int right, int sign, void* stream) {
  return trimm<float>(A, lda, sa, B, ldb, sb, C, ldc, sc, nb, s, right, sign,
                      stream);
}

extern "C" int trimm_f64(const double* A, long long lda, long long sa,
                         const double* B, long long ldb, long long sb,
                         double* C, long long ldc, long long sc, int nb,
                         int s, int right, int sign, void* stream) {
  return trimm<double>(A, lda, sa, B, ldb, sb, C, ldc, sc, nb, s, right, sign,
                       stream);
}

extern "C" int syrk_lower_f32(const float* W, float* S, int n, void* stream) {
  return syrk<float>(W, S, n, stream);
}

extern "C" int syrk_lower_f64(const double* W, double* S, int n,
                              void* stream) {
  return syrk<double>(W, S, n, stream);
}
