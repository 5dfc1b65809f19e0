// Matrix products with a lower-triangular operand on Hopper (sm_90a): the
// batched triangular matmuls of the blocked triangular inverse and the syrk
// S = W^T W that forms Ky^{-1} from W = L^{-1}; the product y = S x that
// takes the fit step's alpha = Ky^{-1} z from that S; and the fit step's
// Cholesky factor L of Ky, written over Ky (potrf_*, notes further down).
//
// Replaces two Pallas kernels:
//  * sympgpr_tpu/ops/pallas_trimm.py:40 _trimm_tile (batched A @ L and
//    L @ A, L lower) -> trimm_kernel<kRight> / <kLeft>;
//  * sympgpr_tpu/ops/pallas_syrk.py:33 _syrk_tile (W^T W, W lower)
//    -> syrk_kernel.
// matvec_kernel replaces none: the JAX package solves for alpha with two
// triangular solves, which on the card are cuBLAS's trsv (notes below).
// The plain PyTorch versions are torch.tril(L) followed by torch.matmul
// (ops/cuda_trimm.py), W.T @ W (ops/cuda_syrk.py) and S @ x in float64
// (ops/cuda_matvec.py).
//
// What bounds them: arithmetic.  A 128 x 128 output tile reads 2 x 128
// values per k step and does 128 x 128 multiply-adds from them, 64 per
// value loaded from device memory, so the multiply-add units and the
// shared-memory reads that feed them set the time, not HBM.  The
// structural zeros are what the design saves: the triangular product needs
// half of a dense product's multiply-adds, the syrk a sixth.
//
// trimm_kernel (the triangular matmuls).  A first version, a 64 x 64 SIMT
// GEMM shared with the syrk, ran the 8 products of one n = 8192 inverse at
// 17.8 TFLOP/s against cuBLAS's 48.6 on the dense products on an H100:
// 4 x 4 outputs per thread (2 FMAs per value read from shared memory), one
// stage with every load waiting on the FMAs, a 16-way bank conflict on the
// transposing A store, masks on every element.
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
//    holds the shortest.  For C = A L tile column j0 only accumulates
//    k >= j0, for C = L A tile row i0 only k < i0 + the tile size.
//  * Strided operands: each has a leading dimension and a batch stride, so
//    the blocked inverse passes views of its buffers, and a sign of +1 or
//    -1 (exact) is applied in the epilogue.
//  * Plain IEEE float32 FMAs accumulated in float32; no TF32, no fast math
//    (a reduced-precision product turned real GP Choleskys into NaN,
//    docs/DESIGN.md section 3).  W = L^{-1} from them is within 4e-6 of
//    float64 at N = 4096.
//
// syrk_kernel (S = tril(W)^T tril(W), full and symmetric).
//  * float64 accumulation.  S = Ky^{-1} feeds the trace term of the NLL
//    gradient, a sum over all (2N)^2 entries.  A syrk that accumulated
//    float32 input in float32 (one accumulator per output over k up to
//    8192) drove the Adam fit at N = 4096 into a jitter escalation (sig2n
//    1e-2 -> 1e-1) on an H100; with float64 accumulation it stays at 1e-2.
//    A product of two float32 values is exact in float64, so float32 input
//    converted to float64 and multiplied and summed on the float64 tensor
//    cores keeps the accuracy of a float64 FMA chain; the result is rounded
//    to float32 once.  float64 input runs the same kernel.  No TF32, no
//    float32 accumulation.
//  * What bounds it: the float64 tensor cores (DMMA), 67 TFLOP/s on an
//    H100 SXM against 34 for the float64 SIMT pipe, on which a SIMT version
//    of this kernel ran at 12.5 TFLOP/s.  The lower triangle of W^T W over
//    a triangular W is n^3 / 6 multiply-adds (1.83e11 flop at n = 8192:
//    2.74 ms at the DMMA peak; cuBLAS's DGEMM reaches 95 % of that peak on
//    the dense product).  wgmma has no float64 form, so the products are
//    warp-level mma.sync m16n8k4 with .f64 operands (mma_f64.cuh).  On an
//    H100 at n = 8192 this kernel runs at ~70 % of the peak; a copy of it
//    without the stage copies ran at ~79 %, without the fragment reads at
//    ~72 %: feeding the tensor cores, not the products, sets the rest.
//  * Tile: 128 x 128 outputs per block of 8 warps (2 along m x 4 along n),
//    each warp 64 x 32 outputs = 4 x 4 m16n8 fragments, 64 float64
//    accumulators a thread (220-240 registers, no spills); one block per
//    SM.  Per 16-deep stage a warp reads 32 A and 16 B fragment values a
//    lane for 64 DMMAs; the block's 96 KB of fragment reads per stage take
//    ~768 clocks of shared-memory bandwidth against ~2048 of DMMA.  m16n8k8
//    and m16n8k16 need more fragment registers and ran 5-9 % slower
//    (spilling in float64), 16-byte fragment reads (rows and columns
//    permuted in the tile) 4 % slower; 32 x 64 and 32 x 32 warp tiles ran
//    within 2 % of 64 x 32.
//  * Operands: Aop[m][k] = W[k][row0 + m] and Bop[k][c] = W[k][col0 + c]
//    are both slabs of W's rows, so a stage (16 rows of W) is two 16 x 128
//    row slabs, loaded along rows, 2 elements a thread (8-byte float32 or
//    16-byte float64 loads, a warp on 32 consecutive pairs).  They pass
//    through registers and are converted to float64 once per element and
//    block, not per fragment read, then stored as float64: 2 stages of
//    2 x 16 x 132 doubles (66 KB), one barrier per stage.  Stage k+1's
//    loads are issued before stage k's products and stored halfway through
//    them, so the stores run beside other warps' DMMAs instead of between
//    the last DMMA and the barrier (4 % faster in float32 than storing
//    after the products; a quarter of the way through, the loads have not
//    landed).  A three-stage cp.async ring converted through shared memory
//    ran 15 % slower: every element is then read and written once more.
//  * Conflict-free fragment reads: a staged row is 132 doubles (128 + 4),
//    so a fragment read, lane 4 g + t at row t and column g, falls on the
//    8-byte bank pairs 4 t + g mod 16: distinct within each half-warp.  A
//    warp stores 32 consecutive 16-byte pairs.
//  * Masks only where they bite: a slab inside the matrix and wholly on or
//    below W's diagonal (its last column <= its first row) takes unmasked
//    pair loads.  Only the 8 stages of a tile pair where the A slab (and, on
//    a diagonal tile, the B slab) straddles the diagonal, and those at the
//    ragged edge, load by element, reading W[k][c] only for c <= k < n, so
//    the upper triangle may hold anything, NaN included.  An odd n or a W
//    off pair alignment loads by element everywhere (instance VEC = false).
//  * Lower tile pairs only, heaviest first: the 1-D grid decodes to (i, j),
//    j <= i, row tile 0 first; tile (i, j) accumulates only k >= 128 i,
//    so row tile 0 has the longest k-range and the last wave the shortest.
//    Each block writes its outputs on and below the diagonal and their
//    mirrors above it, so S is exactly symmetric.

// matvec_kernel (y = S x, S square and row-major, full).
//  * Why: the fit step forms S = Ky^{-1} in full for its gradient, so
//    alpha = S z is one product with no dependency chain.  The two
//    triangular solves it replaces (torch.cholesky_solve: cuBLAS's trsv,
//    a chain of blocks down the diagonal) took ~1.09 ms a step at
//    n = 8192 on an H100, for 2 x 134 MB of the factor read.
//  * What bounds it: bytes.  S is read once (268 MB in float32 at
//    n = 8192: 0.080 ms at 3.35 TB/s); x and y are n values each.
//  * A warp takes a row; lane l reads every 32nd 16-byte vector of it (4
//    float32 or 2 float64), so a warp reads 512 contiguous bytes at once,
//    and x's matching vector (from L1: x is 32 KB at n = 8192).  The loop
//    is unrolled 8 deep, so each lane has 8 vectors of its row in flight.
//    On an H100 at n = 8192 in float32 this ran at 0.090 ms (89 % of the
//    bound; float64 0.178 ms, 90 %), against 0.092-0.134 ms for 2, 4 or 8
//    rows a warp (x's vector shared by the rows, fewer vectors in flight)
//    or 4 deep, and 0.132 ms for blocks of 512 threads.
//  * float64 products and sums (a product of two float32 values is exact
//    in float64), rounded to T once, as the syrk: S holds values up to
//    ~1 / sig2n and alpha cancels most of them.  Each lane sums its
//    columns in order, then the warp adds the lanes by a fixed butterfly,
//    so a row is summed in one order on every run: no atomics.
//  * Rows not 16-byte aligned (n off a multiple of the vector, or a
//    misaligned pointer) take one element a lane (instance VEC = false).

// potrf (Ky = L L^T, L written over Ky's lower triangle, row-major).
//  * Replaces no TPU kernel: the JAX package factors with
//    jnp.linalg.cholesky.  It replaces cuSOLVER's potrf in the fit step,
//    whose column-major factor the blocked inverse copied back to
//    row-major; this factor needs no copy.  The plain PyTorch version is
//    linalg/potrf.py::potrf_lower_reference (the same blocks and order).
//  * What bounds it: n^3 / 3 multiply-adds, 2.73 ms on the float64 tensor
//    cores at n = 8192; and a chain of n pivots, each a reciprocal square
//    root and a rank-1 update, that no parallelism shortens.
//  * Right-looking over block columns of 128: the diagonal block's factor
//    (potrf_diag, inside the update launch that last touches it), the
//    panel below it (potrf_panel_kernel), the trailing update
//    (potrf_update_kernel: float64 products and sums of the float64
//    panel on the DMMA units, rounded to T once a block column).  With one
//    block column of look-ahead on a second stream (potrf below), the
//    chain of diagonal blocks and panels runs beside the wide updates.
//  * On an H100 at n = 8192: float32 7.4-7.6 ms against cuSOLVER's
//    7.86-7.92 ms in place; float64 8.7-8.9 against 7.04-7.08 (its update
//    keeps two stages of operands beside a float64 tile).  The last ~35
//    block columns are bound by the chain, ~60 us each: the diagonal
//    tile's update and factor (~48 us) and the panel (~9 us).
//  * The backward error ||L L^T - Ky|| / ||Ky|| in float32 is 9e-8 on the
//    fit's Ky (cuSOLVER's 1.9e-6, LAPACK's 4.6e-7).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma_f64.cuh"

namespace {

constexpr int kRight = 0;  // C = A @ tril(B)
constexpr int kLeft = 1;   // C = tril(A) @ B

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

// --- syrk_kernel ----------------------------------------------------------

constexpr int kSyrkBM = 128;      // output tile, rows and columns
constexpr int kSyrkBK = 16;       // rows of W (k) per stage
constexpr int kSyrkWM = 64;       // warp tile rows
constexpr int kSyrkWN = 32;       // warp tile columns
constexpr int kSyrkStoreAt = kSyrkBK / 2;  // next stage stored before k
constexpr int kSyrkThreads = 32 * (kSyrkBM / kSyrkWM) * (kSyrkBM / kSyrkWN);
constexpr int kSyrkLd = kSyrkBM + 4;          // staged row, doubles
constexpr int kSyrkSlab = kSyrkBK * kSyrkLd;  // one operand of a stage
constexpr int kSyrkSmem = 2 * 2 * kSyrkSlab * int(sizeof(double));
constexpr int kSyrkPairs = kSyrkBK * kSyrkBM / 2 / kSyrkThreads;
static_assert(kSyrkPairs * kSyrkThreads * 2 == kSyrkBK * kSyrkBM, "pairs");
static_assert(kSyrkBK % 4 == 0 && kSyrkStoreAt % 4 == 0 &&
                  kSyrkStoreAt < kSyrkBK && kSyrkLd % 16 == 4,
              "layout");

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// One operand's slab of a stage, W[k0 .. k0 + 15][c0 .. c0 + 127], this
// thread's share of it in registers: pair q = threadIdx.x + p * threads
// holds row q / 64 and columns c0 + 2 (q % 64) .. + 1.
template <typename T, bool VEC>
struct SyrkSlab {
  typename Pair<T>::type v[kSyrkPairs];

  __device__ __forceinline__ void load(const T* __restrict__ W, int n, int k0,
                                       int c0) {
    constexpr int R = kSyrkBM / 2;  // pairs of a row
    // inside the matrix and wholly on or below the diagonal
    const bool full = VEC && k0 + kSyrkBK <= n && c0 + kSyrkBM <= n &&
                      c0 + kSyrkBM - 1 <= k0;
#pragma unroll
    for (int p = 0; p < kSyrkPairs; ++p) {
      const int q = int(threadIdx.x) + p * kSyrkThreads;
      const int r = k0 + q / R, c = c0 + 2 * (q % R);
      const T* src = W + size_t(r) * n + c;
      if (full) {
        v[p] = *reinterpret_cast<const typename Pair<T>::type*>(src);
      } else {  // c <= r < n: inside the matrix, on or below the diagonal
        v[p].x = r < n && c <= r ? src[0] : T(0);
        v[p].y = r < n && c + 1 <= r ? src[1] : T(0);
      }
    }
  }

  __device__ __forceinline__ void store(double* slab) const {
    constexpr int R = kSyrkBM / 2;
#pragma unroll
    for (int p = 0; p < kSyrkPairs; ++p) {
      const int q = int(threadIdx.x) + p * kSyrkThreads;
      *reinterpret_cast<double2*>(slab + (q / R) * kSyrkLd + 2 * (q % R)) =
          make_double2(double(v[p].x), double(v[p].y));
    }
  }
};

// S = tril(W)^T tril(W) for one lower tile pair per block, products and
// sums in float64 on the tensor cores.  VEC: n is even and W pair-aligned.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kSyrkThreads, 1)
    syrk_kernel(const T* __restrict__ W, T* __restrict__ S, int n) {
  constexpr int MT = kSyrkWM / 16, NT = kSyrkWN / 8;  // m16n8 fragments
  // stage st: the A slab (W's columns row0 ...), then the B slab (col0 ...)
  extern __shared__ double2 syrk_smem[];
  double* const smem = reinterpret_cast<double*>(syrk_smem);

  // lower tile pairs t = bi (bi + 1) / 2 + bj, bj <= bi: row tile 0, whose
  // k-range k >= row0 is the longest, first
  const int t = int(blockIdx.x);
  int bi = int((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int row0 = bi * kSyrkBM, col0 = bj * kSyrkBM;
  const int ntiles = (n - row0 + kSyrkBK - 1) / kSyrkBK;

  const int warp = int(threadIdx.x) / 32, lane = int(threadIdx.x) % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = (warp % (kSyrkBM / kSyrkWM)) * kSyrkWM;
  const int wn = (warp / (kSyrkBM / kSyrkWM)) * kSyrkWN;

  double acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0;

  SyrkSlab<T, VEC> sa, sb;
  sa.load(W, n, row0, row0);
  sb.load(W, n, row0, col0);
  sa.store(smem);
  sb.store(smem + kSyrkSlab);
  __syncthreads();
  for (int kt = 0; kt < ntiles; ++kt) {
    const bool more = kt + 1 < ntiles;
    if (more) {  // in flight while this stage's products run
      const int k1 = row0 + (kt + 1) * kSyrkBK;
      sa.load(W, n, k1, row0);
      sb.load(W, n, k1, col0);
    }
    // fragment reads at row tq and column g of the warp's tile
    const double* as =
        smem + (kt % 2) * 2 * kSyrkSlab + tq * kSyrkLd + wm + g;
    const double* bs = as - wm + kSyrkSlab + wn;
#pragma unroll
    for (int kk = 0; kk < kSyrkBK; kk += 4) {
      if (kk == kSyrkStoreAt && more) {  // beside other warps' DMMAs
        double* next = smem + ((kt + 1) % 2) * 2 * kSyrkSlab;
        sa.store(next);
        sb.store(next + kSyrkSlab);
      }
      double b[NT];
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) b[ni] = bs[kk * kSyrkLd + ni * 8];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const double a[2] = {as[kk * kSyrkLd + mi * 16],
                             as[kk * kSyrkLd + mi * 16 + 8]};
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_f64(acc[mi][ni], a, b[ni]);
      }
    }
    __syncthreads();  // stage kt + 1 complete; stage kt free
  }

  // outputs on and below the diagonal, and their mirrors above it (a
  // diagonal tile holds both triangles; only c <= r is written from it)
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wm + mi * 16 + g + 8 * h;
      if (r >= n) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int c = col0 + wn + ni * 8 + 2 * tq;
        const T v0 = T(acc[mi][ni][2 * h]), v1 = T(acc[mi][ni][2 * h + 1]);
        T* low = S + size_t(r) * n + c;
        if (VEC && c + 1 <= r) {
          typename Pair<T>::type v;
          v.x = v0;
          v.y = v1;
          *reinterpret_cast<typename Pair<T>::type*>(low) = v;
        } else {
          if (c <= r) low[0] = v0;
          if (c + 1 <= r) low[1] = v1;
        }
        if (c < r) S[size_t(c) * n + r] = v0;
        if (c + 1 < r) S[size_t(c + 1) * n + r] = v1;
      }
    }
}

template <typename T, bool VEC>
cudaError_t syrk_launch(const T* W, T* S, int n, cudaStream_t st) {
  auto kern = syrk_kernel<T, VEC>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSyrkSmem);
  if (e != cudaSuccess) return e;
  const unsigned nt = unsigned((n + kSyrkBM - 1) / kSyrkBM);
  kern<<<nt * (nt + 1) / 2, kSyrkThreads, kSyrkSmem, st>>>(W, S, n);
  return cudaGetLastError();
}

template <typename T>
int syrk(const T* W, T* S, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(W) % (2 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(S) % (2 * sizeof(T)) == 0;
  return int(vec ? syrk_launch<T, true>(W, S, n, st)
                 : syrk_launch<T, false>(W, S, n, st));
}

// --- matvec_kernel --------------------------------------------------------

constexpr int kMvThreads = 256;  // 8 warps, a row each
constexpr int kMvUnroll = 8;     // vectors of the row in flight a lane

template <typename T, int V>
__device__ __forceinline__ void ldv(T (&r)[V], const T* p) {
  if constexpr (V == 1)
    r[0] = *p;
  else
    ld16(r, p);
}

// y = S x, a row a warp; VEC: n a multiple of the 16-byte vector and S, x
// 16-byte aligned.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kMvThreads)
    matvec_kernel(const T* __restrict__ S, const T* __restrict__ x,
                  T* __restrict__ y, int n) {
  constexpr int V = VEC ? 16 / int(sizeof(T)) : 1;
  const int lane = int(threadIdx.x) % 32;
  const int r = int(blockIdx.x) * (kMvThreads / 32) + int(threadIdx.x) / 32;
  if (r >= n) return;  // the whole warp
  const T* row = S + size_t(r) * n;
  double acc = 0.0;
  const int nv = n / V;
#pragma unroll (kMvUnroll)
  for (int c = lane; c < nv; c += 32) {
    T sv[V], xv[V];
    ldv<T, V>(sv, row + size_t(c) * V);
    ldv<T, V>(xv, x + size_t(c) * V);
#pragma unroll
    for (int j = 0; j < V; ++j) acc = fma(double(sv[j]), double(xv[j]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) y[r] = T(acc);
}

template <typename T>
int matvec(const T* S, const T* x, T* y, int n, void* stream) {
  constexpr int V = 16 / int(sizeof(T));
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const bool vec = n % V == 0 && aligned(S) && aligned(x);
  constexpr int rows = kMvThreads / 32;
  const unsigned grid = unsigned((n + rows - 1) / rows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    matvec_kernel<T, true><<<grid, kMvThreads, 0, st>>>(S, x, y, n);
  else
    matvec_kernel<T, false><<<grid, kMvThreads, 0, st>>>(S, x, y, n);
  return int(cudaGetLastError());
}

// --- potrf: the blocked Cholesky ------------------------------------------

constexpr int kPB = 128;             // block column width
constexpr int kPBK = 16;             // panel columns (k) a stage of the update
constexpr int kPLd = kPB + 4;        // staged operand row, doubles
constexpr int kPSlab = kPBK * kPLd;  // one operand of a stage, doubles
constexpr int kPWM = 64, kPWN = 32;  // warp tile of the update
constexpr int kPThreads = 32 * (kPB / kPWM) * (kPB / kPWN);
constexpr int kPanelWarps = 32;  // at most, a block of the panel
constexpr int kPanelRPW = 2;     // rows a warp of the panel
constexpr int kPanelMaxRows = kPanelWarps * kPanelRPW;
constexpr int kPanelSmem =
    (kPB * kPB + kPB + kPanelMaxRows * (kPB + 1)) * int(sizeof(double));
// the tiles an update launch takes from the trailing region at kr: all its
// lower tile pairs, its first block column only, or all but that column
constexpr int kTilesAll = 0, kTilesColumn = 1, kTilesRest = 2;
constexpr int kPAux = kPB + 2;  // the diagonal factor's 1 / diag and flag
static_assert(kPThreads == 256 && kPB == 128, "the diagonal factor's map");

// Shared memory of the update: the operand ring, the tile of A being
// updated (rows of ALD elements of T), and the diagonal factor's
// 1 / diag(L) and failing column (kPAux doubles).  The diagonal tile, in
// float64 for the factor, lands in the ring (float32; free once the
// products are done) or over the tile of A itself (float64: each thread
// reads then writes the same elements); its rows are 129 or 130 doubles,
// so a warp reading rows a lane apart meets few bank conflicts.
template <typename T>
struct PotrfTile {
  static constexpr int V = 16 / int(sizeof(T));
  static constexpr int STAGES = sizeof(T) == 4 ? 4 : 2;
  static constexpr int RING = STAGES * 2 * kPSlab;  // doubles
  static constexpr int ALD = sizeof(T) == 4 ? kPB + 8 : kPB + 2;
  static constexpr int SLD = sizeof(T) == 4 ? kPB + 1 : ALD;
  static constexpr int ABYTES = kPB * ALD * int(sizeof(T));
  static constexpr int SMEM = RING * 8 + ABYTES + kPAux * 8;
  static_assert(sizeof(T) == 8 || kPB * SLD <= RING, "S fits the ring");
};

// Rows of the float64 panel P: n rounded up to a pair, so each row is
// 16-byte aligned.
inline long long potrf_ldp(int n) {
  return (n + 1LL) / 2 * 2;
}

// The factor of the w x w diagonal block at (k0, k0), w = min(128, n - k0),
// by one block of 256 threads, in place in the float64 tile S (row sld):
// left-looking over panels of 8 columns with one panel of look-ahead.
// Warp 0 factors panel c0 (rows c0 ... 127, lane l holding rows c0 + l,
// + 32, + 64, + 96; every lane also a copy of the panel's top 8 rows, so
// its pivots and columns need no shuffle), with no block barrier;
// meanwhile warps 1-7 take the product of the panels before
// c0 off panel c0 + 8 on the tensor cores (m16n8k4, 16 rows a fragment);
// after a barrier they take panel c0's rank-8 product off it too.  Two
// block barriers a panel of 8: the chain of 128 pivots is the cost, ~31 us
// on an H100 (a 128-pivot chain of rsqrt and two multiply-adds in one
// thread alone takes 7 us there).  Versions that kept 8 x 8 blocks in the
// registers of 136 threads with a block barrier a column took 62-105 us;
// left-looking by panels of 32, a panel factored by one warp, 57-71 us;
// loops over columns in shared memory, 136 us (each load waits on the
// store before it); shuffles in place of the top rows' copy, 35 us.
// Writes L over A's lower triangle (rounded to T), L^T and 1 / diag(L) in
// float64 to D for the panel, and info: reset on the first block column,
// else set only where no earlier column failed.
template <typename T>
__device__ __forceinline__ void potrf_diag(double* S, int sld, double* aux,
                                           T* A, int n, int k0, double* D,
                                           int* info, int reset) {
  double* const rd = aux;
  int* const fail_s = reinterpret_cast<int*>(aux + kPB);
  const int w = min(kPB, n - k0);
  const int tid = int(threadIdx.x), warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  int fail = -1;
  double acc[2][4];
  __syncthreads();  // the tile is in S
  for (int c0 = 0; c0 < w; c0 += 8) {
    const int c1 = c0 + 8;
    if (warp == 0) {  // panel c0
      // every lane keeps its own copy of the panel's top 8 rows (lower
      // part), updated with the same operations as the lanes that hold
      // them, so a pivot and its column come without a shuffle
      double v[4][8], top[8][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const double* row = S + min(c0 + lane + 32 * q, kPB - 1) * sld + c0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) v[q][jj] = row[jj];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj <= i; ++jj)
          top[i][jj] = S[min(c0 + i, kPB - 1) * sld + c0 + jj];
      __syncwarp();  // every lane has read the top rows before any writes
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (c0 + j < w) {  // the same for the warp
          const double d = top[j][j];
          if (fail < 0 && !(d > 0.0 && isfinite(d))) fail = c0 + j;
          const double rs = rsqrt(d);
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q][j] *= rs;
          if (lane == j) v[0][j] = d * rs;
          if (lane == 0) rd[c0 + j] = rs;
#pragma unroll
          for (int i = j + 1; i < 8; ++i) top[i][j] *= rs;
          top[j][j] = d * rs;
#pragma unroll
          for (int jj = j + 1; jj < 8; ++jj) {
            const double l = top[jj][j];
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q][jj] = fma(-v[q][j], l, v[q][jj]);
#pragma unroll
            for (int i = jj; i < 8; ++i)
              top[i][jj] = fma(-top[i][j], l, top[i][jj]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = c0 + lane + 32 * q;
        if (r < kPB)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) S[r * sld + c0 + jj] = v[q][jj];
      }
    } else if (c1 < w) {  // panels before c0 off panel c1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[h][i] = 0.0;
        const int r0 = c1 + 16 * (warp - 1 + 7 * h);
        if (r0 < kPB) {
          const double* a0 = S + min(r0 + g, kPB - 1) * sld + tq;
          const double* a1 = S + min(r0 + g + 8, kPB - 1) * sld + tq;
          const double* bp = S + (c1 + g) * sld + tq;
          for (int k = 0; k < c0; k += 4) {
            const double a[2] = {a0[k], a1[k]};
            mma_f64(acc[h], a, bp[k]);
          }
        }
      }
    }
    __syncthreads();
    if (warp != 0 && c1 < w) {  // panel c0 off panel c1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = c1 + 16 * (warp - 1 + 7 * h);
        if (r0 < kPB) {
          const double* a0 = S + min(r0 + g, kPB - 1) * sld + tq;
          const double* a1 = S + min(r0 + g + 8, kPB - 1) * sld + tq;
          const double* bp = S + (c1 + g) * sld + tq;
#pragma unroll
          for (int k = c0; k < c1; k += 4) {
            const double a[2] = {a0[k], a1[k]};
            mma_f64(acc[h], a, bp[k]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + g + 8 * (i / 2), c = c1 + 2 * tq + i % 2;
            if (r < kPB) S[r * sld + c] -= acc[h][i];
          }
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) *fail_s = fail;  // warp 0's
  for (int r = warp; r < w; r += kPThreads / 32)
    for (int c = lane; c <= r; c += 32)
      A[size_t(k0 + r) * n + k0 + c] = T(S[r * sld + c]);
  for (int c = warp; c < w; c += kPThreads / 32)
    for (int r = c + lane; r < w; r += 32) D[c * kPB + r] = S[r * sld + c];
  for (int r = tid; r < w; r += kPThreads) D[kPB * kPB + r] = rd[r];
  __syncthreads();
  if (tid == 0) {
    const int f = *fail_s;
    if (reset)
      *info = f >= 0 ? k0 + f + 1 : 0;
    else if (f >= 0 && *info == 0)
      *info = k0 + f + 1;
  }
}

// The trailing update A_ij -= L_i L_j^T of one lower 128 x 128 tile pair
// (i, j) of the region from row and column kr, the products and sums in
// float64 on the tensor cores from the float64 panel P (K rows of k, one
// column a row of A), subtracted from the tile and rounded to T once.
// tiles: the region's lower tile pairs, decoded as in syrk_kernel with
// (0, 0) first (kTilesAll); its first block column, (0, 0) first
// (kTilesColumn); or the pairs right of that column (kTilesRest).  Block
// (0, 0) then factors the updated tile, the next block column's diagonal
// block, while the others update theirs.  K = 0 launches that block alone
// (the first block column).  A diagonal tile writes its lower triangle only.  VEC: n
// is a multiple of the 16-byte vector and A is 16-byte aligned.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kPThreads, 1)
    potrf_update_kernel(T* __restrict__ A, int n, int kr, int K,
                        const double* __restrict__ P, long long ldp,
                        double* __restrict__ D, int* __restrict__ info,
                        int reset, int tiles) {
  using G = PotrfTile<T>;
  constexpr int S = G::STAGES, V = G::V;
  constexpr int MT = kPWM / 16, NT = kPWN / 8;
  extern __shared__ double2 potrf_smem[];
  double* const ring = reinterpret_cast<double*>(potrf_smem);
  T* const at = reinterpret_cast<T*>(ring + G::RING);
  double* const aux = reinterpret_cast<double*>(
      reinterpret_cast<char*>(at) + G::ABYTES);

  const int tid = int(threadIdx.x), warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wm = (warp % (kPB / kPWM)) * kPWM;
  const int wn = (warp / (kPB / kPWM)) * kPWN;
  const int ntiles = K / kPBK;
  constexpr int HALF = kPBK * kPB / 2;  // chunks of one operand
  constexpr int CPT = HALF / kPThreads;  // chunks of an operand a thread
  constexpr int RSTEP = kPThreads / (kPB / 2);  // rows between them
  static_assert(CPT * kPThreads == HALF && RSTEP * CPT == kPBK, "chunks");
  const int ckk = tid / (kPB / 2), cc = 2 * (tid % (kPB / 2));
  const int dst = ckk * kPLd + cc;

  // A tile pair's place and copies.  Stage kt: the panel's rows kt * 16
  // ... + 15 at the tile's rows (A operand) and columns (B operand),
  // 16-byte chunks of two doubles, rows and columns past n zero-filled; a
  // thread's chunks keep one column pair of each operand, HALF / kPThreads
  // rows of the stage apart, so their sources are set up once a tile.
  struct Tile {
    int bi, bj, row0, col0, ok_a, ok_b;
    const double *src_a, *src_b;
    size_t step_a, step_b, stage_a, stage_b;
  };
  const auto tile_at = [&](int t) {
    Tile u;
    u.bi = t;
    u.bj = 0;  // kTilesColumn
    if (tiles != kTilesColumn) {
      int bi = int((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
      while (bi * (bi + 1) / 2 > t) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
      u.bi = bi;
      u.bj = t - bi * (bi + 1) / 2;
      if (tiles == kTilesRest) ++u.bi, ++u.bj;
    }
    u.row0 = kr + u.bi * kPB;
    u.col0 = kr + u.bj * kPB;
    u.ok_a = max(0, min(2, n - u.row0 - cc));
    u.ok_b = max(0, min(2, n - u.col0 - cc));
    u.src_a = u.ok_a ? P + size_t(ckk) * ldp + u.row0 + cc : P;
    u.src_b = u.ok_b ? P + size_t(ckk) * ldp + u.col0 + cc : P;
    u.step_a = u.ok_a ? size_t(RSTEP) * ldp : 0;
    u.step_b = u.ok_b ? size_t(RSTEP) * ldp : 0;
    u.stage_a = u.ok_a ? size_t(kPBK) * ldp : 0;
    u.stage_b = u.ok_b ? size_t(kPBK) * ldp : 0;
    return u;
  };
  const auto issue = [&](const Tile& u, int slot, int kt) {
    double* st = ring + slot * 2 * kPSlab + dst;
    const double* a = u.src_a + size_t(kt) * u.stage_a;
    const double* b = u.src_b + size_t(kt) * u.stage_b;
#pragma unroll
    for (int p = 0; p < CPT; ++p) {
      cp_async<16>(st + p * RSTEP * kPLd, a + p * u.step_a, 8 * u.ok_a);
      cp_async<16>(st + kPSlab + p * RSTEP * kPLd, b + p * u.step_b,
                   8 * u.ok_b);
    }
  };
  // the tile of A, rows and columns past n zero-filled; issued with the
  // last stage (or alone where K = 0), as the epilogue alone reads it
  const auto issue_tile = [&](const Tile& u) {
    constexpr int CPR = kPB / V;  // 16-byte chunks a row
#pragma unroll 4
    for (int p = 0; p < kPB * CPR / kPThreads; ++p) {
      const int q = tid + p * kPThreads;
      const int r = u.row0 + q / CPR, c = u.col0 + (q % CPR) * V;
      T* d = at + (q / CPR) * G::ALD + (q % CPR) * V;
      const int ok = r < n ? max(0, min(V, n - c)) : 0;
      const T* src = A + size_t(r) * n + c;
      if constexpr (VEC) {
        cp_async<16>(d, ok ? src : A, ok * int(sizeof(T)));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          cp_async<int(sizeof(T))>(d + j, j < ok ? src + j : A,
                                   j < ok ? int(sizeof(T)) : 0);
      }
    }
  };
  const auto prologue = [&](const Tile& u) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < ntiles) issue(u, s, s);
      if (s == max(ntiles - 1, 0)) issue_tile(u);
      cp_async_commit();
    }
  };

  const int t = int(blockIdx.x);
  const Tile u = tile_at(t);
  prologue(u);
  double acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<S - 2>();  // this thread's copies of stage kt are in
    __syncthreads();         // everyone's are; slot (kt - 1) % S is free
    const int next = kt + S - 1;
    if (next < ntiles) {
      issue(u, next % S, next);
      if (next == ntiles - 1) issue_tile(u);
    }
    cp_async_commit();
    const double* as = ring + (kt % S) * 2 * kPSlab + tq * kPLd + wm + g;
    const double* bs = as - wm + kPSlab + wn;
#pragma unroll
    for (int kk = 0; kk < kPBK; kk += 4) {
      double b[NT];
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) b[ni] = bs[kk * kPLd + ni * 8];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const double a[2] = {as[kk * kPLd + mi * 16],
                             as[kk * kPLd + mi * 16 + 8]};
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_f64(acc[mi][ni], a, b[ni]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the tile of A is in; the ring is free

  const bool factor = t == 0 && tiles != kTilesRest;
  double* const Sd = sizeof(T) == 4 ? ring : reinterpret_cast<double*>(at);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm + mi * 16 + g + 8 * h, r = u.row0 + rl;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int cl = wn + ni * 8 + 2 * tq, c = u.col0 + cl;
        const T* ap = at + rl * G::ALD + cl;
        const double v0 = double(ap[0]) - acc[mi][ni][2 * h];
        const double v1 = double(ap[1]) - acc[mi][ni][2 * h + 1];
        if (factor) {
          Sd[rl * G::SLD + cl] = v0;
          Sd[rl * G::SLD + cl + 1] = v1;
          continue;
        }
        if (r >= n) continue;
        const bool ok0 = c < n && (u.bi != u.bj || c <= r);
        const bool ok1 = c + 1 < n && (u.bi != u.bj || c + 1 <= r);
        T* d = A + size_t(r) * n + c;
        if (VEC && ok0 && ok1) {
          typename Pair<T>::type v;
          v.x = T(v0);
          v.y = T(v1);
          *reinterpret_cast<typename Pair<T>::type*>(d) = v;
        } else {
          if (ok0) d[0] = T(v0);
          if (ok1) d[1] = T(v1);
        }
      }
    }
  if (factor)  // the whole block
    potrf_diag<T>(Sd, G::SLD, aux, A, n, kr, D, info, reset);
}

// L_i = A_i L_kk^-T for the rows i of block column k0 below its diagonal
// block: forward substitution in float64 against L_kk^T and 1 / diag(L_kk)
// from D, four rows a warp, lane l holding columns l, l + 32, l + 64,
// l + 96 of each.  Step m takes x_m of each row from its lane by a shuffle
// and subtracts x_m L_kk[c][m] from the columns c > m; L_kk's column m is
// read from shared memory once a warp for its four rows.  On an H100 this
// takes 12-26 us a panel; a row a warp (bound by those reads), eight rows
// a warp with x_m posted to shared memory, a row a thread, and a warp a
// block of 32 columns took 20-53 us.  The launch sizes the blocks to the
// rows, 1-16 warps, so that few rows still spread over the SMs.  Each
// block loads D once (four copy groups of 32 rows, the first waited for
// before step 0) and walks over groups of rows.  Writes each row to A
// (rounded to T) and, through a staging tile, to P as consecutive doubles
// a panel column.
template <typename T>
__global__ void __launch_bounds__(kPanelWarps * 32, 1)
    potrf_panel_kernel(T* __restrict__ A, int n, int k0,
                       double* __restrict__ P, long long ldp,
                       const double* __restrict__ D) {
  constexpr int RPW = kPanelRPW;
  extern __shared__ double2 panel_smem[];
  double* const dt = reinterpret_cast<double*>(panel_smem);
  double* const rd = dt + kPB * kPB;
  double* const xs = rd + kPB;
  const int tid = int(threadIdx.x), warp = tid / 32, lane = tid % 32;
  const int nthreads = int(blockDim.x), rows_blk = nthreads / 32 * RPW;
  constexpr int GROUP = 32 * kPB / 2;  // 16-byte chunks of 32 rows of D
#pragma unroll
  for (int grp = 0; grp < 4; ++grp) {
    for (int q = tid; q < GROUP; q += nthreads)
      cp_async<16>(dt + 2 * (grp * GROUP + q), D + 2 * (grp * GROUP + q), 16);
    if (grp == 0)
      for (int q = tid; q < kPB / 2; q += nthreads)
        cp_async<16>(rd + 2 * q, D + kPB * kPB + 2 * q, 16);
    cp_async_commit();
  }
  const int rbeg = k0 + kPB;
  const int groups = (n - rbeg + rows_blk - 1) / rows_blk;
  bool first = true;
  for (int gi = int(blockIdx.x); gi < groups; gi += int(gridDim.x)) {
    const int rb = rbeg + gi * rows_blk, r0 = rb + warp * RPW;
    double a[RPW][4];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        a[i][s] = r0 + i < n
                      ? double(A[size_t(r0 + i) * n + k0 + lane + 32 * s])
                      : 0.0;
#pragma unroll
    for (int sb = 0; sb < 4; ++sb) {
      if (first) {  // the same for every thread
        if (sb == 0) cp_async_wait<3>();
        if (sb == 1) cp_async_wait<2>();
        if (sb == 2) cp_async_wait<1>();
        if (sb == 3) cp_async_wait<0>();
        __syncthreads();
      }
#pragma unroll
      for (int mm = 0; mm < 32; ++mm) {
        const int m = 32 * sb + mm;
        double x[RPW], col[4];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          x[i] = __shfl_sync(0xffffffffu, a[i][sb], mm) * rd[m];
#pragma unroll
        for (int s = sb; s < 4; ++s) col[s] = dt[m * kPB + lane + 32 * s];
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          if (lane == mm) a[i][sb] = x[i];
#pragma unroll
          for (int s = sb; s < 4; ++s)
            if (s > sb || lane > mm) a[i][s] = fma(-x[i], col[s], a[i][s]);
        }
      }
    }
    first = false;
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        if (r0 + i < n) A[size_t(r0 + i) * n + k0 + lane + 32 * s] = T(a[i][s]);
        xs[(warp * RPW + i) * (kPB + 1) + lane + 32 * s] = a[i][s];
      }
    __syncthreads();
    for (int e = tid; e < kPB * rows_blk; e += nthreads) {
      const int kk = e / rows_blk, j = e % rows_blk;
      if (rb + j < n) P[size_t(kk) * ldp + rb + j] = xs[j * (kPB + 1) + kk];
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <typename T, bool VEC>
cudaError_t potrf_update_launch(T* A, int n, int kr, int K, const double* P,
                                long long ldp, double* D, int* info,
                                int reset, int tiles, int count,
                                cudaStream_t st) {
  potrf_update_kernel<T, VEC><<<unsigned(count), kPThreads,
                                PotrfTile<T>::SMEM, st>>>(
      A, n, kr, K, P, ldp, D, info, reset, tiles);
  return cudaGetLastError();
}

// A second stream of the highest priority and four events a device, made
// on first use and kept: the factor's chain (each block column's diagonal
// block, its panel and the next block column's update) runs there, ahead
// of the rest of the trailing update on the caller's stream.  Two host
// threads must not factor on one device at once: they would share them.
struct LookAhead {
  cudaStream_t side = nullptr;
  cudaEvent_t ev[4] = {};  // entry, rest of an update done, panel done, exit
};

inline cudaError_t look_ahead(int dev, LookAhead** out) {
  static LookAhead la[64];
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  LookAhead& l = la[dev];
  if (!l.side) {
    int lo = 0, hi = 0;
    cudaError_t e = cudaDeviceGetStreamPriorityRange(&lo, &hi);
    if (e == cudaSuccess)
      e = cudaStreamCreateWithPriority(&l.side, cudaStreamNonBlocking, hi);
    for (int i = 0; i < 4 && e == cudaSuccess; ++i)
      e = cudaEventCreateWithFlags(&l.ev[i], cudaEventDisableTiming);
    if (e != cudaSuccess) {
      l.side = nullptr;
      return e;
    }
  }
  *out = &l;
  return cudaSuccess;
}

// The whole factor, issued from the host with no sync: right-looking over
// block columns of 128 with one block column of look-ahead.  On the side
// stream, for block column k: its panel (into P's half k % 2), then the
// update of block column k + 1 alone, whose first block factors the next
// diagonal block.  On the caller's stream: the update of the tiles right of
// block column k + 1.  Block column k + 1's update waits for the caller's
// update of step k - 1 (which updated it last), the caller's update of
// step k for panel k; panel k + 2 overwrites P's half k % 2 only after
// that.  The chain of diagonal blocks, panels and single block columns thus
// runs beside the wide updates, which it held up one after the other in a
// single stream: 8.25 against 8.66 ms at n = 8192 float32 on an H100 (the
// same kernels otherwise).  2 + 3 (ceil(n / 128) - 1) launches.  work: potrf_work_doubles(n)
// doubles, the panel P (two halves of 128 rows of ldp) then D (L_kk^T,
// then 1 / diag(L_kk)).
template <typename T>
int potrf(T* A, int n, double* work, int* info, void* stream) {
  using G = PotrfTile<T>;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static unsigned long long ready = 0;  // a bit a device: attributes set
  if (e == cudaSuccess && dev < 64 && !(ready >> dev & 1ULL)) {
    e = cudaFuncSetAttribute(potrf_update_kernel<T, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(potrf_update_kernel<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(potrf_panel_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPanelSmem);
    if (e == cudaSuccess) ready |= 1ULL << dev;
  }
  LookAhead* la = nullptr;
  if (e == cudaSuccess) e = look_ahead(dev, &la);
  if (e != cudaSuccess) return int(e);
  const cudaStream_t side = la->side;
  cudaEvent_t* const ev = la->ev;
  const long long ldp = potrf_ldp(n);
  double* const D = work + 2 * kPB * ldp;
  const bool vec =
      n % G::V == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const auto update = [&](int kr, int K, const double* P, int reset,
                          int tiles, int count, cudaStream_t s) {
    return vec ? potrf_update_launch<T, true>(A, n, kr, K, P, ldp, D, info,
                                              reset, tiles, count, s)
               : potrf_update_launch<T, false>(A, n, kr, K, P, ldp, D, info,
                                               reset, tiles, count, s);
  };
  const auto panel = [&](int k0, double* P) {
    const int rows = n - k0 - kPB;
    const int warps = max(1, min(kPanelWarps,
                                 (rows + kPanelRPW * sms - 1) /
                                     (kPanelRPW * sms)));
    const int groups = (rows + warps * kPanelRPW - 1) / (warps * kPanelRPW);
    potrf_panel_kernel<T><<<unsigned(min(groups, sms)), unsigned(32 * warps),
                            kPanelSmem, side>>>(A, n, k0, P, ldp, D);
    return cudaGetLastError();
  };
  e = cudaEventRecord(ev[0], st);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(side, ev[0], 0);
  if (e == cudaSuccess) e = update(0, 0, work, 1, kTilesAll, 1, side);
  for (int k = 0; e == cudaSuccess && (k + 1) * kPB < n; ++k) {
    const int k0 = k * kPB, kr = k0 + kPB;
    double* const P = work + (k % 2) * kPB * ldp;
    const int nt = (n - kr + kPB - 1) / kPB;
    e = panel(k0, P);
    if (e == cudaSuccess) e = cudaEventRecord(ev[2], side);
    // ev[1] still marks the update of step k - 1, recorded below
    if (e == cudaSuccess && k > 0) e = cudaStreamWaitEvent(side, ev[1], 0);
    if (e == cudaSuccess)
      e = update(kr, kPB, P, 0, kTilesColumn, nt, side);
    if (e == cudaSuccess && nt > 1) {
      e = cudaStreamWaitEvent(st, ev[2], 0);
      if (e == cudaSuccess)
        e = update(kr, kPB, P, 0, kTilesRest, nt * (nt - 1) / 2, st);
      if (e == cudaSuccess) e = cudaEventRecord(ev[1], st);
    }
  }
  if (e == cudaSuccess) e = cudaEventRecord(ev[3], side);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(st, ev[3], 0);
  return int(e);
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer to
// row-major data.  trimm: A, B, C are nb matrices of s x s, each with a
// leading dimension (row stride) and a batch stride in elements, C not
// overlapping A or B; right != 0 computes C = sign * (A @ tril(B)),
// right == 0 computes C = sign * (tril(A) @ B), sign +1 or -1.  syrk: W and
// S are (n, n); S = tril(W)^T tril(W), full.  matvec: S is (n, n), x and
// y are (n,), y not overlapping S or x; y = S x.  The return value is the
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

extern "C" int matvec_f32(const float* S, const float* x, float* y, int n,
                          void* stream) {
  return matvec<float>(S, x, y, n, stream);
}

extern "C" int matvec_f64(const double* S, const double* x, double* y, int n,
                          void* stream) {
  return matvec<double>(S, x, y, n, stream);
}

// potrf: A is (n, n), n >= 1; its lower triangle is overwritten by the
// Cholesky factor L (A = L L^T), row-major; its strict upper triangle is
// never written, and no value of it reaches L.  work holds
// potrf_work_doubles(n) doubles; info is one device int, set to 0 or to the
// order of the first leading minor whose pivot is not positive or not
// finite.
extern "C" int potrf_work_doubles(int n) {
  return int(2 * kPB * potrf_ldp(n) + kPB * kPB + kPB);
}

extern "C" int potrf_lower_f32(float* A, int n, double* work, int* info,
                               void* stream) {
  return potrf<float>(A, n, work, info, stream);
}

extern "C" int potrf_lower_f64(double* A, int n, double* work, int* info,
                               void* stream) {
  return potrf<double>(A, n, work, info, stream);
}
