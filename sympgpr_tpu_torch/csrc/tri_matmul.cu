// Matrix products with a lower-triangular operand on Hopper (sm_90a): the
// batched triangular matmuls of the blocked triangular inverse and the syrk
// S = W^T W that forms Ky^{-1} from W = L^{-1}.
//
// Replaces two Pallas kernels:
//  * sympgpr_tpu/ops/pallas_trimm.py:40 _trimm_tile (batched A @ L and
//    L @ A, L lower) -> trimm_kernel<kRight> / <kLeft>;
//  * sympgpr_tpu/ops/pallas_syrk.py:33 _syrk_tile (W^T W, W lower)
//    -> syrk_kernel.
// The plain PyTorch versions are torch.tril(L) followed by torch.matmul
// (ops/cuda_trimm.py) and W.T @ W (ops/cuda_syrk.py).
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
