// Derivative-observation covariance on Hopper (sm_90a): the tiled build of
// the (2N, 2N0) matrix and the contraction of its hyperparameter gradient.
//
// Replaces two Pallas kernels of sympgpr_tpu/ops/pallas_cov.py:
//  * _cov_tile (pallas_cov.py:88, with _tile_blocks :57) -> cov_fwd_kernel;
//  * _cov_bwd_tile (pallas_cov.py:187) -> cov_bwd_kernel + cov_reduce_kernel.
// The plain PyTorch versions are build_K_blocks_reference,
// build_Ky_reference, cov_param_grads_reference and
// cov_param_grads_sym_reference in sympgpr_tpu_torch/ops/cuda_cov.py; the
// derivative formulas of the contraction are written out there too and held
// against autograd on the CPU.
//
// Layout (sympgpr_tpu_torch/gp/covariance.py): K[r*N + i, c*N0 + j] with
// component 0 = q and 1 = P; the two mixed blocks are equal elementwise for
// these stationary kernels.  Kinds: 0 per_se (periodic q-factor at
// frequency 1/2), 1 se_se, 2 per_se_freq, 3 sum_per_se (separable sum: the
// mixed block is zero and each diagonal block carries its own exp and sig).
//
// What bounds them: device-memory bytes.  At N = N0 = 4096 in float32 the
// build writes 268 MB (80 us at 3.35 TB/s); the general contraction reads as
// much, the fused one half of it.  Per pair the build issues ~45
// floating-point instructions and the contraction ~100 (one exp each; no
// sin/cos, see below): ~0.02 ms over the card's issue rate for the build
// and the fused contraction, ~0.05 ms for the general contraction.
//
// Design:
//  * Pair tiles of 64 x 64 in blocks of 256 threads; a thread owns 4 rows
//    (16 apart) and 4 consecutive columns, so every store and load of a
//    warp is 16-byte vectors (float4, or two double2) over 256 contiguous
//    bytes of one row.  Rows and columns past the edge are masked; a row
//    length or base address off the 16-byte grid falls back to scalar
//    accesses.  The build's stores are streaming (evict-first).
//  * No sin/cos per pair: the periodic kinds need sin and cos of f (q_i -
//    q_j) only, which the angle-difference identity forms from sin and cos
//    of f q per point, staged with the tile's points in shared memory.
//  * The build writes Ky when X0 is X: a diagonal term (|sig2n| in the fit,
//    0 for K) is added to kxx and kyy at i = j.  It computes every pair: a
//    symmetric mode that computed the tiles I >= J and wrote each mirror
//    tile through a shared-memory transpose moved the same bytes and was
//    slower on an H100 (0.087-0.101 ms against 0.084-0.092 ms at N = 4096),
//    so it was not kept.
//  * The contraction never forms dK.  The general entry reads Kbar and sums
//    the two mixed cotangents on load.  The fused entry reads S = Ky^{-1}
//    and alpha and forms 2 Kbar = S - alpha alpha^T on load (Kbar is never
//    stored).  With S symmetric and X0 = X every pair term is even under
//    (i, j) -> (j, i) (s, s'' and s' dP are), so it visits the tiles
//    I >= J only, counting off-diagonal tiles twice.  Its mixed cotangent
//    at (i, j) is g(N+i, j) + g(N+j, i): the lower-left block at (I, J)
//    and, read transposed through shared memory, at (J, I).  So it reads
//    the lower triangles of the xx and yy blocks and the whole lower-left
//    block: half of S.  The derivatives are evaluated from the same shared
//    factors as the build, without the common factors sig, -2/lx and
//    -2/ly, which the final pass applies once.  Each thread sums its 16
//    pairs in the data's type, then in double; warp shuffles and a
//    fixed-order pass over the warps give each block's four sums; a second
//    one-block pass adds the blocks in a fixed order.  No atomics: the
//    result is deterministic.
//  * Templated on float and double, the kind and (the contraction) the
//    mode.  Built without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kPerSe = 0;
constexpr int kSeSe = 1;
constexpr int kPerSeFreq = 2;
constexpr int kSumPerSe = 3;

constexpr int kTile = 64;          // pair tile: kTile rows x kTile columns
constexpr int kCols = 4;           // consecutive columns a thread owns
constexpr int kColThreads = kTile / kCols;      // 16 threads across a row
constexpr int kThreads = 256;
constexpr int kRowThreads = kThreads / kColThreads;  // 16
constexpr int kRows = kTile / kRowThreads;           // 4 rows a thread owns
constexpr int kPad = kTile + 1;    // row length of the contraction's transpose tile
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;
// the contraction's registers are capped for 3 blocks an SM (24 warps):
// the symmetric float32 instance otherwise takes 92 registers and 2 blocks,
// 15 % slower on an H100 at N = 4096
constexpr int kBwdBlocksPerSM = 3;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ void dsincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void dsincos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// 16-byte vector access of 4 consecutive values; the build's stores are
// streaming (evict-first: nothing reads K back before it leaves the L2).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
}
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// The first n (<= 4 or more) of 4 values at p: one vector when all 4 are
// inside and vec holds, else element by element; missing loads read 0.
template <typename T>
__device__ __forceinline__ void put4(T* p, const T (&v)[4], int n, bool vec) {
  if (vec && n >= kCols) {
    store4(p, v);
  } else {
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      if (m < n) p[m] = v[m];
    }
  }
}
template <typename T>
__device__ __forceinline__ void get4(const T* p, T (&v)[4], int n, bool vec) {
  if (vec && n >= kCols) {
    load4(p, v);
  } else {
#pragma unroll
    for (int m = 0; m < kCols; ++m) v[m] = m < n ? p[m] : T(0);
  }
}

template <typename T>
struct Scal {
  T lx, ly, sig, f, i2, ily2, jitter;
};

template <typename T>
__device__ __forceinline__ Scal<T> load_scal(const T* scal) {
  const T lx = scal[0], ly = scal[1];
  return {lx, ly, scal[2], scal[3], T(0.5) / (lx * lx), T(1) / (ly * ly),
          scal[4]};
}

// The tile's points in shared memory: side 0 the rows, side 1 the columns;
// q, P and, for the periodic kinds, sin and cos of f q.
template <typename T>
struct Points {
  T q[2][kTile], P[2][kTile], s[2][kTile], c[2][kTile];
};

// Threads 0 .. 2 kTile - 1 stage one point each; points past the edge are 0.
template <typename T, int KIND>
__device__ __forceinline__ void stage_points(const T* X, const T* X0, int N,
                                             int N0, int row0, int col0, T f,
                                             Points<T>& pt) {
  const int t = threadIdx.x;
  if (t >= 2 * kTile) return;
  const int side = t / kTile, k = t % kTile;
  const int idx = (side ? col0 : row0) + k;
  const T* src = side ? X0 : X;
  T q = T(0), P = T(0);
  if (idx < (side ? N0 : N)) {
    q = src[2 * size_t(idx)];
    P = src[2 * size_t(idx) + 1];
  }
  pt.q[side][k] = q;
  pt.P[side][k] = P;
  if constexpr (KIND != kSeSe) {
    T sn, cs;
    dsincos(f * q, &sn, &cs);
    pt.s[side][k] = sn;
    pt.c[side][k] = cs;
  }
}

// One point of a side, in registers.
template <typename T>
struct Pt {
  T q, P, s, c;
};

template <typename T>
__device__ __forceinline__ Pt<T> point(const Points<T>& pt, int side, int k) {
  return {pt.q[side][k], pt.P[side][k], pt.s[side][k], pt.c[side][k]};
}

// The q-factor A = exp(-s(dq)) with s, s', s'' and sh = sin(f dq),
// ch = cos(f dq) (0 and 1 for se_se); _tile_blocks of pallas_cov.py.  For
// the periodic kinds sh and ch come from the points' sin and cos:
// sin(a - b) = sin a cos b - cos a sin b, cos(a - b) = cos a cos b +
// sin a sin b.
template <typename T>
struct QF {
  T dq, dP, s, sp, spp, sh, ch;
};

template <typename T, int KIND>
__device__ __forceinline__ QF<T> qfactors(const Pt<T>& a, const Pt<T>& b,
                                          const Scal<T>& c) {
  const T dq = a.q - b.q, dP = a.P - b.P;
  if constexpr (KIND == kSeSe) {
    return {dq, dP, dq * dq * c.i2, T(2) * dq * c.i2, T(2) * c.i2, T(0),
            T(1)};
  } else {
    const T sh = a.s * b.c - a.c * b.s;
    const T ch = a.c * b.c + a.s * b.s;
    const T sh2 = sh * sh;
    return {dq, dP, sh2 * c.i2, (T(2) * c.f) * sh * ch * c.i2,
            (T(2) * c.f * c.f) * (T(1) - T(2) * sh2) * c.i2, sh, ch};
  }
}

// kxx, kxy, kyy of one pair: one exp (two for sum_per_se).
template <typename T, int KIND>
__device__ __forceinline__ void pair_blocks(const QF<T>& g, const Scal<T>& c,
                                            T& kxx, T& kxy, T& kyy) {
  const T t = g.dP * g.dP * (T(0.5) * c.ily2);
  const T h = c.ily2 - g.dP * g.dP * c.ily2 * c.ily2;
  const T D = g.spp - g.sp * g.sp;
  if constexpr (KIND == kSumPerSe) {
    kxx = D * (c.sig * dexp(-g.s));
    kxy = T(0);
    kyy = h * (c.sig * dexp(-t));
  } else {
    const T E = c.sig * dexp(-(g.s + t));  // one exp for both factors
    kxx = D * E;
    kxy = -g.sp * g.dP * c.ily2 * E;
    kyy = h * E;
  }
}

// Per pair: the four contraction terms without their common factors, added
// to acc:
//   acc[0] * sig * (-2/lx) = sum_blocks g * dk/dlx,
//   acc[1] * sig * (-2/ly) = sum_blocks g * dk/dly,
//   acc[2]                 = sum_blocks g * dk/dsig,
//   acc[3] * sig           = sum_blocks g * dk/df.
// With D = s'' - s'^2, v = 1/ly^2, t = dP^2 v / 2, h = v - dP^2 v^2 and
// E0 = exp(-(s + t)) (product kinds), s, s', s'' all scale with 1/lx^2 and
// t, v with 1/ly^2, which gives (kxx0 = D E0, kxy0 = -s' dP v E0,
// kyy0 = h E0)
//   dkxx0/dlx = (-2/lx) E0 (s'' - 2 s'^2 - s D)
//   dkxy0/dlx = (-2/lx) kxy0 (1 - s)
//   dkyy0/dlx = (-2/lx) (-s) kyy0
//   dkxx0/dly = (-2/ly) (-t) kxx0
//   dkxy0/dly = (-2/ly) kxy0 (1 - t)
//   dkyy0/dly = (-2/ly) E0 (v - 2 dP^2 v^2 - t h)
// and, for the periodic kinds with u = 1/(2 lx^2), sh = sin(f dq),
// ch = cos(f dq):
//   ds/df   = 2 u sh ch dq
//   ds'/df  = 2 u sh ch + 2 f u (1 - 2 sh^2) dq
//   ds''/df = 4 f u (1 - 2 sh^2) - 8 f^2 u sh ch dq.
// The sum kind has A0 = exp(-s) on the q block and B0 = exp(-t) on the P
// block instead of E0, and no mixed block.  Every term is even under
// (i, j) -> (j, i): s, s'', ds/df, ds''/df and D are even in dq, s', ds'/df
// odd, and each odd factor comes with dP or another odd factor.
template <typename T, int KIND>
__device__ __forceinline__ void pair_terms(const QF<T>& g, const Scal<T>& c,
                                           T gxx, T gxy, T gyy, T (&acc)[4]) {
  const T v = c.ily2;
  const T dP2 = g.dP * g.dP;
  const T t = dP2 * (T(0.5) * v);
  const T h = v - dP2 * v * v;
  const T D = g.spp - g.sp * g.sp;
  T ds = T(0), dsp = T(0), dspp = T(0);
  if constexpr (KIND != kSeSe) {
    const T shch = g.sh * g.ch;
    const T cos2 = T(1) - T(2) * g.sh * g.sh;
    ds = T(2) * c.i2 * shch * g.dq;
    dsp = T(2) * c.i2 * shch + T(2) * c.f * c.i2 * cos2 * g.dq;
    dspp = T(4) * c.f * c.i2 * cos2 - T(8) * c.f * c.f * c.i2 * shch * g.dq;
  }
  const T dD = dspp - T(2) * g.sp * dsp;
  if constexpr (KIND == kSumPerSe) {
    const T A0 = dexp(-g.s), B0 = dexp(-t);
    const T kxx0 = D * A0, kyy0 = h * B0;
    acc[0] += gxx * A0 * (g.spp - T(2) * g.sp * g.sp - g.s * D);
    acc[1] += gyy * B0 * (v - T(2) * dP2 * v * v - t * h);
    acc[2] += gxx * kxx0 + gyy * kyy0;
    acc[3] += gxx * (dD * A0 - kxx0 * ds);
  } else {
    const T E0 = dexp(-(g.s + t));
    const T kxx0 = D * E0;
    const T kxy0 = -g.sp * g.dP * v * E0;
    const T kyy0 = h * E0;
    acc[0] += gxx * E0 * (g.spp - T(2) * g.sp * g.sp - g.s * D) +
              gxy * kxy0 * (T(1) - g.s) - gyy * kyy0 * g.s;
    acc[1] += -gxx * kxx0 * t + gxy * kxy0 * (T(1) - t) +
              gyy * E0 * (v - T(2) * dP2 * v * v - t * h);
    acc[2] += gxx * kxx0 + gxy * kxy0 + gyy * kyy0;
    acc[3] += gxx * (dD * E0 - kxx0 * ds) -
              gxy * g.dP * v * E0 * (dsp - g.sp * ds) - gyy * kyy0 * ds;
  }
}

// The contraction block's tile (I, J): the grid's (y, x) in the general
// mode; in the symmetric mode the linear block index b = I (I + 1) / 2 + J,
// J <= I.
template <bool SYM>
__device__ __forceinline__ void tile_of(int& I, int& J) {
  if constexpr (!SYM) {
    I = int(blockIdx.y);
    J = int(blockIdx.x);
  } else {
    const long long b = blockIdx.x;
    long long i = (long long)((sqrt(8.0 * double(b) + 1.0) - 1.0) * 0.5);
    while (i * (i + 1) / 2 > b) --i;
    while ((i + 1) * (i + 2) / 2 <= b) ++i;
    I = int(i);
    J = int(b - i * (i + 1) / 2);
  }
}

__device__ __forceinline__ int linear_block() {
  return int(blockIdx.y) * int(gridDim.x) + int(blockIdx.x);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    cov_fwd_kernel(const T* __restrict__ scal, const T* __restrict__ X,
                   const T* __restrict__ X0, T* __restrict__ K, int N, int N0,
                   int vec) {
  __shared__ Points<T> pt;
  const int row0 = int(blockIdx.y) * kTile, col0 = int(blockIdx.x) * kTile;
  const Scal<T> c = load_scal(scal);
  stage_points<T, KIND>(X, X0, N, N0, row0, col0, c.f, pt);
  __syncthreads();

  const int tx = int(threadIdx.x) % kColThreads;
  const int ty = int(threadIdx.x) / kColThreads;
  const int cj = kCols * tx;  // the thread's first column in the tile
  const size_t ld = 2 * size_t(N0);
  Pt<T> col[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) col[m] = point(pt, 1, cj + m);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = ty + kRowThreads * k;
    const int i = row0 + r;
    const Pt<T> row = point(pt, 0, r);
    T kxx[kCols], kxy[kCols], kyy[kCols];
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      pair_blocks<T, KIND>(qfactors<T, KIND>(row, col[m], c), c, kxx[m],
                           kxy[m], kyy[m]);
      if (i == col0 + cj + m) {  // the diagonal of Ky (jitter 0 for K)
        kxx[m] += c.jitter;
        kyy[m] += c.jitter;
      }
    }
    if (i < N) {
      const int n = N0 - (col0 + cj);
      T* top = K + size_t(i) * ld + col0 + cj;
      T* bot = K + size_t(N + i) * ld + col0 + cj;
      put4(top, kxx, n, vec);
      put4(top + N0, kxy, n, vec);
      put4(bot, kxy, n, vec);
      put4(bot + N0, kyy, n, vec);
    }
  }
}

__device__ __forceinline__ void warp_sum4(double (&a)[4]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] += __shfl_down_sync(0xffffffffu, a[k], off);
  }
}

// The four sums over the block, in thread 0's a; a fixed order throughout.
template <int NW>
__device__ __forceinline__ void block_sum4(double (&a)[4],
                                           double (&red)[NW][4]) {
  warp_sum4(a);
  const int lane = int(threadIdx.x) % 32, w = int(threadIdx.x) / 32;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) red[w][k] = a[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      double s = 0.0;
      for (int q = 0; q < NW; ++q) s += red[q][k];
      a[k] = s;
    }
  }
}

// General mode: G is Kbar (2N, 2N0) and alpha is unused.  Symmetric mode
// (X0 = X, N0 = N): G is S = Ky^{-1} (2N, 2N), symmetric, and the pair
// cotangents are those of 2 Kbar = S - alpha alpha^T; each block's sums are
// scaled by 1/2 (diagonal tiles) or 1 (off-diagonal tiles, counted twice).
template <typename T, int KIND, bool SYM>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
    cov_bwd_kernel(const T* __restrict__ scal, const T* __restrict__ X,
                   const T* __restrict__ X0, const T* __restrict__ G,
                   const T* __restrict__ alpha, double* __restrict__ partial,
                   int N, int N0, int vec) {
  __shared__ Points<T> pt;
  __shared__ T tr[SYM ? kTile : 1][kPad];
  __shared__ T al[SYM ? 4 : 1][kTile];
  __shared__ double red[kWarps][4];
  int I, J;
  tile_of<SYM>(I, J);
  const int row0 = I * kTile, col0 = J * kTile;
  const Scal<T> c = load_scal(scal);
  stage_points<T, KIND>(X, X0, N, N0, row0, col0, c.f, pt);

  const int tx = int(threadIdx.x) % kColThreads;
  const int ty = int(threadIdx.x) / kColThreads;
  const int cj = kCols * tx;
  const size_t ld = 2 * size_t(N0);
  if constexpr (SYM) {
    const int t = int(threadIdx.x);
    if (t < 2 * kTile) {  // alpha_i, alpha_{N+i} (rows); the same (columns)
      const int side = t / kTile, k = t % kTile;
      const int idx = (side ? col0 : row0) + k;
      const bool in = idx < N;
      al[2 * side][k] = in ? alpha[idx] : T(0);
      al[2 * side + 1][k] = in ? alpha[N + idx] : T(0);
    }
    // the lower-left block at the mirror tile (J, I): tr[jr][ir] =
    // S[N + col0 + jr, row0 + ir]
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int jr = ty + kRowThreads * k;
      T w[kCols];
      if (col0 + jr < N) {
        get4(G + size_t(N + col0 + jr) * ld + row0 + cj, w, N - (row0 + cj),
             vec);
      } else {
#pragma unroll
        for (int m = 0; m < kCols; ++m) w[m] = T(0);
      }
#pragma unroll
      for (int m = 0; m < kCols; ++m) tr[jr][cj + m] = w[m];
    }
  }
  __syncthreads();

  Pt<T> col[kCols];
  T aj[kCols], aNj[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    col[m] = point(pt, 1, cj + m);
    if constexpr (SYM) {
      aj[m] = al[2][cj + m];
      aNj[m] = al[3][cj + m];
    }
  }
  const int n = N0 - (col0 + cj);
  T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = ty + kRowThreads * k;
    const int i = row0 + r;
    if (i >= N) continue;
    const T* top = G + size_t(i) * ld + col0 + cj;
    const T* bot = G + size_t(N + i) * ld + col0 + cj;
    T gxx[kCols], gyy[kCols], gxy[kCols];
    get4(top, gxx, n, vec);
    get4(bot + N0, gyy, n, vec);
    get4(bot, gxy, n, vec);
    if constexpr (!SYM) {
      T up[kCols];
      get4(top + N0, up, n, vec);
#pragma unroll
      for (int m = 0; m < kCols; ++m) gxy[m] += up[m];
    }
    const Pt<T> row = point(pt, 0, r);
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      if (m >= n) break;
      T a = gxx[m], b = gxy[m], d = gyy[m];
      if constexpr (SYM) {
        const T ai = al[0][r], aNi = al[1][r];
        a -= ai * aj[m];
        d -= aNi * aNj[m];
        b += tr[cj + m][r] - aNi * aj[m] - aNj[m] * ai;
      }
      pair_terms<T, KIND>(qfactors<T, KIND>(row, col[m], c), c, a, b, d, acc);
    }
  }
  const double w = SYM ? (I == J ? 0.5 : 1.0) : 1.0;
  double s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = w * double(acc[k]);
  block_sum4(s, red);
  if (threadIdx.x == 0) {
    const size_t b = size_t(linear_block());
#pragma unroll
    for (int k = 0; k < 4; ++k) partial[4 * b + k] = s[k];
  }
}

// Second pass: one block adds the (nblocks, 4) partial sums in a fixed
// order and applies the common factors; out = (dlx, dly, dsig, df).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    cov_reduce_kernel(const T* __restrict__ scal,
                      const double* __restrict__ partial, int nblocks,
                      double* __restrict__ out) {
  __shared__ double red[kReduceThreads / 32][4];
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int b = int(threadIdx.x); b < nblocks; b += kReduceThreads) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += partial[4 * size_t(b) + k];
  }
  block_sum4(acc, red);
  if (threadIdx.x == 0) {
    const double lx = double(scal[0]), ly = double(scal[1]);
    const double sig = double(scal[2]);
    out[0] = acc[0] * sig * (-2.0 / lx);
    out[1] = acc[1] * sig * (-2.0 / ly);
    out[2] = acc[2];
    out[3] = acc[3] * sig;
  }
}

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

// The launch grid: all tiles (general) or the tiles I >= J (symmetric).
inline dim3 pair_grid(int N, int N0, bool sym) {
  if (sym) return dim3(unsigned(tiles(N) * (tiles(N) + 1) / 2));
  return dim3(unsigned(tiles(N0)), unsigned(tiles(N)));
}

// 16-byte vectors need rows (2 N0 values), the mixed block's offset (N0)
// and the base on the 16-byte grid.
template <typename T>
inline int vec_ok(const void* base, int N0) {
  return (size_t(N0) * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

template <typename T, int KIND>
cudaError_t launch_fwd(const T* scal, const T* X, const T* X0, T* K, int N,
                       int N0, cudaStream_t s) {
  cov_fwd_kernel<T, KIND><<<pair_grid(N, N0, false), kThreads, 0, s>>>(
      scal, X, X0, K, N, N0, vec_ok<T>(K, N0));
  return cudaGetLastError();
}

template <typename T, int KIND, bool SYM>
cudaError_t launch_bwd(const T* scal, const T* X, const T* X0, const T* G,
                       const T* alpha, double* partial, double* out, int N,
                       int N0, cudaStream_t s) {
  const dim3 grid = pair_grid(N, N0, SYM);
  cov_bwd_kernel<T, KIND, SYM><<<grid, kThreads, 0, s>>>(
      scal, X, X0, G, alpha, partial, N, N0, vec_ok<T>(G, N0));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cov_reduce_kernel<T><<<1, kReduceThreads, 0, s>>>(
      scal, partial, int(grid.x * grid.y), out);
  return cudaGetLastError();
}

template <typename T>
int fwd(const T* scal, const T* X, const T* X0, T* K, int N, int N0, int kind,
        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kPerSe: return int(launch_fwd<T, kPerSe>(scal, X, X0, K, N, N0, s));
    case kSeSe: return int(launch_fwd<T, kSeSe>(scal, X, X0, K, N, N0, s));
    case kPerSeFreq:
      return int(launch_fwd<T, kPerSeFreq>(scal, X, X0, K, N, N0, s));
    case kSumPerSe:
      return int(launch_fwd<T, kSumPerSe>(scal, X, X0, K, N, N0, s));
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T, bool SYM>
int bwd(const T* scal, const T* X, const T* X0, const T* G, const T* alpha,
        double* partial, double* out, int N, int N0, int kind,
        cudaStream_t s) {
  switch (kind) {
    case kPerSe:
      return int(launch_bwd<T, kPerSe, SYM>(scal, X, X0, G, alpha, partial,
                                            out, N, N0, s));
    case kSeSe:
      return int(launch_bwd<T, kSeSe, SYM>(scal, X, X0, G, alpha, partial,
                                           out, N, N0, s));
    case kPerSeFreq:
      return int(launch_bwd<T, kPerSeFreq, SYM>(scal, X, X0, G, alpha,
                                                partial, out, N, N0, s));
    case kSumPerSe:
      return int(launch_bwd<T, kSumPerSe, SYM>(scal, X, X0, G, alpha,
                                               partial, out, N, N0, s));
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int bwd(const T* scal, const T* X, const T* X0, const T* G, const T* alpha,
        double* partial, double* out, int N, int N0, int kind, int sym,
        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sym) {
    if (N0 != N || X0 != X || alpha == nullptr) {
      return int(cudaErrorInvalidValue);
    }
    return bwd<T, true>(scal, X, X, G, alpha, partial, out, N, N, kind, s);
  }
  return bwd<T, false>(scal, X, X0, G, alpha, partial, out, N, N0, kind, s);
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer: scal is
// (lx, ly, sig, f, jitter) in the data's type (the build adds jitter where
// i = j, which is the diagonal when X0 is X; pass 0 otherwise), X (N, 2)
// and X0 (N0, 2) row-major points, K and G (2N, 2N0) row-major, alpha (2N,)
// (symmetric contraction only; may be null otherwise), partial a scratch
// buffer of 4 doubles per block of the contraction's grid (ceil(N/64)
// ceil(N0/64), or t (t + 1) / 2 with t = ceil(N/64) in the symmetric mode),
// out 4 doubles (dlx, dly, dsig, df).  sym = 1 selects the symmetric
// contraction, which needs X0 == X and N0 == N.  The return value is the
// cudaError_t of the launches (0 on success).
extern "C" int cov_fwd_f32(const float* scal, const float* X, const float* X0,
                           float* K, int N, int N0, int kind, void* stream) {
  return fwd<float>(scal, X, X0, K, N, N0, kind, stream);
}

extern "C" int cov_fwd_f64(const double* scal, const double* X,
                           const double* X0, double* K, int N, int N0,
                           int kind, void* stream) {
  return fwd<double>(scal, X, X0, K, N, N0, kind, stream);
}

extern "C" int cov_bwd_f32(const float* scal, const float* X, const float* X0,
                           const float* G, const float* alpha,
                           double* partial, double* out, int N, int N0,
                           int kind, int sym, void* stream) {
  return bwd<float>(scal, X, X0, G, alpha, partial, out, N, N0, kind, sym,
                    stream);
}

extern "C" int cov_bwd_f64(const double* scal, const double* X,
                           const double* X0, const double* G,
                           const double* alpha, double* partial, double* out,
                           int N, int N0, int kind, int sym, void* stream) {
  return bwd<double>(scal, X, X0, G, alpha, partial, out, N, N0, kind, sym,
                     stream);
}
