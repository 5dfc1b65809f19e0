// Derivative-observation covariance on Hopper (sm_90a): the tiled build of
// the (2N, 2N0) matrix and the contraction of its hyperparameter gradient.
//
// Replaces two Pallas kernels of sympgpr_tpu/ops/pallas_cov.py:
//  * _cov_tile (pallas_cov.py:88, with _tile_blocks :57) -> cov_fwd_kernel;
//  * _cov_bwd_tile (pallas_cov.py:187) -> cov_bwd_kernel + cov_reduce_kernel.
// The plain PyTorch versions are build_K_blocks_reference and
// cov_param_grads_reference in sympgpr_tpu_torch/ops/cuda_cov.py; the
// derivative formulas of the contraction are written out there too and held
// against autograd on the CPU.
//
// Layout (sympgpr_tpu_torch/gp/covariance.py): K[r*N + i, c*N0 + j] with
// component 0 = q and 1 = P; the two mixed blocks are equal elementwise for
// these stationary kernels.  Kinds: 0 per_se (periodic q-factor at
// frequency 1/2), 1 se_se, 2 per_se_freq, 3 sum_per_se (separable sum: the
// mixed block is zero and each diagonal block carries its own exp and sig).
//
// What bounds them: device-memory bytes.  The build writes 4 values per
// pair (16 B in float32) from one sincos and one exp; the contraction reads
// 4 cotangents per pair.  At N = 4096 that is 268 MB each way, ~80 us at
// 3.35 TB/s, while the arithmetic (~60 flops and two transcendentals per
// pair, 1.7e7 pairs) is a few us of the card's float32 rate.
//
// Design (first version, right before fast):
//  * One thread per (i, j) pair within a 32 x 32 pair tile; a block of
//    32 x 8 threads walks the tile's rows 8 at a time.  The tile's row and
//    column coordinates are staged in shared memory.  Neighbouring threads
//    hold neighbouring columns, so every store (and every cotangent load) of
//    a warp is 32 consecutive values.
//  * The build writes kxx, kxy (to both mixed positions) and kyy straight
//    into the (2N, 2N0) layout: no block temporaries, no assembly copy.  The
//    ragged edge is masked, not padded.
//  * The contraction never forms dK.  The two mixed cotangents are summed on
//    load; per pair the derivatives of the closed forms are evaluated from
//    the same shared factors as the build, without the common factors sig,
//    -2/lx and -2/ly, which the final pass applies once.  Each thread
//    accumulates in double; each block reduces in shared memory and writes
//    its four sums to a (blocks, 4) buffer; a second one-block pass adds the
//    buffer in a fixed order.  No atomics: the result is deterministic.
//  * Templated on float and double.  Built without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kPerSe = 0;
constexpr int kSeSe = 1;
constexpr int kPerSeFreq = 2;
constexpr int kSumPerSe = 3;

constexpr int kTile = 32;        // pair tile: kTile rows x kTile columns
constexpr int kRowStep = 8;      // blockDim = (kTile, kRowStep)
constexpr int kThreads = kTile * kRowStep;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ void dsincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void dsincos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// The q-factor A = exp(-s(dq)) with s, s', s'' (and sin/cos of f*dq for
// the frequency derivative); _tile_blocks of pallas_cov.py.
template <typename T>
struct QF {
  T s, sp, spp, sh, ch;
};

template <int KIND, typename T>
__device__ __forceinline__ QF<T> qfactors(T dq, T i2, T f) {
  if constexpr (KIND == kSeSe) {
    return {dq * dq * i2, T(2) * dq * i2, T(2) * i2, T(0), T(1)};
  } else {
    T sh, ch;
    dsincos(f * dq, &sh, &ch);
    const T sh2 = sh * sh;
    return {sh2 * i2, (T(2) * f) * sh * ch * i2,
            (T(2) * f * f) * (T(1) - T(2) * sh2) * i2, sh, ch};
  }
}

template <typename T>
struct Scal {
  T lx, ly, sig, f, i2, ily2;
};

template <typename T>
__device__ __forceinline__ Scal<T> load_scal(const T* scal) {
  const T lx = scal[0], ly = scal[1];
  return {lx, ly, scal[2], scal[3], T(0.5) / (lx * lx), T(1) / (ly * ly)};
}

// Stage the tile's row points (first kTile threads) and column points (next
// kTile threads) in shared memory; points past the edge read as 0.
template <typename T>
__device__ __forceinline__ void stage(const T* X, const T* X0, int N, int N0,
                                      int row0, int col0, T* qr, T* Pr, T* qc,
                                      T* Pc) {
  const int t = threadIdx.y * kTile + threadIdx.x;
  if (t < kTile) {
    const int i = row0 + t;
    qr[t] = i < N ? X[2 * size_t(i)] : T(0);
    Pr[t] = i < N ? X[2 * size_t(i) + 1] : T(0);
  } else if (t < 2 * kTile) {
    const int j = col0 + t - kTile;
    qc[t - kTile] = j < N0 ? X0[2 * size_t(j)] : T(0);
    Pc[t - kTile] = j < N0 ? X0[2 * size_t(j) + 1] : T(0);
  }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    cov_fwd_kernel(const T* __restrict__ scal, const T* __restrict__ X,
                   const T* __restrict__ X0, T* __restrict__ K, int N,
                   int N0) {
  __shared__ T qr[kTile], Pr[kTile], qc[kTile], Pc[kTile];
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  stage(X, X0, N, N0, row0, col0, qr, Pr, qc, Pc);
  __syncthreads();

  const Scal<T> c = load_scal(scal);
  const int j = col0 + threadIdx.x;
  if (j >= N0) return;
  const size_t ld = 2 * size_t(N0);
  const T q0 = qc[threadIdx.x], P0 = Pc[threadIdx.x];
  for (int r = threadIdx.y; r < kTile; r += kRowStep) {
    const int i = row0 + r;
    if (i >= N) break;
    const T dq = qr[r] - q0, dP = Pr[r] - P0;
    const QF<T> g = qfactors<KIND>(dq, c.i2, c.f);
    const T t = dP * dP * (T(0.5) * c.ily2);
    const T h = c.ily2 - dP * dP * c.ily2 * c.ily2;
    const T D = g.spp - g.sp * g.sp;
    T kxx, kxy, kyy;
    if constexpr (KIND == kSumPerSe) {
      kxx = D * (c.sig * dexp(-g.s));
      kxy = T(0);
      kyy = h * (c.sig * dexp(-t));
    } else {
      const T E = c.sig * dexp(-(g.s + t));  // one exp for both factors
      kxx = D * E;
      kxy = -g.sp * dP * c.ily2 * E;
      kyy = h * E;
    }
    T* top = K + size_t(i) * ld + j;
    T* bot = K + size_t(N + i) * ld + j;
    top[0] = kxx;
    top[N0] = kxy;
    bot[0] = kxy;
    bot[N0] = kyy;
  }
}

// Per pair: the four contraction terms without their common factors,
//   o[0] * sig * (-2/lx) = sum_blocks g * dk/dlx,
//   o[1] * sig * (-2/ly) = sum_blocks g * dk/dly,
//   o[2]                 = sum_blocks g * dk/dsig,
//   o[3] * sig           = sum_blocks g * dk/df.
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
// block instead of E0, and no mixed block.
template <typename T, int KIND>
__device__ __forceinline__ void pair_terms(T dq, T dP, const Scal<T>& c,
                                           T gxx, T gxy, T gyy, T* o) {
  const QF<T> g = qfactors<KIND>(dq, c.i2, c.f);
  const T v = c.ily2;
  const T dP2 = dP * dP;
  const T t = dP2 * (T(0.5) * v);
  const T h = v - dP2 * v * v;
  const T D = g.spp - g.sp * g.sp;
  T ds = T(0), dsp = T(0), dspp = T(0);
  if constexpr (KIND != kSeSe) {
    const T shch = g.sh * g.ch;
    const T cos2 = T(1) - T(2) * g.sh * g.sh;
    ds = T(2) * c.i2 * shch * dq;
    dsp = T(2) * c.i2 * shch + T(2) * c.f * c.i2 * cos2 * dq;
    dspp = T(4) * c.f * c.i2 * cos2 - T(8) * c.f * c.f * c.i2 * shch * dq;
  }
  const T dD = dspp - T(2) * g.sp * dsp;
  if constexpr (KIND == kSumPerSe) {
    const T A0 = dexp(-g.s), B0 = dexp(-t);
    const T kxx0 = D * A0, kyy0 = h * B0;
    o[0] = gxx * A0 * (g.spp - T(2) * g.sp * g.sp - g.s * D);
    o[1] = gyy * B0 * (v - T(2) * dP2 * v * v - t * h);
    o[2] = gxx * kxx0 + gyy * kyy0;
    o[3] = gxx * (dD * A0 - kxx0 * ds);
  } else {
    const T E0 = dexp(-(g.s + t));
    const T kxx0 = D * E0;
    const T kxy0 = -g.sp * dP * v * E0;
    const T kyy0 = h * E0;
    o[0] = gxx * E0 * (g.spp - T(2) * g.sp * g.sp - g.s * D) +
           gxy * kxy0 * (T(1) - g.s) - gyy * kyy0 * g.s;
    o[1] = -gxx * kxx0 * t + gxy * kxy0 * (T(1) - t) +
           gyy * E0 * (v - T(2) * dP2 * v * v - t * h);
    o[2] = gxx * kxx0 + gxy * kxy0 + gyy * kyy0;
    o[3] = gxx * (dD * E0 - kxx0 * ds) - gxy * dP * v * E0 * (dsp - g.sp * ds) -
           gyy * kyy0 * ds;
  }
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    cov_bwd_kernel(const T* __restrict__ scal, const T* __restrict__ X,
                   const T* __restrict__ X0, const T* __restrict__ Kbar,
                   double* __restrict__ partial, int N, int N0) {
  __shared__ T qr[kTile], Pr[kTile], qc[kTile], Pc[kTile];
  __shared__ double red[4][kThreads];
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  stage(X, X0, N, N0, row0, col0, qr, Pr, qc, Pc);
  __syncthreads();

  const Scal<T> c = load_scal(scal);
  const int j = col0 + threadIdx.x;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  if (j < N0) {
    const size_t ld = 2 * size_t(N0);
    const T q0 = qc[threadIdx.x], P0 = Pc[threadIdx.x];
    for (int r = threadIdx.y; r < kTile; r += kRowStep) {
      const int i = row0 + r;
      if (i >= N) break;
      const T* top = Kbar + size_t(i) * ld + j;
      const T* bot = Kbar + size_t(N + i) * ld + j;
      const T gxx = top[0];
      const T gxy = top[N0] + bot[0];  // both mixed blocks share one value
      const T gyy = bot[N0];
      T o[4];
      pair_terms<T, KIND>(qr[r] - q0, Pr[r] - P0, c, gxx, gxy, gyy, o);
      for (int k = 0; k < 4; ++k) acc[k] += double(o[k]);
    }
  }
  const int t = threadIdx.y * kTile + threadIdx.x;
  for (int k = 0; k < 4; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      for (int k = 0; k < 4; ++k) red[k][t] += red[k][t + w];
    }
    __syncthreads();
  }
  if (t < 4) {
    partial[4 * (size_t(blockIdx.y) * gridDim.x + blockIdx.x) + t] = red[t][0];
  }
}

// Second pass: one block adds the (nblocks, 4) partial sums in a fixed
// order and applies the common factors; out = (dlx, dly, dsig, df).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    cov_reduce_kernel(const T* __restrict__ scal,
                      const double* __restrict__ partial, int nblocks,
                      double* __restrict__ out) {
  __shared__ double red[4][kReduceThreads];
  const int t = threadIdx.x;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int b = t; b < nblocks; b += kReduceThreads) {
    for (int k = 0; k < 4; ++k) acc[k] += partial[4 * size_t(b) + k];
  }
  for (int k = 0; k < 4; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (t < w) {
      for (int k = 0; k < 4; ++k) red[k][t] += red[k][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    const double lx = double(scal[0]), ly = double(scal[1]);
    const double sig = double(scal[2]);
    out[0] = red[0][0] * sig * (-2.0 / lx);
    out[1] = red[1][0] * sig * (-2.0 / ly);
    out[2] = red[2][0];
    out[3] = red[3][0] * sig;
  }
}

inline dim3 pair_grid(int N, int N0) {
  return dim3(unsigned((N0 + kTile - 1) / kTile),
              unsigned((N + kTile - 1) / kTile));
}

template <typename T, int KIND>
cudaError_t launch_fwd(const T* scal, const T* X, const T* X0, T* K, int N,
                       int N0, cudaStream_t s) {
  cov_fwd_kernel<T, KIND><<<pair_grid(N, N0), dim3(kTile, kRowStep), 0, s>>>(
      scal, X, X0, K, N, N0);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_bwd(const T* scal, const T* X, const T* X0, const T* Kbar,
                       double* partial, double* out, int N, int N0,
                       cudaStream_t s) {
  const dim3 grid = pair_grid(N, N0);
  cov_bwd_kernel<T, KIND><<<grid, dim3(kTile, kRowStep), 0, s>>>(
      scal, X, X0, Kbar, partial, N, N0);
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

template <typename T>
int bwd(const T* scal, const T* X, const T* X0, const T* Kbar,
        double* partial, double* out, int N, int N0, int kind, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kPerSe:
      return int(launch_bwd<T, kPerSe>(scal, X, X0, Kbar, partial, out, N,
                                       N0, s));
    case kSeSe:
      return int(launch_bwd<T, kSeSe>(scal, X, X0, Kbar, partial, out, N, N0,
                                      s));
    case kPerSeFreq:
      return int(launch_bwd<T, kPerSeFreq>(scal, X, X0, Kbar, partial, out,
                                           N, N0, s));
    case kSumPerSe:
      return int(launch_bwd<T, kSumPerSe>(scal, X, X0, Kbar, partial, out, N,
                                          N0, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer: scal is
// (lx, ly, sig, f) in the data's type, X (N, 2) and X0 (N0, 2) row-major
// points, K and Kbar (2N, 2N0) row-major, partial a scratch buffer of
// 4 * ceil(N/32) * ceil(N0/32) doubles, out 4 doubles (dlx, dly, dsig, df).
// The return value is the cudaError_t of the launches (0 on success).
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
                           const float* Kbar, double* partial, double* out,
                           int N, int N0, int kind, void* stream) {
  return bwd<float>(scal, X, X0, Kbar, partial, out, N, N0, kind, stream);
}

extern "C" int cov_bwd_f64(const double* scal, const double* X,
                           const double* X0, const double* Kbar,
                           double* partial, double* out, int N, int N0,
                           int kind, void* stream) {
  return bwd<double>(scal, X, X0, Kbar, partial, out, N, N0, kind, stream);
}
