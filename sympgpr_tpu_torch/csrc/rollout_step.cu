// Fused symplectic-map rollout on Hopper (sm_90a): the whole nm-step
// iteration of the learned map for a batch of orbits in one launch.
//
// Replaces sympgpr_tpu/ops/pallas_step.py::_rollout_kernel (with its helpers
// _sfactors and _tokamak_lost) in the configuration the tokamak workload
// runs: implicit map, product kernels per_se / se_se / per_se_freq (kinds
// 0, 1, 2), aux-GP warm start, `iters` fixed Newton iterations that keep P
// where an update is non-finite, the tokamak loss check at the old q,
// the mod_q wrap, NaN poisoning of lost orbits, single map.  Row 0 of the
// trajectory is the initial condition.  The plain PyTorch version is
// sympgpr_tpu_torch/ops/cuda_step.py::rollout_reference.
//
// What bounds it: transcendentals and the arithmetic around them, not
// bytes.  Per orbit and step the math needs about (2 + iters) * N exps plus
// the sin/cos of the periodic q-factor for each of the N training points,
// against two values written to device memory.
//
// Design (first version, right before fast):
//  * One thread per orbit, 128 threads per block; the ragged edge of the
//    batch is masked, so the batch needs no padding.
//  * Each block stages the model columns (uq, uP, a0, a1, auxq, auxp, auxa)
//    in shared memory once, together with sin/cos of h(u) for every
//    training point (h(x) = x/2 for per_se, f*x for per_se_freq).  All
//    threads of a warp read the same column entry: a broadcast.
//  * The time loop and the Newton loop run inside the kernel.
//  * The Newton-invariant coefficients c0..c3 are recomputed in every
//    Newton iteration rather than cached: one thread cannot hold N of them
//    in registers, and 128 threads x N x 4 of them overflow shared memory
//    already at N = 80 in float64.  The recompute costs no transcendental:
//    sin/cos of h(u - q) come from the angle-difference identity
//      sin(h(u) - h(q)) = su*cq - cu*sq,  cos(h(u) - h(q)) = cu*cq + su*sq
//    with su, cu staged per training point and sq, cq taken once per orbit
//    and step, and A(dq) * B(dP) is one exp of the summed exponents.  So a
//    pair costs one exp and about twenty multiply-adds per Newton
//    iteration; the only per-pair transcendental left is that exp.
//  * Each step writes one row of Q and one of P; neighbouring threads hold
//    neighbouring orbits, so the stores are coalesced.
//  * Templated on float and double.  Built without --use_fast_math: the
//    float posterior sums already carry ~1e-4 cancellation noise, so the
//    full-precision expf/sincosf (and exp/sincos) are used.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerSe = 0;
constexpr int kSeSe = 1;
constexpr int kPerSeFreq = 2;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dfloor(float x) { return floorf(x); }
__device__ __forceinline__ double dfloor(double x) { return floor(x); }
__device__ __forceinline__ void dsincos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void dsincos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// h(x) of the periodic kinds: the q-factor is sin^2(h(d)) / (2 lx^2).
template <int KIND, typename T>
__device__ __forceinline__ T angle(T x, T freq) {
  return KIND == kPerSe ? T(0.5) * x : freq * x;
}

template <typename T>
struct QF {
  T s, sp, spp;  // s, s', s'' of A = exp(-s)
};

// Port of pallas_step._sfactors.  d = u - q (used by se_se only); sh, ch =
// sin/cos of h(d) (periodic kinds only); i2 = 1 / (2 lx^2).
template <int KIND, typename T>
__device__ __forceinline__ QF<T> qfactors(T d, T sh, T ch, T i2, T freq) {
  if constexpr (KIND == kPerSe) {
    const T s2 = sh * sh;
    return {s2 * i2, (sh * ch) * i2, (T(0.5) - s2) * i2};
  } else if constexpr (KIND == kPerSeFreq) {
    const T s2 = sh * sh;
    return {s2 * i2, (T(2) * freq) * (sh * ch) * i2,
            (T(2) * freq * freq) * (T(1) - T(2) * s2) * i2};
  } else {
    return {d * d * i2, d * (T(2) * i2), T(2) * i2};
  }
}

// Port of pallas_step._tokamak_lost: r from pth = Ath(r, th) by 20 Newton
// steps with cos(th) hoisted; lost when r > 0.5 or P < 0.
template <typename T>
__device__ __forceinline__ bool tokamak_lost(T P, T th) {
  const T pth = P * T(1e-2);
  const T ct = dcos(th);
  T r = T(0.3);
#pragma unroll 4
  for (int k = 0; k < 20; ++k) {
    const T y = pth - (r * r / T(2) - r * r * r / T(3) * ct);
    const T dy = -(r - r * r * ct);
    r = r - y / dy;
  }
  return (r > T(0.5)) || (P < T(0));
}

template <typename T>
struct Args {
  const T* scal;  // lx, ly, alx, aly, delta, mod_q, freq, afreq (as packed)
  const T* uq;
  const T* uP;
  const T* a0;    // sig * alpha_dq
  const T* a1;    // sig * alpha_dP
  const T* auxq;
  const T* auxp;
  const T* auxa;  // sig_aux * alpha_aux
  const T* q0;
  const T* p0;
  T* Q;  // (nm, B)
  T* P;  // (nm, B)
  int B, ns, nas, nm, iters, loss_check;
};

template <typename T, int KIND, int AUX_KIND>
__global__ void __launch_bounds__(kThreads) rollout_kernel(Args<T> a) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ns = a.ns, nas = a.nas;
  T* s_uq = sm;
  T* s_uP = s_uq + ns;
  T* s_a0 = s_uP + ns;
  T* s_a1 = s_a0 + ns;
  T* s_su = s_a1 + ns;
  T* s_cu = s_su + ns;
  T* s_xq = s_cu + ns;
  T* s_xp = s_xq + nas;
  T* s_xa = s_xp + nas;
  T* s_xs = s_xa + nas;
  T* s_xc = s_xs + nas;

  const T lx = a.scal[0], ly = a.scal[1], alx = a.scal[2], aly = a.scal[3];
  const T delta = a.scal[4], mod_q = a.scal[5];
  const T freq = a.scal[6], afreq = a.scal[7];
  const T i2 = T(0.5) / (lx * lx);
  const T ai2 = T(0.5) / (alx * alx);
  const T ily2 = T(1) / (ly * ly);
  const T hily2 = T(0.5) * ily2;
  const T haly2 = T(0.5) / (aly * aly);

  for (int n = threadIdx.x; n < ns; n += blockDim.x) {
    const T u = a.uq[n];
    s_uq[n] = u;
    s_uP[n] = a.uP[n];
    s_a0[n] = a.a0[n];
    s_a1[n] = a.a1[n];
    T su = T(0), cu = T(1);
    if (KIND != kSeSe) dsincos(angle<KIND>(u, freq), &su, &cu);
    s_su[n] = su;
    s_cu[n] = cu;
  }
  for (int n = threadIdx.x; n < nas; n += blockDim.x) {
    const T u = a.auxq[n];
    s_xq[n] = u;
    s_xp[n] = a.auxp[n];
    s_xa[n] = a.auxa[n];
    T su = T(0), cu = T(1);
    if (AUX_KIND != kSeSe) dsincos(angle<AUX_KIND>(u, afreq), &su, &cu);
    s_xs[n] = su;
    s_xc[n] = cu;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const size_t B = a.B;
  const T nan = T(NAN);
  T q = a.q0[b], p = a.p0[b];
  a.Q[b] = q;
  a.P[b] = p;

  for (int i = 1; i < a.nm; ++i) {
    const size_t row = size_t(i) * B + b;
    if (isnan(q) || isnan(p)) {  // lost orbits stay NaN
      a.Q[row] = nan;
      a.P[row] = nan;
      continue;
    }
    T sq = T(0), cq = T(1), asq = T(0), acq = T(1);
    if (KIND != kSeSe) dsincos(angle<KIND>(q, freq), &sq, &cq);
    if (AUX_KIND != kSeSe) dsincos(angle<AUX_KIND>(q, afreq), &asq, &acq);

    // aux-GP warm start; its q- and p-factors share one exp
    T mean = T(0);
#pragma unroll 4
    for (int n = 0; n < nas; ++n) {
      const T d = s_xq[n] - q;
      const T sh = s_xs[n] * acq - s_xc[n] * asq;
      const T sa = qfactors<AUX_KIND>(d, sh, T(0), ai2, afreq).s;
      const T dpa = s_xp[n] - p;
      mean += s_xa[n] * dexp(-(sa + dpa * dpa * haly2));
    }
    T P = mean + delta * p;

    // fixed-iteration Newton on f(P) = pGP(P) - p + P
    for (int it = 0; it < a.iters; ++it) {
      T f = T(0), fp = T(0);
#pragma unroll 4
      for (int n = 0; n < ns; ++n) {
        const T d = s_uq[n] - q;
        const T sh = s_su[n] * cq - s_cu[n] * sq;
        const T ch = s_cu[n] * cq + s_su[n] * sq;
        const QF<T> g = qfactors<KIND>(d, sh, ch, i2, freq);
        const T dP = s_uP[n] - P;
        const T dP2 = dP * dP;
        const T E = dexp(-(g.s + dP2 * hily2));  // A(dq) * B(dP)
        const T c0 = s_a0[n] * (g.spp - g.sp * g.sp);
        const T c1 = -s_a1[n] * g.sp * ily2;
        f += (c0 + c1 * dP) * E;
        fp += (c0 * ily2 * dP + c1 * ily2 * dP2 - c1) * E;
      }
      const T Pn = P - (f - p + P) / (fp + T(1));
      if (isfinite(Pn)) P = Pn;
    }
    if (a.loss_check && tokamak_lost(P, q)) P = nan;

    // q update at the solved momentum
    T dq = T(0);
#pragma unroll 4
    for (int n = 0; n < ns; ++n) {
      const T d = s_uq[n] - q;
      const T sh = s_su[n] * cq - s_cu[n] * sq;
      const T ch = s_cu[n] * cq + s_su[n] * sq;
      const QF<T> g = qfactors<KIND>(d, sh, ch, i2, freq);
      const T dP = s_uP[n] - P;
      const T dP2 = dP * dP;
      const T E = dexp(-(g.s + dP2 * hily2));
      const T h = ily2 - dP2 * ily2 * ily2;
      const T c2 = -s_a0[n] * g.sp * ily2;
      dq += (c2 * dP + s_a1[n] * h) * E;
    }
    T Q = q + dq;
    if (mod_q > T(0)) Q = Q - dfloor(Q / mod_q) * mod_q;
    if (!isfinite(P)) Q = nan;
    a.Q[row] = Q;
    a.P[row] = P;
    q = Q;
    p = P;
  }
}

template <typename T, int KIND, int AUX_KIND>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = (6 * size_t(a.ns) + 5 * size_t(a.nas)) * sizeof(T);
  auto kern = rollout_kernel<T, KIND, AUX_KIND>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const unsigned grid = unsigned((a.B + kThreads - 1) / kThreads);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t dispatch_aux(int aux_kind, const Args<T>& a, cudaStream_t s) {
  switch (aux_kind) {
    case kPerSe: return launch<T, KIND, kPerSe>(a, s);
    case kSeSe: return launch<T, KIND, kSeSe>(a, s);
    case kPerSeFreq: return launch<T, KIND, kPerSeFreq>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const T* scal, const T* uq, const T* uP, const T* a0, const T* a1,
        const T* auxq, const T* auxp, const T* auxa, const T* q0,
        const T* p0, T* Q, T* P, int B, int ns, int nas, int nm, int iters,
        int kind, int aux_kind, int loss_check, void* stream) {
  const Args<T> a{scal, uq, uP, a0, a1, auxq, auxp, auxa, q0, p0, Q, P,
                  B, ns, nas, nm, iters, loss_check};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kPerSe: return int(dispatch_aux<T, kPerSe>(aux_kind, a, s));
    case kSeSe: return int(dispatch_aux<T, kSeSe>(aux_kind, a, s));
    case kPerSeFreq: return int(dispatch_aux<T, kPerSeFreq>(aux_kind, a, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer; the
// return value is the cudaError_t of the launch (0 on success).
extern "C" int rollout_step_f32(
    const float* scal, const float* uq, const float* uP, const float* a0,
    const float* a1, const float* auxq, const float* auxp, const float* auxa,
    const float* q0, const float* p0, float* Q, float* P, int B, int ns,
    int nas, int nm, int iters, int kind, int aux_kind, int loss_check,
    void* stream) {
  return run<float>(scal, uq, uP, a0, a1, auxq, auxp, auxa, q0, p0, Q, P, B,
                    ns, nas, nm, iters, kind, aux_kind, loss_check, stream);
}

extern "C" int rollout_step_f64(
    const double* scal, const double* uq, const double* uP, const double* a0,
    const double* a1, const double* auxq, const double* auxp,
    const double* auxa, const double* q0, const double* p0, double* Q,
    double* P, int B, int ns, int nas, int nm, int iters, int kind,
    int aux_kind, int loss_check, void* stream) {
  return run<double>(scal, uq, uP, a0, a1, auxq, auxp, auxa, q0, p0, Q, P, B,
                     ns, nas, nm, iters, kind, aux_kind, loss_check, stream);
}
