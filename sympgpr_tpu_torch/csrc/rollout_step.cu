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
// What bounds it: the exps on the SFUs and the FP32 instructions around
// them, not bytes.  Per orbit and step over N training and Na aux points
// it takes Na + (1 + iters) N exps (one per aux point; per training point
// one per Newton iteration and one for the q update, each the product
// A B = exp(-(s + dP^2 / 2 ly^2)) in one exp) and ~110 FP32 operations
// per training point; it writes two values.  At N = 80 and iters = 5 that
// is 560 exps and ~1e4 flop per orbit-step: 32768 x 1000 orbit-steps need
// 1.8e10 exps (4.4 ms at 16 a clock on 132 SMs) and 3.2e11 flop (4.7 ms
// at 67 TFLOP/s), so the FP32 rate sets the bound.  A small batch is
// bound instead by the latency of one step's chain: seven team sums (aux
// mean, `iters` Newton updates, q update) and the 20-step loss-boundary
// solve, each waiting on the one before.  Measured on an H100 SXM
// (tools/rollout_ab.py) the batch takes 24.8 ms, of which 2.7 ms per
// Newton iteration: 3.7 pair iterations an SM and clock, so the SFUs run
// at a quarter of their rate and each pair iteration takes ~34 of the
// 128 instruction slots an SM has a clock.  The FP32 instruction rate,
// not the exps, is the bound the design meets.
//
// Design:
//  * A team of `team` lanes (a power of two up to kMaxTeam) works
//    on one orbit.  Lane j owns the training points n = j (mod team), at
//    most kPMax of them, and the aux points n = j (mod team).  A small
//    batch gets wide teams, so a handful of orbits still spreads over the
//    SMs and each step's chain is short; a large batch gets the narrowest
//    team whose slice fits, so several orbits share a warp and each lane's
//    per-step scalar work (sin/cos of h(q), the Newton updates, the team
//    sums) is paid by fewer lanes per orbit.  The caller decides the whole
//    layout (ops/cuda_step.py::launch_geometry): team, block, shared
//    memory and instance; the kernel runs it or refuses it.
//  * Newton-invariant factors once per step, as the TPU kernel does: each
//    lane forms s and c0..c3 (without their factor A = exp(-s)) for its
//    pairs once per step.  A Newton iteration then costs one exp (A B, the
//    exponents added) and a few multiply-adds per pair; the q update
//    reuses s and c2, c3.
//  * Registers hold what the Newton loop multiplies with: c0, c1 of the
//    lane's pairs.  Each compute thread's own row of shared memory holds
//    the rest of its slice, a record per point: sin/cos of h(u) (h(x) =
//    f x, f = 1/2 for per_se; u itself for se_se), uP and a1, loaded once
//    per launch, and the step's s and c2.  sin/cos of h(u) - h(q) come
//    from the angle-difference identity with sin/cos of h(q) taken once
//    per step.  a0 is read from device memory (L1-resident) once per step.
//    No training column is staged per block: a block holds its lanes'
//    slices and nothing else, sized by the lane's own point count.  The
//    registers per thread, not the bytes, set how many warps hide the
//    exps' latency, so the kernel has instances per points-per-lane and
//    block size (Shape, launch(); ops/cuda_step.py::INSTANCES).  Holding
//    the whole slice in registers (the first design) spilled or starved
//    the SM of warps and ran the 32768-orbit batch at 45.7 ms against
//    24.7 ms with the rows (H100 SXM, tools/rollout_ab.py).
//  * Pairs are taken two at a time (float32) between the guards on the
//    lane's point count, so their exps overlap.
//  * The aux columns (and sin/cos of their h(u)) sit in one shared-memory
//    table per block: they are read once per step, by every team of the
//    block at the same addresses (a broadcast).
//  * Team sums: an xor butterfly of __shfl_xor_sync inside a warp; teams
//    wider than a warp add the warps' sums from shared memory in a fixed
//    order (one barrier over the compute warps, two alternating slots).
//    Every lane ends with a bitwise-identical sum, so every lane takes the
//    same isfinite branch and holds the same P.  No atomics: the result
//    does not depend on the run.
//  * The loss-boundary solve (20 Newton steps with two divisions each) is
//    one scalar chain per orbit, as long as several team sums.  A solver
//    warp in every block runs it one step behind: the compute warps stage
//    (q, P) of step i, go on with step i + 1 at the unpoisoned P, and read
//    the flag of step i a step later, before they write row i.  A lost
//    orbit's row i and its step i + 1 become NaN, and it stays NaN.  One
//    block-wide barrier a step hands over the staged values and the flags,
//    so no compute warp waits for the solve.  (float32's 512-lane team's
//    block has no room for the extra warp; its first thread solves
//    instead, on the step's chain.)
//  * Every compute thread stays in the time loop to its end: the ragged
//    batch edge computes a copy of the last orbit and writes nothing, and a
//    lost orbit runs on as NaN.  So full-warp shuffles and the barriers are
//    reached by every thread.
//  * Each step writes one value of Q and one of P per orbit (the team's
//    lane 0).
//  * Templated on float and double.  Built without --use_fast_math: the
//    float posterior sums already carry ~1e-4 cancellation noise, so the
//    full-precision expf/sincosf (and exp/sincos) are used.  Only the order
//    of the sums differs from the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kSolverThreads = 32;  // the loss-solve warp of a block
constexpr int kPMax = 16;           // training points a lane holds
constexpr int kMaxTeam = 1024;      // lanes per orbit
// The kernel's two kinds: per_se is per_se_freq at frequency 1/2 (the same
// factors to the last bit), so both run the periodic instance.
constexpr int kPeriodic = 0;
constexpr int kSeSe = 1;
constexpr unsigned kFull = 0xffffffffu;

// Per dtype: pairs are processed kPairs at a time without a guard between
// them, so their exps overlap (a lane's row is padded to a multiple).
template <typename T>
struct Lane;
template <>
struct Lane<float> {
  static constexpr int kPairs = 2;
};
template <>
struct Lane<double> {
  static constexpr int kPairs = 1;
};

// An instance of the kernel: the training points a lane may hold (kPM), a
// block's threads and how many such blocks share an SM.  The last two set
// the register budget (65536 an SM, a quarter on each of its four register
// files): 288 x 3 gives 72 registers a thread, 288 x 2 gives 96, 512 x 1
// gives 128, 288 x 1 gives 224.  Holding c0, c1 of more points takes more
// registers, and fewer resident warps hide less latency; the caller picks
// the most resident instance that fits (ops/cuda_step.py::INSTANCES).
template <int PM, int THREADS, int BLOCKS>
struct Shape {
  static constexpr int kPM = PM, kThreads = THREADS, kBlocks = BLOCKS;
};

// A compute thread's row of shared memory: per point of its slice a record
// of kFields values, c2 (per step), a1, sin h(u) (se_se: u), cos h(u), uP
// (per launch) and s (per step); records as many as the lane's points,
// rounded up to whole pairs, plus one value, so the row length is odd and a
// warp's rows fall in distinct banks.
constexpr int kFields = 6;
__host__ __device__ constexpr int row_length(int npad) {
  return kFields * npad + 1;
}

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

#ifndef __CUDA_ARCH__
void named_barrier_sync(int id, int threads);  // supplied by a host build
#endif

// Barrier 1 over the block's first `threads` threads (the compute warps;
// the solver warp does not take part).
__device__ __forceinline__ void compute_sync(int threads) {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
#else
  named_barrier_sync(1, threads);
#endif
}

template <typename T>
struct QF {
  T s, sp, spp;  // s, s', s'' of A = exp(-s)
};

// Port of pallas_step._sfactors.  d = u - q (used by se_se only); sh, ch =
// sin/cos of h(d) = f d (periodic kind only); i2 = 1 / (2 lx^2); k1, k2 =
// 2 f i2, 2 f^2 i2 (periodic) or 2 i2 (se_se), formed once per launch.  At
// per_se's f = 1/2 the factors are per_se's own to the last bit: k1 = i2
// and (1 - 2 s^2) k2 = (1/2 - s^2) i2, both exact scalings by 2.
template <int KIND, typename T>
__device__ __forceinline__ QF<T> qfactors(T d, T sh, T ch, T i2, T k1,
                                          T k2) {
  if constexpr (KIND == kPeriodic) {
    const T s2 = sh * sh;
    return {s2 * i2, (sh * ch) * k1, (T(1) - T(2) * s2) * k2};
  } else {
    return {d * d * i2, d * k1, k2};
  }
}

template <int KIND, typename T>
__device__ __forceinline__ void qconstants(T i2, T freq, T* k1, T* k2) {
  *k1 = KIND == kPeriodic ? (T(2) * freq) * i2 : T(2) * i2;
  *k2 = KIND == kPeriodic ? (T(2) * freq * freq) * i2 : T(2) * i2;
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
  int team, log_team;  // lanes per orbit (a power of two) and its log2
  int np;              // training points per lane, ceil(ns / team)
  int npad;            // np rounded up to whole pairs: a row's records
  int compute;         // compute threads of a block (the solver warp follows)
  int half, ahalf;     // per_se (frequency 1/2) for the GP, the aux GP
};

// Shared memory of a block, in elements of T: the aux table (4 columns),
// two slots of per-warp partial sums (2 values each), two slots of the
// loss-check staging (q, P and the flag per team) and a row per compute
// thread.
constexpr size_t smem_elems(int nas, int compute, int teams, int npad) {
  return 4 * size_t(nas) + 4 * size_t(compute / 32) + 6 * size_t(teams) +
         size_t(row_length(npad)) * size_t(compute);
}

// Team sum of N values.  Teams of up to 32 lanes: xor butterfly inside the
// warp (the offsets stay inside the team's aligned group of lanes).  Wider
// teams: the warp butterfly, then the team's warp sums from shared memory
// in a fixed order.  Every lane of the team returns the same bits.
template <int N, typename T>
__device__ __forceinline__ void team_sum(T (&v)[N], const Args<T>& a,
                                         T* red, int& parity) {
  if (a.team <= 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < a.team) {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
      }
    }
    return;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
  }
  const int nwarps = a.compute >> 5;
  T* slot = red + parity * (2 * nwarps);
  parity ^= 1;
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) slot[2 * warp + i] = v[i];
  }
  compute_sync(a.compute);
  const int w0 = (threadIdx.x >> a.log_team) * (a.team >> 5);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = T(0);
  for (int w = 0; w < (a.team >> 5); ++w) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += slot[2 * (w0 + w) + i];
  }
}

template <typename T, int KIND, int AUX_KIND, typename S>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
    rollout_kernel(Args<T> a) {
  constexpr int PM = S::kPM;
  constexpr int kPairs = Lane<T>::kPairs;
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ns = a.ns, nas = a.nas, team = a.team, np = a.np;
  static_assert(PM % kPairs == 0, "a lane's slice is whole pair groups");
  static_assert(PM <= kPMax, "a lane holds at most kPMax points");
  const int nc = a.compute;
  const int teams = nc >> a.log_team;  // orbits of this block
  T* s_xs = sm;          // sin h(u) of the aux points (se_se: u)
  T* s_xc = s_xs + nas;  // cos h(u)
  T* s_xp = s_xc + nas;
  T* s_xa = s_xp + nas;
  T* s_red = s_xa + nas;             // [2][compute warps][2]
  T* s_lq = s_red + 4 * (nc >> 5);   // [2][teams] each
  T* s_lP = s_lq + 2 * teams;
  T* s_lost = s_lP + 2 * teams;
  T* s_rows = s_lost + 2 * teams;    // [compute][row_length(npad)]

  const T lx = a.scal[0], ly = a.scal[1], alx = a.scal[2], aly = a.scal[3];
  const T delta = a.scal[4], mod_q = a.scal[5];
  const T freq = a.half ? T(0.5) : a.scal[6];
  const T afreq = a.ahalf ? T(0.5) : a.scal[7];
  const T i2 = T(0.5) / (lx * lx);
  const T ai2 = T(0.5) / (alx * alx);
  const T ily2 = T(1) / (ly * ly);
  const T hily2 = T(0.5) * ily2;
  const T haly2 = T(0.5) / (aly * aly);
  T k1, k2;
  qconstants<KIND>(i2, freq, &k1, &k2);

  for (int n = threadIdx.x; n < nas; n += blockDim.x) {
    const T u = a.auxq[n];
    T su = u, cu = T(1);
    if (AUX_KIND != kSeSe) dsincos(afreq * u, &su, &cu);
    s_xs[n] = su;
    s_xc[n] = cu;
    s_xp[n] = a.auxp[n];
    s_xa[n] = a.auxa[n];
  }
  __syncthreads();  // the aux table is complete

  const bool own_solver = int(blockDim.x) == nc;  // no solver warp
  if (threadIdx.x >= nc) {
    // The solver warp: the loss boundary of step i for every orbit of the
    // block, while the compute warps run step i + 1.  One block-wide
    // barrier a step hands over the staged (q, P) and the flags.
    if (!a.loss_check) return;
    for (int i = 1; i <= a.nm; ++i) {
      __syncthreads();
      if (i == a.nm) break;
      const int s = (i & 1) * teams;
      for (int t = threadIdx.x - nc; t < teams; t += kSolverThreads)
        s_lost[s + t] = tokamak_lost(s_lP[s + t], s_lq[s + t]) ? T(1) : T(0);
    }
    return;
  }

  const int t = threadIdx.x >> a.log_team;       // team in the block
  const int lane = threadIdx.x & (team - 1);
  const int bt = blockIdx.x * teams + t;
  const bool active = bt < a.B;
  const int b = active ? bt : a.B - 1;           // the edge copies an orbit
  // the lane's columns from point n = lane on, with stride `team`
  const T* l_a0 = a.a0 + lane;
  const int last = ns - lane;  // k * team < last: the lane holds point k
  const int naux = lane < nas ? (nas - lane + team - 1) >> a.log_team : 0;
  // point k's record: rec[kFields * k + field]
  T* rec = s_rows + threadIdx.x * row_length(a.npad);
  constexpr int C2 = 0, C3 = 1, SU = 2, CU = 3, UP = 4, SA = 5;  // C3: a1,
  // c3 without its factor A; SU, CU: sin/cos h(u) (se_se: u); SA: s of A

  // the lane's training slice into its row, once per launch; points past
  // the slice are zero and add nothing
#pragma unroll
  for (int k = 0; k < PM; ++k) {
    if (k < a.npad) {
      const bool in = k < np && k * team < last;
      const T u = in ? a.uq[lane + k * team] : T(0);
      T sk = u, ck = T(1);
      if (KIND != kSeSe) dsincos(freq * u, &sk, &ck);
      T* r = rec + kFields * k;
      r[SU] = sk;
      r[CU] = ck;
      r[UP] = in ? a.uP[lane + k * team] : T(0);
      r[C3] = in ? a.a1[lane + k * team] : T(0);
    }
  }

  const size_t B = a.B;
  const T nan = T(NAN);
  T q = a.q0[b], p = a.p0[b];
  if (active && lane == 0) {
    a.Q[b] = q;
    a.P[b] = p;
  }
  int parity = 0;

  for (int i = 1; i < a.nm; ++i) {
    T sq = T(0), cq = T(1), asq = T(0), acq = T(1);
    if (KIND != kSeSe) dsincos(freq * q, &sq, &cq);
    if (AUX_KIND != kSeSe) {
      if (AUX_KIND == KIND && afreq == freq) {
        asq = sq;
        acq = cq;
      } else {
        dsincos(afreq * q, &asq, &acq);
      }
    }

    // aux-GP warm start; its q- and p-factors share one exp
    T mean[1] = {T(0)};
    for (int j = 0, n = lane; j < naux; ++j, n += team) {
      const T d = s_xs[n] - q;  // se_se only
      const T sh = s_xs[n] * acq - s_xc[n] * asq;
      const T sa = qfactors<AUX_KIND>(d, sh, T(0), ai2, T(0), T(0)).s;
      const T dpa = s_xp[n] - p;
      mean[0] += s_xa[n] * dexp(-(sa + dpa * dpa * haly2));
    }
    team_sum(mean, a, s_red, parity);
    T P = mean[0] + delta * p;

    // Newton-invariant factors of the lane's pairs, once per step: c0, c1
    // in registers for the Newton loop, s and c2 in the thread's row.  A =
    // exp(-s) is not taken apart: each exp below is A * B = exp(-(s +
    // dP^2 / 2 ly^2)), one per pair and iteration, as in the plain kernel's
    // fused form, and c0..c3 are the twin's without their factor A.
    T c0[PM], c1[PM];
#pragma unroll
    for (int k0 = 0; k0 < PM; k0 += kPairs) {
      if (k0 < np) {
#pragma unroll
        for (int k = k0; k < k0 + kPairs; ++k) {
          T* r = rec + kFields * k;
          const T sk = r[SU], ck = r[CU];
          const T d = sk - q;  // se_se only
          const T sh = sk * cq - ck * sq;
          const T ch = ck * cq + sk * sq;
          const T w0 = k * team < last ? __ldg(l_a0 + k * team) : T(0);
          const QF<T> g = qfactors<KIND>(d, sh, ch, i2, k1, k2);
          const T g1 = -g.sp * ily2;
          c0[k] = w0 * (g.spp - g.sp * g.sp);
          c1[k] = r[C3] * g1;
          r[C2] = w0 * g1;
          r[SA] = g.s;
        }
      }
    }

    // fixed-iteration Newton on f(P) = pGP(P) - p + P
    for (int it = 0; it < a.iters; ++it) {
      T v[2] = {T(0), T(0)};  // f, f'
#pragma unroll
      for (int k0 = 0; k0 < PM; k0 += kPairs) {
        if (k0 < np) {
#pragma unroll
          for (int k = k0; k < k0 + kPairs; ++k) {
            const T* r = rec + kFields * k;
            const T dP = r[UP] - P;
            const T dP2 = dP * dP;
            const T E = dexp(-(r[SA] + dP2 * hily2));  // A(dq) * B(dP)
            v[0] += (c0[k] + c1[k] * dP) * E;
            v[1] += (c0[k] * dP * ily2 + c1[k] * (dP2 * ily2 - T(1))) * E;
          }
        }
      }
      team_sum(v, a, s_red, parity);
      const T Pn = P - (v[0] - p + P) / (v[1] + T(1));
      if (isfinite(Pn)) P = Pn;
    }

    // q update at the solved momentum
    T dq[1] = {T(0)};
#pragma unroll
    for (int k0 = 0; k0 < PM; k0 += kPairs) {
      if (k0 < np) {
#pragma unroll
        for (int k = k0; k < k0 + kPairs; ++k) {
          const T* r = rec + kFields * k;
          const T dP = r[UP] - P;
          const T dP2 = dP * dP;
          const T E = dexp(-(r[SA] + dP2 * hily2));
          const T h = ily2 - dP2 * ily2 * ily2;
          dq[0] += (r[C2] * dP + r[C3] * h) * E;
        }
      }
    }
    team_sum(dq, a, s_red, parity);
    T Q = q + dq[0];
    if (mod_q > T(0)) Q = Q - dfloor(Q / mod_q) * mod_q;
    if (!isfinite(P)) Q = nan;

    const size_t row = size_t(i) * B + b;
    if (a.loss_check) {
      // Hand (q, P) of this step to the solver warp; take back the flag of
      // the previous step.  A lost orbit's row, written a step before, is
      // written again as NaN, and the step that ran on after it is NaN too.
      if (lane == 0) {
        s_lq[(i & 1) * teams + t] = q;
        s_lP[(i & 1) * teams + t] = P;
      }
      __syncthreads();
      if (own_solver && threadIdx.x < teams) {  // the flag of this step
        const int s = (i & 1) * teams + threadIdx.x;
        s_lost[s] = tokamak_lost(s_lP[s], s_lq[s]) ? T(1) : T(0);
      }
      if (i > 1 && s_lost[((i - 1) & 1) * teams + t] != T(0)) {
        Q = P = nan;
        if (active && lane == 0) a.Q[row - B] = a.P[row - B] = nan;
      }
    }
    if (active && lane == 0) {
      a.Q[row] = Q;
      a.P[row] = P;
    }
    q = Q;
    p = P;
  }

  if (a.loss_check) {  // the flag of the last step
    __syncthreads();
    if (a.nm > 1 && s_lost[((a.nm - 1) & 1) * teams + t] != T(0) &&
        active && lane == 0) {
      const size_t row = size_t(a.nm - 1) * B + b;
      a.Q[row] = a.P[row] = nan;
    }
  }
}

template <typename T, int KIND, int AUX_KIND, typename S>
cudaError_t launch_shape(const Args<T>& a, int teams, int threads,
                         size_t smem, cudaStream_t stream) {
  if (threads > S::kThreads || a.np > S::kPM ||
      smem < smem_elems(a.nas, a.compute, teams, a.npad) * sizeof(T))
    return cudaErrorInvalidValue;
  auto kern = rollout_kernel<T, KIND, AUX_KIND, S>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e == cudaSuccess)  // all of the SM's 256 KB for shared memory
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (e != cudaSuccess) return e;
  const unsigned grid = unsigned((a.B + teams - 1) / teams);
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instance the caller names: (points a lane holds, block threads,
// blocks an SM), one of ops/cuda_step.py::INSTANCES.  float64's narrow
// instance spills a few bytes at 96 registers, and is still the fastest:
// float64's exp and sin/cos are long dependent chains that need the 18
// warps an SM to hide them.
template <typename T, int KIND, int AUX_KIND, typename S, typename... More>
cudaError_t launch_instance(const Args<T>& a, const int (&inst)[3],
                            int teams, int threads, size_t smem,
                            cudaStream_t s) {
  if (inst[0] == S::kPM && inst[1] == S::kThreads && inst[2] == S::kBlocks)
    return launch_shape<T, KIND, AUX_KIND, S>(a, teams, threads, smem, s);
  if constexpr (sizeof...(More) > 0)
    return launch_instance<T, KIND, AUX_KIND, More...>(a, inst, teams,
                                                       threads, smem, s);
  return cudaErrorInvalidValue;
}

template <typename T, int KIND, int AUX_KIND>
cudaError_t launch(const Args<T>& a, const int (&inst)[3], int teams,
                   int threads, size_t smem, cudaStream_t s) {
  if constexpr (sizeof(T) == 4)
    return launch_instance<T, KIND, AUX_KIND, Shape<10, 288, 3>,
                           Shape<16, 288, 2>, Shape<10, 512, 1>,
                           Shape<16, 512, 1>>(a, inst, teams, threads, smem,
                                              s);
  else
    return launch_instance<T, KIND, AUX_KIND, Shape<8, 288, 2>,
                           Shape<16, 288, 1>>(a, inst, teams, threads, smem,
                                              s);
}

// per_se (0) and per_se_freq (2) run the periodic instance, se_se (1) its own
template <typename T, int KIND>
cudaError_t dispatch_aux(int aux_kind, const Args<T>& a, const int (&inst)[3],
                         int teams, int threads, size_t smem,
                         cudaStream_t s) {
  switch (aux_kind) {
    case 0: case 2:
      return launch<T, KIND, kPeriodic>(a, inst, teams, threads, smem, s);
    case 1: return launch<T, KIND, kSeSe>(a, inst, teams, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const T* scal, const T* uq, const T* uP, const T* a0, const T* a1,
        const T* auxq, const T* auxp, const T* auxa, const T* q0,
        const T* p0, T* Q, T* P, int B, int ns, int nas, int nm, int iters,
        int kind, int aux_kind, int loss_check, int team, int teams,
        int threads, int smem_bytes, int inst_points, int inst_threads,
        int inst_blocks, void* stream) {
  // the layout comes from ops/cuda_step.py::launch_geometry; refuse any the
  // kernel cannot run (a block is its teams' lanes, then a solver warp or
  // not)
  int log_team = 0;
  while ((1 << log_team) < team) ++log_team;
  const int compute = team * teams;
  const int np = (ns + team - 1) / team;
  constexpr int kPairs = Lane<T>::kPairs;
  if (team < 1 || team > kMaxTeam || (1 << log_team) != team ||
      teams < 1 || compute % 32 != 0 || np > kPMax || B < 1 ||
      (threads != compute && threads != compute + kSolverThreads))
    return int(cudaErrorInvalidValue);
  const Args<T> a{scal, uq, uP, a0, a1, auxq, auxp, auxa, q0, p0, Q, P,
                  B, ns, nas, nm, iters, loss_check, team, log_team, np,
                  (np + kPairs - 1) / kPairs * kPairs, compute, kind == 0,
                  aux_kind == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = size_t(smem_bytes);
  const int inst[3] = {inst_points, inst_threads, inst_blocks};
  switch (kind) {
    case 0: case 2:
      return int(dispatch_aux<T, kPeriodic>(aux_kind, a, inst, teams,
                                            threads, smem, s));
    case 1:
      return int(dispatch_aux<T, kSeSe>(aux_kind, a, inst, teams, threads,
                                        smem, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  Every pointer is a device pointer.  The
// layout comes from ops/cuda_step.py::launch_geometry: `team` lanes per
// orbit, `teams` orbits per block, a block of `threads` threads (team *
// teams compute threads and, where the block has room, one solver warp),
// its dynamic shared memory, and the kernel instance (points a lane holds,
// block threads, blocks an SM).  The return value is the cudaError_t of
// the launch (0 on success).
extern "C" int rollout_step_f32(
    const float* scal, const float* uq, const float* uP, const float* a0,
    const float* a1, const float* auxq, const float* auxp, const float* auxa,
    const float* q0, const float* p0, float* Q, float* P, int B, int ns,
    int nas, int nm, int iters, int kind, int aux_kind, int loss_check,
    int team, int teams, int threads, int smem_bytes, int inst_points,
    int inst_threads, int inst_blocks, void* stream) {
  return run<float>(scal, uq, uP, a0, a1, auxq, auxp, auxa, q0, p0, Q, P, B,
                    ns, nas, nm, iters, kind, aux_kind, loss_check, team,
                    teams, threads, smem_bytes, inst_points, inst_threads,
                    inst_blocks, stream);
}

extern "C" int rollout_step_f64(
    const double* scal, const double* uq, const double* uP, const double* a0,
    const double* a1, const double* auxq, const double* auxp,
    const double* auxa, const double* q0, const double* p0, double* Q,
    double* P, int B, int ns, int nas, int nm, int iters, int kind,
    int aux_kind, int loss_check, int team, int teams, int threads,
    int smem_bytes, int inst_points, int inst_threads, int inst_blocks,
    void* stream) {
  return run<double>(scal, uq, uP, a0, a1, auxq, auxp, auxa, q0, p0, Q, P, B,
                     ns, nas, nm, iters, kind, aux_kind, loss_check, team,
                     teams, threads, smem_bytes, inst_points, inst_threads,
                     inst_blocks, stream);
}
