// Fused symplectic-map rollout on Hopper (sm_90a): the whole nm-step
// iteration of the learned map for a batch of orbits in one launch.  The
// kernel template and its launch; two libraries instantiate it
// (rollout_step.cu: every one-map instance and the Split implicit one;
// rollout_split_modes.cu: the Split instances of the other modes), so
// their nvcc runs side by side.
//
// Replaces sympgpr_tpu/ops/pallas_step.py::_rollout_kernel (with its helpers
// _sfactors and _tokamak_lost): product kernels per_se / se_se /
// per_se_freq (kinds 0, 1, 2) with the implicit map (aux-GP warm start,
// `iters` fixed Newton iterations that keep P where an update is
// non-finite) or the explicit update P = p - pGP(q, p); the separable sum
// kernel sum_per_se (kind 3) with Algorithm 2 (P from q alone, dq from P
// alone); the tokamak loss check at the old q (single map) or at the new q
// (Split); the mod_q wrap; the mod_p wrap with the unwrapped momentum
// (pdiff) as a third output; NaN poisoning of lost orbits; one map or
// Split cycling over M sub-maps (row i is made by sub-map (i - 1) mod M).
// Row 0 of the trajectory is the initial condition.  The plain PyTorch
// version is sympgpr_tpu_torch/ops/cuda_step.py::rollout_reference.
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
//    per launch (for each of a Split model's sub-maps), and the step's s
//    and c2.  sin/cos of h(u) - h(q) come
//    from the angle-difference identity with sin/cos of h(q) taken once
//    per step.  a0 is read from device memory (L1-resident) once per step.
//    No training column is staged per block: a block holds its lanes'
//    slices and nothing else, sized by the lane's own point count.  The
//    registers per thread, not the bytes, set how many warps hide the
//    exps' latency, so the kernel has instances per points-per-lane and
//    block size (Shape, launch_shapes(); ops/cuda_step.py::INSTANCES).
//    Holding the whole slice in registers (the first design) spilled or
//    starved the SM of warps and ran the 32768-orbit batch at 45.7 ms
//    against 24.7 ms with the rows (H100 SXM, tools/rollout_ab.py).
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
//    With the loss check at the new q (the Split tokamak) the staged angle
//    is the step's new Q, after the mod_q wrap; the rows it poisons are the
//    same.
//  * Split cycling and the loss check at the new q run in the Split
//    instances (a template flag); the one-map instances keep their
//    launch-time constants in registers, no branch on the sub-map and no
//    choice of the staged angle (with that choice the float64 one-map
//    instance of 96 registers spilled 60 bytes against 36, and its bench
//    batch ran 4 % slower).  A one-map model checked at the new q runs a
//    Split instance with M = 1.  In the Split instances:
//    each lane holds every sub-map's launch fields (a1, sin/cos h(u), uP:
//    4 values a point and sub-map) in its row, the aux tables of all
//    sub-maps sit side by side, and a table of derived constants per
//    sub-map (1 / (2 lx^2), ...) is formed once per launch.  A step reads
//    its sub-map's constants (a broadcast), offsets into the records and
//    aux table, and reads a0 from the sub-map's block in device memory.
//    c0 and c1 in registers are formed once per step as with one map, so
//    the register count does not grow with M; the row does, by 4 M values
//    a point.  Sub-maps of different sizes share one stride: their
//    padding carries zero alpha.
//  * Every compute thread stays in the time loop to its end: the ragged
//    batch edge computes a copy of the last orbit and writes nothing, and a
//    lost orbit runs on as NaN.  So full-warp shuffles and the barriers are
//    reached by every thread.
//  * Each step writes one value of Q and one of P per orbit (the team's
//    lane 0).
//  * The explicit update, Algorithm 2 and the mod_p wrap with pdiff are
//    modes of their own instances (Mode, a template parameter), so none of
//    their code reaches the implicit instances (a single extra select
//    spills in float64's register-capped one-map instance, as the Split
//    note above says).  Their Split instances (sub-map cycling, or one map
//    checked at the new q) take each sub-map's mod_p from its row of the
//    constants table (its spare last value, so the table keeps its size).
//    The explicit update forms the step's factors as the implicit
//    one does and sums (c0 + c1 dP) A B at P = p in the same pass: one team
//    sum, no aux table, no Newton, no c0, c1 kept.  Algorithm 2 takes the
//    periodic q-factors at frequency 1/2 (per_se's, the sum kernel's
//    q-side addend): P = p - sum a0 (s'' - s'^2) A and dq = sum a1 h B,
//    two exps a point and step and no A in the q update.  The explicit
//    and Algorithm-2 instances read mod_p and whether to write pdiff at
//    run time; the implicit one-map instance with the wrap is its own.
//    With the loss check at the old q the unwrapped P is staged and pdiff
//    of a lost orbit's row is rewritten as NaN with its Q and P, and stays
//    NaN.  At the new q (Split instances) the wrapped P is staged, as the
//    TPU kernel checks it, and the lost row keeps its pdiff: the TPU kernel
//    sums P - p before the check, so pdiff turns NaN one row later.
//  * Templated on float and double.  Built without --use_fast_math: the
//    float posterior sums already carry ~1e-4 cancellation noise, so the
//    full-precision expf/sincosf (and exp/sincos) are used.  Only the order
//    of the sums differs from the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kSolverThreads = 32;  // the loss-solve warp of a block
constexpr int kNScal = 12;          // scal's row of each sub-map
constexpr int kPMax = 16;           // training points a lane holds
constexpr int kMaxTeam = 1024;      // lanes per orbit
// The kernel's two kinds: per_se is per_se_freq at frequency 1/2 (the same
// factors to the last bit), so both run the periodic instance.
constexpr int kPeriodic = 0;
constexpr int kSeSe = 1;
constexpr unsigned kFull = 0xffffffffu;
// The update a step runs: the implicit map without or with the mod_p wrap
// and pdiff, the explicit product update, Algorithm 2 (kind 3).  The last
// three wrap P where mod_p > 0 and write pdiff where D is given.
enum Mode { kImplicit, kImplicitWrap, kExplicit, kSum };

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
// of c2 (per step), then for each sub-map a1, sin h(u) (se_se: u), cos
// h(u), uP (per launch), then s (per step): kFields values with one map,
// kMapFields more for each further sub-map; records as many as the lane's
// points, rounded up to whole pairs, plus one value, so the row length is
// odd and a warp's rows fall in distinct banks.
constexpr int kFields = 6;
constexpr int kMapFields = 4;
// a sub-map's fields in a record, from its first: a1, sin/cos h(u), uP
constexpr int kC3 = 0, kSU = 1, kCU = 2, kUP = 3;
__host__ __device__ constexpr int record_fields(int n_maps) {
  return kFields + kMapFields * (n_maps - 1);
}
__host__ __device__ constexpr int row_length(int npad, int fields) {
  return fields * npad + 1;
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

// A sub-map's constants, formed from its row of scal: 1 / (2 lx^2) and
// k1, k2 of the GP's q-factors, the aux GP's 1 / (2 alx^2) and 1 / (2
// aly^2), 1 / ly^2 and its half, delta, mod_q and the two frequencies.
template <typename T>
struct MapConsts {
  T i2, ai2, ily2, hily2, haly2, k1, k2, delta, mod_q, freq, afreq;
};
// the last value of a sub-map's row of the table: its mod_p (wrap modes)
constexpr int kModP = kNScal - 1;
static_assert(sizeof(MapConsts<double>) <= kModP * sizeof(double) &&
                  sizeof(MapConsts<float>) <= kModP * sizeof(float),
              "a sub-map's constants fit its row of the table, mod_p after");

template <int KIND, typename T>
__device__ __forceinline__ MapConsts<T> map_consts(const T* sc, int half,
                                                   int ahalf) {
  MapConsts<T> c;
  const T lx = sc[0], ly = sc[1], alx = sc[2], aly = sc[3];
  c.delta = sc[4];
  c.mod_q = sc[5];
  c.freq = half ? T(0.5) : sc[6];
  c.afreq = ahalf ? T(0.5) : sc[7];
  c.i2 = T(0.5) / (lx * lx);
  c.ai2 = T(0.5) / (alx * alx);
  c.ily2 = T(1) / (ly * ly);
  c.hily2 = T(0.5) * c.ily2;
  c.haly2 = T(0.5) / (aly * aly);
  qconstants<KIND>(c.i2, c.freq, &c.k1, &c.k2);
  return c;
}

template <typename T>
struct Args {
  const T* scal;  // (n_maps, kNScal): lx, ly, alx, aly, delta, mod_q, freq,
                  // afreq (as packed)
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
  int B, ns, nas, n_maps, nm, iters, loss_check, loss_at_new_q;
  int team, log_team;  // lanes per orbit (a power of two) and its log2
  int np;              // training points per lane, ceil(ns / team)
  int npad;            // np rounded up to whole pairs: a row's records
  int fields;          // values in a record, record_fields(n_maps)
  int compute;         // compute threads of a block (the solver warp follows)
  int half, ahalf;     // per_se (frequency 1/2) for the GP, the aux GP
  T* D;  // (nm, B) unwrapped momentum (pdiff), or null; wrap modes only
};

// Shared memory of a block, in elements of T: the aux tables (4 columns of
// nas values for each sub-map), two slots of per-warp partial sums (2
// values each), two slots of the loss-check staging (q, P and the flag per
// team), in a Split instance a row of kNScal constants for each sub-map,
// and a row per compute thread.
constexpr size_t smem_elems(int nas, int compute, int teams, int npad,
                            int n_maps, bool split) {
  return 4 * size_t(n_maps) * size_t(nas) + 4 * size_t(compute / 32) +
         6 * size_t(teams) + (split ? size_t(kNScal) * n_maps : 0) +
         size_t(row_length(npad, record_fields(n_maps))) * size_t(compute);
}

// The Split instance runs sub-map cycling and the loss check at the new q.
__host__ __device__ constexpr bool split_instance(int n_maps,
                                                  int loss_at_new_q) {
  return n_maps > 1 || loss_at_new_q;
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

template <typename T, int KIND, int AUX_KIND, bool SPLIT, int MODE,
          typename S>
__global__ void __launch_bounds__(S::kThreads, S::kBlocks)
    rollout_kernel(Args<T> a) {
  constexpr int PM = S::kPM;
  constexpr bool IMPLICIT = MODE == kImplicit || MODE == kImplicitWrap;
  constexpr bool WRAP = MODE != kImplicit;  // mod_p and pdiff
  constexpr int kPairs = Lane<T>::kPairs;
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ns = a.ns, nas = a.nas, team = a.team, np = a.np;
  static_assert(PM % kPairs == 0, "a lane's slice is whole pair groups");
  static_assert(PM <= kPMax, "a lane holds at most kPMax points");
  const int maps = SPLIT ? a.n_maps : 1;
  const int F = SPLIT ? a.fields : kFields;  // values in a record
  const int nc = a.compute;
  const int teams = nc >> a.log_team;  // orbits of this block
  T* s_xs = sm;                 // sin h(u) of the aux points (se_se: u)
  T* s_xc = s_xs + maps * nas;  // cos h(u)
  T* s_xp = s_xc + maps * nas;
  T* s_xa = s_xp + maps * nas;
  T* s_red = s_xa + maps * nas;      // [2][compute warps][2]
  T* s_lq = s_red + 4 * (nc >> 5);   // [2][teams] each
  T* s_lP = s_lq + 2 * teams;
  T* s_lost = s_lP + 2 * teams;
  T* s_cst = s_lost + 2 * teams;     // SPLIT: [maps][kNScal]
  T* s_rows = s_cst + (SPLIT ? kNScal * maps : 0);  // [compute][row]

  // the sub-map's constants: with one map the launch's, in registers
  MapConsts<T> c;
  if constexpr (SPLIT) {
    for (int j = threadIdx.x; j < maps; j += blockDim.x) {
      *reinterpret_cast<MapConsts<T>*>(s_cst + kNScal * j) =
          map_consts<KIND>(a.scal + kNScal * j, a.half, a.ahalf);
      if constexpr (WRAP) s_cst[kNScal * j + kModP] = a.scal[kNScal * j + 8];
    }
  } else {
    c = map_consts<KIND>(a.scal, a.half, a.ahalf);
  }

  for (int n = threadIdx.x; IMPLICIT && n < maps * nas; n += blockDim.x) {
    const T u = a.auxq[n];
    T su = u, cu = T(1);
    if (AUX_KIND != kSeSe) {
      const T afreq =
          SPLIT ? (a.ahalf ? T(0.5) : a.scal[kNScal * (n / nas) + 7])
                : c.afreq;
      dsincos(afreq * u, &su, &cu);
    }
    s_xs[n] = su;
    s_xc[n] = cu;
    s_xp[n] = a.auxp[n];
    s_xa[n] = a.auxa[n];
  }
  __syncthreads();  // the aux tables (and the constants) are complete

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
  const int last = ns - lane;  // k * team < last: the lane holds point k
  const int naux = lane < nas ? (nas - lane + team - 1) >> a.log_team : 0;
  // point k's record: rec[F * k + field]; c2 first, s last, and sub-map
  // m's fields from 1 + kMapFields * m on
  T* rec = s_rows + threadIdx.x * row_length(a.npad, F);
  constexpr int C2 = 0;
  const int SA = F - 1;  // s of A

  // each sub-map's training slice into the row, once per launch; points
  // past the slice are zero and add nothing
  for (int m = 0; m < maps; ++m) {
    const T freq =
        SPLIT ? (a.half ? T(0.5) : a.scal[kNScal * m + 6]) : c.freq;
    const int g0 = m * ns + lane;
#pragma unroll
    for (int k = 0; k < PM; ++k) {
      if (k < a.npad) {
        const bool in = k < np && k * team < last;
        const T u = in ? a.uq[g0 + k * team] : T(0);
        T sk = u, ck = T(1);
        if (KIND != kSeSe) dsincos(freq * u, &sk, &ck);
        T* r = rec + F * k + 1 + kMapFields * m;
        r[kSU] = sk;
        r[kCU] = ck;
        r[kUP] = in ? a.uP[g0 + k * team] : T(0);
        r[kC3] = in ? a.a1[g0 + k * team] : T(0);
      }
    }
  }

  const size_t B = a.B;
  const T nan = T(NAN);
  T q = a.q0[b], p = a.p0[b];
  if (active && lane == 0) {
    a.Q[b] = q;
    a.P[b] = p;
  }
  // the wrap modes: mod_p (0: no wrap; a Split model's per step, its
  // sub-map's) and the unwrapped momentum
  T mod_p = WRAP ? a.scal[8] : T(0);
  // with the loss check at the new q a lost orbit's row keeps its pdiff
  [[maybe_unused]] bool nan_lost_pd = true;
  if constexpr (SPLIT && WRAP) nan_lost_pd = !a.loss_at_new_q;
  T pd = p;
  if (WRAP && a.D && active && lane == 0) a.D[b] = p;
  int parity = 0;
  int m = 0;  // the sub-map of this step, (i - 1) mod n_maps

  for (int i = 1; i < a.nm; ++i) {
    if constexpr (SPLIT)
      c = *reinterpret_cast<const MapConsts<T>*>(s_cst + kNScal * m);
    if constexpr (SPLIT && WRAP) mod_p = s_cst[kNScal * m + kModP];
    const int mo = SPLIT ? 1 + kMapFields * m : 1;  // its record fields
    const T* xs = s_xs + (SPLIT ? m * nas : 0);
    const T* xc = s_xc + (SPLIT ? m * nas : 0);
    const T* xp = s_xp + (SPLIT ? m * nas : 0);
    const T* xa = s_xa + (SPLIT ? m * nas : 0);
    // the lane's a0 from point n = lane on, with stride `team`
    const T* l_a0 = a.a0 + (SPLIT ? m * ns : 0) + lane;

    T sq = T(0), cq = T(1), asq = T(0), acq = T(1);
    if (KIND != kSeSe) dsincos(c.freq * q, &sq, &cq);
    if (IMPLICIT && AUX_KIND != kSeSe) {
      if (AUX_KIND == KIND && c.afreq == c.freq) {
        asq = sq;
        acq = cq;
      } else {
        dsincos(c.afreq * q, &asq, &acq);
      }
    }

    T P;
    if constexpr (IMPLICIT) {
      // aux-GP warm start; its q- and p-factors share one exp
      T mean[1] = {T(0)};
      for (int j = 0, n = lane; j < naux; ++j, n += team) {
        const T d = xs[n] - q;  // se_se only
        const T sh = xs[n] * acq - xc[n] * asq;
        const T sa = qfactors<AUX_KIND>(d, sh, T(0), c.ai2, T(0), T(0)).s;
        const T dpa = xp[n] - p;
        mean[0] += xa[n] * dexp(-(sa + dpa * dpa * c.haly2));
      }
      team_sum(mean, a, s_red, parity);
      P = mean[0] + c.delta * p;
    }

    // Newton-invariant factors of the lane's pairs, once per step: c0, c1
    // in registers for the Newton loop, s and c2 in the thread's row.  A =
    // exp(-s) is not taken apart: each exp below is A * B = exp(-(s +
    // dP^2 / 2 ly^2)), one per pair and iteration, as in the plain kernel's
    // fused form, and c0..c3 are the twin's without their factor A.
    // The explicit update and Algorithm 2 sum pGP at P = p in the same
    // pass: (c0 + c1 dP) A B with dP = uP - p, or a0 (s'' - s'^2) A.
    T c0[PM], c1[PM];
    T pgp[1] = {T(0)};
#pragma unroll
    for (int k0 = 0; k0 < PM; k0 += kPairs) {
      if (k0 < np) {
#pragma unroll
        for (int k = k0; k < k0 + kPairs; ++k) {
          T* r = rec + F * k;
          const T sk = r[mo + kSU], ck = r[mo + kCU];
          const T d = sk - q;  // se_se only
          const T sh = sk * cq - ck * sq;
          const T ch = ck * cq + sk * sq;
          const T w0 = k * team < last ? __ldg(l_a0 + k * team) : T(0);
          const QF<T> g = qfactors<KIND>(d, sh, ch, c.i2, c.k1, c.k2);
          if constexpr (MODE == kSum) {
            pgp[0] += w0 * (g.spp - g.sp * g.sp) * dexp(-g.s);
          } else {
            const T g1 = -g.sp * c.ily2;
            const T k0v = w0 * (g.spp - g.sp * g.sp);
            const T k1v = r[mo + kC3] * g1;
            r[C2] = w0 * g1;
            r[SA] = g.s;
            if constexpr (MODE == kExplicit) {
              const T dP = r[mo + kUP] - p;
              pgp[0] += (k0v + k1v * dP) * dexp(-(g.s + dP * dP * c.hily2));
            } else {
              c0[k] = k0v;
              c1[k] = k1v;
            }
          }
        }
      }
    }
    if constexpr (!IMPLICIT) {
      team_sum(pgp, a, s_red, parity);
      P = p - pgp[0];
    }

    // fixed-iteration Newton on f(P) = pGP(P) - p + P
    for (int it = 0; IMPLICIT && it < a.iters; ++it) {
      T v[2] = {T(0), T(0)};  // f, f'
#pragma unroll
      for (int k0 = 0; k0 < PM; k0 += kPairs) {
        if (k0 < np) {
#pragma unroll
          for (int k = k0; k < k0 + kPairs; ++k) {
            const T* r = rec + F * k;
            const T dP = r[mo + kUP] - P;
            const T dP2 = dP * dP;
            const T E = dexp(-(r[SA] + dP2 * c.hily2));  // A(dq) * B(dP)
            v[0] += (c0[k] + c1[k] * dP) * E;
            v[1] += (c0[k] * dP * c.ily2 + c1[k] * (dP2 * c.ily2 - T(1))) *
                    E;
          }
        }
      }
      team_sum(v, a, s_red, parity);
      const T Pn = P - (v[0] - p + P) / (v[1] + T(1));
      if (isfinite(Pn)) P = Pn;
    }

    // the unwrapped P: the loss check's and pdiff's; the q update runs at
    // the wrapped one
    const T Pu = P;
    if (WRAP && mod_p > T(0)) P = P - dfloor(P / mod_p) * mod_p;

    // q update at the solved momentum (Algorithm 2: B alone, no c2 term)
    T dq[1] = {T(0)};
#pragma unroll
    for (int k0 = 0; k0 < PM; k0 += kPairs) {
      if (k0 < np) {
#pragma unroll
        for (int k = k0; k < k0 + kPairs; ++k) {
          const T* r = rec + F * k;
          const T dP = r[mo + kUP] - P;
          const T dP2 = dP * dP;
          const T h = c.ily2 - dP2 * c.ily2 * c.ily2;
          if constexpr (MODE == kSum) {
            dq[0] += r[mo + kC3] * h * dexp(-(dP2 * c.hily2));
          } else {
            const T E = dexp(-(r[SA] + dP2 * c.hily2));
            dq[0] += (r[C2] * dP + r[mo + kC3] * h) * E;
          }
        }
      }
    }
    team_sum(dq, a, s_red, parity);
    T Q = q + dq[0];
    if (c.mod_q > T(0)) Q = Q - dfloor(Q / c.mod_q) * c.mod_q;
    if (!isfinite(P)) Q = nan;
    if constexpr (WRAP) pd = pd + (Pu - p);

    const size_t row = size_t(i) * B + b;
    if (a.loss_check) {
      // Hand (q, P) of this step (the new Q with the check at the new q,
      // and there the wrapped P) to the solver warp; take back the flag of
      // the previous step.  A lost orbit's row, written a step before, is
      // written again as NaN, and the step that ran on after it is NaN too.
      if (lane == 0) {
        if constexpr (SPLIT)
          s_lq[(i & 1) * teams + t] = a.loss_at_new_q ? Q : q;
        else
          s_lq[(i & 1) * teams + t] = q;
        if constexpr (SPLIT && WRAP)
          s_lP[(i & 1) * teams + t] = a.loss_at_new_q ? P : Pu;
        else
          s_lP[(i & 1) * teams + t] = Pu;
      }
      __syncthreads();
      if (own_solver && threadIdx.x < teams) {  // the flag of this step
        const int s = (i & 1) * teams + threadIdx.x;
        s_lost[s] = tokamak_lost(s_lP[s], s_lq[s]) ? T(1) : T(0);
      }
      if (i > 1 && s_lost[((i - 1) & 1) * teams + t] != T(0)) {
        Q = P = nan;
        if (active && lane == 0) a.Q[row - B] = a.P[row - B] = nan;
        if constexpr (WRAP) {
          pd = nan;
          if (nan_lost_pd && a.D && active && lane == 0)
            a.D[row - B] = nan;
        }
      }
    }
    if (active && lane == 0) {
      a.Q[row] = Q;
      a.P[row] = P;
      if (WRAP && a.D) a.D[row] = pd;
    }
    q = Q;
    p = P;
    if constexpr (SPLIT) m = m + 1 == maps ? 0 : m + 1;
  }

  if (a.loss_check) {  // the flag of the last step
    __syncthreads();
    if (a.nm > 1 && s_lost[((a.nm - 1) & 1) * teams + t] != T(0) &&
        active && lane == 0) {
      const size_t row = size_t(a.nm - 1) * B + b;
      a.Q[row] = a.P[row] = nan;
      if (WRAP && nan_lost_pd && a.D) a.D[row] = nan;
    }
  }
}

template <typename T, int KIND, int AUX_KIND, bool SPLIT, int MODE, typename S>
cudaError_t launch_shape(const Args<T>& a, int teams, int threads,
                         size_t smem, cudaStream_t stream) {
  if (threads > S::kThreads || a.np > S::kPM ||
      split_instance(a.n_maps, a.loss_at_new_q) != SPLIT ||
      smem < smem_elems(a.nas, a.compute, teams, a.npad, a.n_maps, SPLIT) *
                 sizeof(T))
    return cudaErrorInvalidValue;
  void (*kern)(Args<T>) = rollout_kernel<T, KIND, AUX_KIND, SPLIT, MODE, S>;
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
template <typename T, int KIND, int AUX_KIND, bool SPLIT, int MODE,
          typename S, typename... More>
cudaError_t launch_instance(const Args<T>& a, const int (&inst)[3],
                            int teams, int threads, size_t smem,
                            cudaStream_t s) {
  if (inst[0] == S::kPM && inst[1] == S::kThreads && inst[2] == S::kBlocks)
    return launch_shape<T, KIND, AUX_KIND, SPLIT, MODE, S>(a, teams, threads,
                                                           smem, s);
  if constexpr (sizeof...(More) > 0)
    return launch_instance<T, KIND, AUX_KIND, SPLIT, MODE, More...>(
        a, inst, teams, threads, smem, s);
  return cudaErrorInvalidValue;
}

template <typename T, int KIND, int AUX_KIND, bool SPLIT, int MODE>
cudaError_t launch_shapes(const Args<T>& a, const int (&inst)[3], int teams,
                          int threads, size_t smem, cudaStream_t s) {
  if constexpr (sizeof(T) == 4)
    return launch_instance<T, KIND, AUX_KIND, SPLIT, MODE, Shape<10, 288, 3>,
                           Shape<16, 288, 2>, Shape<10, 512, 1>,
                           Shape<16, 512, 1>>(a, inst, teams, threads, smem,
                                              s);
  else
    return launch_instance<T, KIND, AUX_KIND, SPLIT, MODE, Shape<8, 288, 2>,
                           Shape<16, 288, 1>>(a, inst, teams, threads, smem,
                                              s);
}

// The instances of one library: SPLIT_MODES false holds every one-map
// instance and the Split implicit one (rollout_step.cu), true the Split
// instances of the wrap, explicit and sum modes (rollout_split_modes.cu);
// a launch the library does not hold is refused.
template <bool SPLIT_MODES>
constexpr bool holds(bool split, int mode) {
  return SPLIT_MODES ? split && mode != kImplicit
                     : !split || mode == kImplicit;
}

template <bool SPLIT_MODES, typename T, int KIND, int AUX_KIND, int MODE>
cudaError_t launch(bool split, const Args<T>& a, const int (&inst)[3],
                   int teams, int threads, size_t smem, cudaStream_t s) {
  if constexpr (SPLIT_MODES && MODE == kImplicit)
    return cudaErrorInvalidValue;  // the other library's (holds())
  else if constexpr (SPLIT_MODES)
    return launch_shapes<T, KIND, AUX_KIND, true, MODE>(a, inst, teams,
                                                        threads, smem, s);
  else if constexpr (MODE == kImplicit)
    return split ? launch_shapes<T, KIND, AUX_KIND, true, MODE>(
                       a, inst, teams, threads, smem, s)
                 : launch_shapes<T, KIND, AUX_KIND, false, MODE>(
                       a, inst, teams, threads, smem, s);
  else
    return launch_shapes<T, KIND, AUX_KIND, false, MODE>(a, inst, teams,
                                                         threads, smem, s);
}

// per_se (0) and per_se_freq (2) run the periodic instance, se_se (1) its
// own; the explicit instances take no aux model
template <bool SPLIT_MODES, typename T, int KIND>
cudaError_t dispatch_aux(int mode, bool split, int aux_kind,
                         const Args<T>& a, const int (&inst)[3], int teams,
                         int threads, size_t smem, cudaStream_t s) {
  if (mode == kExplicit)
    return launch<SPLIT_MODES, T, KIND, kPeriodic, kExplicit>(
        split, a, inst, teams, threads, smem, s);
  const bool wrap = mode == kImplicitWrap;
  switch (aux_kind) {
    case 0: case 2:
      return wrap ? launch<SPLIT_MODES, T, KIND, kPeriodic, kImplicitWrap>(
                        split, a, inst, teams, threads, smem, s)
                  : launch<SPLIT_MODES, T, KIND, kPeriodic, kImplicit>(
                        split, a, inst, teams, threads, smem, s);
    case 1:
      return wrap ? launch<SPLIT_MODES, T, KIND, kSeSe, kImplicitWrap>(
                        split, a, inst, teams, threads, smem, s)
                  : launch<SPLIT_MODES, T, KIND, kSeSe, kImplicit>(
                        split, a, inst, teams, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool SPLIT_MODES, typename T>
int run(const T* scal, const T* uq, const T* uP, const T* a0, const T* a1,
        const T* auxq, const T* auxp, const T* auxa, const T* q0,
        const T* p0, T* Q, T* P, T* D, int B, int ns, int nas, int n_maps,
        int nm, int iters, int kind, int aux_kind, int loss_check,
        int loss_at_new_q, int explicit_update, int mod_p, int track_pdiff,
        int team, int teams, int threads, int smem_bytes, int inst_points,
        int inst_threads, int inst_blocks, void* stream) {
  // the layout comes from ops/cuda_step.py::launch_geometry; refuse any the
  // kernel cannot run (a block is its teams' lanes, then a solver warp or
  // not)
  int log_team = 0;
  while ((1 << log_team) < team) ++log_team;
  const int compute = team * teams;
  const int np = (ns + team - 1) / team;
  constexpr int kPairs = Lane<T>::kPairs;
  const int mode = explicit_update || kind == 3 ? (kind == 3 ? kSum
                                                             : kExplicit)
                   : (mod_p || track_pdiff) ? kImplicitWrap : kImplicit;
  const bool split = split_instance(n_maps, loss_at_new_q);
  if (team < 1 || team > kMaxTeam || (1 << log_team) != team ||
      teams < 1 || compute % 32 != 0 || np > kPMax || B < 1 || n_maps < 1 ||
      (threads != compute && threads != compute + kSolverThreads) ||
      (track_pdiff && D == nullptr) || !holds<SPLIT_MODES>(split, mode))
    return int(cudaErrorInvalidValue);
  // kind 3 (sum_per_se) runs Algorithm 2 on per_se's q-factors, at
  // frequency 1/2 (its packed frequency is 0)
  const Args<T> a{scal, uq, uP, a0, a1, auxq, auxp, auxa, q0, p0, Q, P,
                  B, ns, nas, n_maps, nm, iters, loss_check, loss_at_new_q,
                  team, log_team, np, (np + kPairs - 1) / kPairs * kPairs,
                  record_fields(n_maps), compute, kind == 0 || kind == 3,
                  aux_kind == 0, track_pdiff ? D : nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = size_t(smem_bytes);
  const int inst[3] = {inst_points, inst_threads, inst_blocks};
  switch (kind) {
    case 0: case 2:
      return int(dispatch_aux<SPLIT_MODES, T, kPeriodic>(
          mode, split, aux_kind, a, inst, teams, threads, smem, s));
    case 1:
      return int(dispatch_aux<SPLIT_MODES, T, kSeSe>(
          mode, split, aux_kind, a, inst, teams, threads, smem, s));
    case 3:
      return int(launch<SPLIT_MODES, T, kPeriodic, kPeriodic, kSum>(
          split, a, inst, teams, threads, smem, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// The plain C interface of a library, for ctypes (NAME_f32, NAME_f64).
// Every pointer is a device pointer; the model columns hold `n_maps`
// sub-maps of `ns` training and `nas` aux points each, scal one row of
// kNScal per sub-map.  The loss check (when on) takes the old q, or the
// new q with `loss_at_new_q`.  `explicit_update` takes the explicit
// product update (kind 3 always runs Algorithm 2); `mod_p` says the models
// were packed with a mod_p (scal's column 8) to wrap P by; `track_pdiff`
// writes the unwrapped momentum into D (null otherwise).  The layout comes
// from ops/cuda_step.py::launch_geometry: `team` lanes per orbit, `teams`
// orbits per block, a block of `threads` threads (team * teams compute
// threads and, where the block has room, one solver warp), its dynamic
// shared memory, and the kernel instance (points a lane holds, block
// threads, blocks an SM).  The return value is the cudaError_t of the
// launch (0 on success); a launch of instances the library does not hold
// (holds()) is refused.
#define ROLLOUT_ENTRY(NAME, SPLIT_MODES, T)                                   \
  extern "C" int NAME(                                                        \
      const T* scal, const T* uq, const T* uP, const T* a0, const T* a1,      \
      const T* auxq, const T* auxp, const T* auxa, const T* q0, const T* p0,  \
      T* Q, T* P, T* D, int B, int ns, int nas, int n_maps, int nm,           \
      int iters, int kind, int aux_kind, int loss_check, int loss_at_new_q,   \
      int explicit_update, int mod_p, int track_pdiff, int team, int teams,   \
      int threads, int smem_bytes, int inst_points, int inst_threads,         \
      int inst_blocks, void* stream) {                                        \
    return run<SPLIT_MODES, T>(                                               \
        scal, uq, uP, a0, a1, auxq, auxp, auxa, q0, p0, Q, P, D, B, ns, nas,  \
        n_maps, nm, iters, kind, aux_kind, loss_check, loss_at_new_q,         \
        explicit_update, mod_p, track_pdiff, team, teams, threads,            \
        smem_bytes, inst_points, inst_threads, inst_blocks, stream);          \
  }
