"""The yardstick's peaks and work counts: the least time one NVIDIA H100
SXM could take for a launch's work, counted from shapes alone.

Peaks are NVIDIA's data-sheet rates at the 700 W limit: 3.35 TB/s of
HBM3, 67 TFLOP/s in float32 outside the tensor cores and 67 TFLOP/s in
float64 on the tensor cores (DMMA), 34 TFLOP/s in float64 outside them,
16 exponentials a clock on each of the 132 SMs' special-function units
at 1.98 GHz, and one instruction a clock from each scheduler, i.e. half
the float32 rate in thread-instructions.  A card set below 700 W runs
below these rates; the run reports its power limit beside every share.
The rollout's counts are a frozen copy of the program's smoke run
(``rollout_bound``); the covariance kernels are counted by their bytes
only; the fit step by its three n^3/3 products and its bytes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
DMMA_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
SFU_EXP_PER_S = 132 * 16 * 1.98e9
INSTR_PER_S = FP32_FLOP_PER_S / 2

# float32 operations (an FMA counts 2) per training pair in the rollout
# kernel's formulas; the exps are counted apart, on the SFUs
FLOP_SETUP = 21   # sin/cos of h(u - q), s, s', s'', c0..c3
FLOP_NEWTON = 15  # a Newton iteration
FLOP_Q = 11       # the q update
FLOP_AUX = 11     # an aux point
FLOP_ORBIT = 250  # an orbit and step: the Newton updates, the loss solve
NEWTON_ITERS = 5  # the kernel's fixed Newton iterations


def bound_ms(nbytes: float, flops: float = 0.0, fp64: bool = False,
             exps: float = 0.0) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / (FP64_FLOP_PER_S if fp64 else FP32_FLOP_PER_S),
                exps / SFU_EXP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rollout_bound(B: int, nm: int, ns: int, nas: int, elt: int,
                  iters: int = NEWTON_ITERS) -> dict:
    """One launch of B orbits over nm rows (nm - 1 steps) of the implicit
    map with ``ns`` training and ``nas`` aux points: every column read
    once, the initial conditions read and Q, P written once; per
    orbit-step (1 + iters) exps per training point (one a Newton iteration
    and one for the q update) and one per aux point."""
    steps = (nm - 1) * B
    exps = steps * ((1 + iters) * ns + nas)
    flops = steps * (ns * (FLOP_SETUP + iters * FLOP_NEWTON + FLOP_Q)
                     + nas * FLOP_AUX + FLOP_ORBIT)
    nbytes = elt * ((4 * ns + 3 * nas) + 2 * B + 2 * nm * B)
    ms, by = bound_ms(nbytes, flops, elt == 8, 0.0 if elt == 8 else exps)
    return dict(bound_ms=ms, bound_by=by, exps=exps, flops=flops,
                bytes=nbytes)


def cov_build_bytes(N: int, elt: int) -> int:
    """The build writes Ky, (2N)^2 elements, and reads the points."""
    return elt * (4 * N * N + 2 * N)


def cov_contraction_bytes(N: int, elt: int) -> int:
    """The fused contraction reads half of S (the lower triangles of its
    qq and PP blocks and its lower-left block), alpha and the points."""
    return elt * (N * (N + 1) + N * N + 4 * N)


def tri_inv_flops(n: int, base: int = 512) -> float:
    """The triangular products of one blocked inverse of an (n, n) factor
    padded to m = base 2^k: at level s each of m / 2s pairs multiplies an
    (s, s) block by a triangular one twice, s^3 operations each."""
    m = base
    while m < n:
        m *= 2
    flops, s = 0.0, base
    while s < m:
        flops += (m // (2 * s)) * 2 * s**3
        s *= 2
    return flops


def syrk_flops(n: int) -> float:
    """S = W^T W on and below the diagonal for triangular W: n^3 / 3."""
    return n**3 / 3


def fit_step(N: int, elt: int) -> dict:
    """The least time of one Adam step of the closed-form NLL at N points
    (n = 2N): the Cholesky, the triangular inverse and the syrk, n^3 / 3
    operations each at 67 TFLOP/s (float32 outside the tensor cores; the
    syrk's float64 DMMA), and the bytes of the build (Ky written), the
    contraction (half of S read) and the alpha solve (the factor read
    twice).  Left out: the Cholesky's n square roots and n^2 / 2
    divisions, the inverse's base-block solves (n base^2 / 3), the alpha
    solve's 2 n^2 operations, the log-determinant's n logs, the factor's
    and S's own writes, and the Adam update's few scalars."""
    n = 2 * N
    chol = n**3 / 3 / FP32_FLOP_PER_S
    inv = n**3 / 3 / FP32_FLOP_PER_S
    syrk = n**3 / 3 / DMMA_FLOP_PER_S
    nbytes = (cov_build_bytes(N, elt) + cov_contraction_bytes(N, elt)
              + elt * n * n)
    total = chol + inv + syrk + nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * total, flops=3 * n**3 / 3, bytes=nbytes)
