"""HMC over GP hyperparameters, all chains batched (PyTorch port of
``sympgpr_tpu/gp/hmc.py``).

Standard HMC with a fixed leapfrog integrator; the chains advance together
as one batch on the device of their start points.  A log-probability is
batched, ``(C, dim) -> (C,)``, and its gradient is taken by autograd of
its sum (each row depends on its own chain only).  The gradient at the
chain's state is carried from one transition to the next, so a transition
of ``n_leapfrog`` steps evaluates the log-probability ``n_leapfrog``
times.

JAX's threefry streams cannot be reproduced in torch, so each transition
is a pure function of its state and its draws (``hmc_transition``); the
samplers take the draws from one ``torch.Generator`` on the chains'
device.  ``sample_hmc_sharded`` deals the chains over the ranks of a
``torch.distributed`` mesh.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from sympgpr_tpu_torch.gp.likelihood import nll_batched
from sympgpr_tpu_torch.kernels.variants import Kernel

Tensor = torch.Tensor
LogProb = Callable[[Tensor], Tensor]

# dual averaging (Hoffman & Gelman 2014, Algorithm 5)
GAMMA, T0, KAPPA = 0.05, 10.0, 0.75


class HMCResult(NamedTuple):
    samples: Tensor      # (chains, n_samples, dim)
    log_probs: Tensor    # (chains, n_samples)
    accept_rate: Tensor  # (chains,)


def value_and_grad(logprob: LogProb, x: Tensor) -> tuple[Tensor, Tensor]:
    """(log p (C,), its gradient (C, dim)) at the (C, dim) points x."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        lp = logprob(x)
        (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g


def _finite_or(v: Tensor, fill: float) -> Tensor:
    return torch.where(torch.isfinite(v), v, fill)


def _energy_ratio(lp1: Tensor, r1: Tensor, lp0: Tensor, r0: Tensor):
    """log of the Metropolis ratio; a non-finite proposal log-probability
    and a NaN difference (a divergent leapfrog's NaN momenta) are -inf, a
    certain reject that keeps NaN out of the dual-averaging state."""
    lp1 = _finite_or(lp1, -math.inf)
    la = (lp1 - 0.5 * (r1 * r1).sum(-1)) - (lp0 - 0.5 * (r0 * r0).sum(-1))
    return lp1, torch.where(torch.isnan(la), -math.inf, la)


def leapfrog(logprob: LogProb, x: Tensor, r: Tensor, g: Tensor, eps: Tensor):
    """One leapfrog step of size eps (C,) from (x, r) with g = grad at x;
    returns (x, r, log p, grad) at the new point."""
    e = eps[:, None]
    r = r + 0.5 * e * g
    x = x + e * r
    lp, g = value_and_grad(logprob, x)
    r = r + 0.5 * e * g
    return x, r, lp, g


def hmc_transition(logprob: LogProb, x: Tensor, lp: Tensor, g: Tensor,
                   eps: Tensor, p0: Tensor, u: Tensor, n_leapfrog: int):
    """One HMC transition of every chain (``_kernel_one_chain``'s step).

    x (C, dim), lp (C,), g (C, dim) the gradient at x, eps (C,); the draws
    p0 (C, dim) standard normal momenta and u (C,) uniforms.  Accepts
    where log u < log alpha.  Returns (x, lp, g, accept, alpha).
    """
    x1, p1, g1 = x, p0, g
    lp1 = lp
    for _ in range(n_leapfrog):
        x1, p1, lp1, g1 = leapfrog(logprob, x1, p1, g1, eps)
    lp1, log_alpha = _energy_ratio(lp1, p1, lp, p0)
    accept = torch.log(u) < log_alpha
    alpha = torch.clamp(torch.exp(log_alpha), max=1.0)
    a = accept[:, None]
    return (torch.where(a, x1, x), torch.where(accept, lp1, lp),
            torch.where(a, g1, g), accept, alpha)


def find_reasonable_eps(logprob: LogProb, x0: Tensor, lp0: Tensor,
                        g0: Tensor, r0: Tensor, eps0: Tensor) -> Tensor:
    """Stan-style step-size initialization (Hoffman & Gelman 2014, Alg 4),
    per chain: doubles or halves eps until the one-step leapfrog log-ratio
    crosses -log 2, at most 40 times.  r0 (C, dim) are the momenta drawn
    for it; eps0 (C,).  One host read per iteration, for the loop test."""

    def log_ratio(eps):
        _, r1, lp1, _ = leapfrog(logprob, x0, r0, g0, eps)
        return _energy_ratio(lp1, r1, lp0, r0)[1]

    log2 = math.log(2.0)
    la = log_ratio(eps0)
    d = torch.where(la > -log2, 1.0, -1.0).to(x0.dtype)
    eps, it = eps0, torch.zeros_like(eps0)
    while True:
        go = (d * la > -d * log2) & (it < 40)
        if not bool(go.any()):
            return eps
        eps = torch.where(go, eps * torch.exp2(d), eps)
        la = torch.where(go, log_ratio(eps), la)
        it = it + go.to(it.dtype)


def dual_averaging_step(log_eps_bar: Tensor, h_bar: Tensor, t: float,
                        alpha: Tensor, mu: Tensor, target_accept: float):
    """One warmup update of the step size toward ``target_accept`` at
    iteration t = 1, 2, ...; returns (log eps, log eps_bar, h_bar)."""
    h_bar = (1 - 1 / (t + T0)) * h_bar + (target_accept - alpha) / (t + T0)
    log_eps = mu - math.sqrt(t) / GAMMA * h_bar
    w = t ** (-KAPPA)
    return log_eps, w * log_eps + (1 - w) * log_eps_bar, h_bar


def run_chains(logprob: LogProb, x0s: Tensor, n_samples: int, step,
               draw, *, n_warmup: int, step_size: float, seed: int,
               adapt_step_size: bool, target_accept: float):
    """The warmup and sampling loops that HMC and NUTS share.

    ``draw(gen)`` makes one transition's draws; ``step(x, lp, g, eps,
    draws)`` returns (x, lp, g, alpha, *stats).  The draws come from one
    ``torch.Generator`` on the chains' device seeded with ``seed``, in this
    order: with adaptation, the (C, dim) normal momenta of
    ``find_reasonable_eps``; then each transition's draws, warmup first.
    Returns (samples, log_probs, per-transition stats of the sampling
    phase, each stacked along dim 1).
    """
    chains, dim = x0s.shape
    gen = torch.Generator(device=x0s.device)
    gen.manual_seed(seed)
    x = x0s
    lp, g = value_and_grad(logprob, x)
    eps = torch.full((chains,), step_size, dtype=x.dtype, device=x.device)
    if adapt_step_size and n_warmup > 0:
        r0 = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                         device=x.device)
        eps = find_reasonable_eps(logprob, x, lp, g, r0, eps)
        mu = torch.log(10.0 * eps)
        log_eps_bar, h_bar = torch.log(eps), torch.zeros_like(eps)
        for i in range(n_warmup):
            x, lp, g, alpha, *_ = step(x, lp, g, eps, draw(gen))
            log_eps, log_eps_bar, h_bar = dual_averaging_step(
                log_eps_bar, h_bar, float(i + 1), alpha, mu, target_accept)
            eps = torch.exp(log_eps)
        eps = torch.exp(log_eps_bar)
    else:
        for _ in range(n_warmup):
            x, lp, g, *_ = step(x, lp, g, eps, draw(gen))
    xs, lps, stats = [], [], []
    for _ in range(n_samples):
        x, lp, g, *st = step(x, lp, g, eps, draw(gen))
        xs.append(x)
        lps.append(lp)
        stats.append(st)
    stats = [torch.stack(s, 1) for s in zip(*stats)]
    return torch.stack(xs, 1), torch.stack(lps, 1), stats


def sample_hmc(
    logprob: LogProb,
    x0s: Tensor,
    n_samples: int,
    *,
    n_warmup: int = 100,
    step_size: float = 0.05,
    n_leapfrog: int = 16,
    seed: int = 0,
    adapt_step_size: bool = False,
    target_accept: float = 0.8,
) -> HMCResult:
    """Run HMC from (chains, dim) initial points; all chains batched.

    With ``adapt_step_size`` the warmup tunes the step size per chain by
    dual averaging toward ``target_accept``, from ``find_reasonable_eps``;
    sampling then runs at the averaged step size.  Each transition draws
    its (C, dim) momenta, then its (C,) uniforms (``run_chains`` gives the
    order of the whole stream).
    """
    def draw(gen):
        p0 = torch.randn(x0s.shape, generator=gen, dtype=x0s.dtype,
                         device=x0s.device)
        u = torch.rand(x0s.shape[0], generator=gen, dtype=x0s.dtype,
                       device=x0s.device)
        return p0, u

    def step(x, lp, g, eps, draws):
        x, lp, g, accept, alpha = hmc_transition(logprob, x, lp, g, eps,
                                                 *draws, n_leapfrog)
        return x, lp, g, alpha, accept

    xs, lps, (_, accs) = run_chains(
        logprob, x0s, n_samples, step, draw, n_warmup=n_warmup,
        step_size=step_size, seed=seed, adapt_step_size=adapt_step_size,
        target_accept=target_accept)
    return HMCResult(xs, lps, accs.to(x0s.dtype).mean(1))


def shard_chains(x0s: Tensor, mesh, seed: int):
    """(this rank's chains, its seed) for a sampler over all ranks of the
    flattened mesh: a contiguous shard of the chains and seed ``seed * D +
    rank``, a distinct stream a shard (a shared seed would couple the
    chains through common random numbers)."""
    from sympgpr_tpu_torch.distributed.init import flat_index

    r, n = flat_index(mesh)
    if x0s.shape[0] % n:
        raise ValueError(f"{x0s.shape[0]} chains do not divide over {n} "
                         f"ranks")
    s = x0s.shape[0] // n
    return x0s[r * s:(r + 1) * s], seed * n + r


def sample_hmc_sharded(logprob: LogProb, x0s: Tensor, mesh,
                       n_samples: int, **kwargs) -> HMCResult:
    """``sample_hmc`` with the chains over all ranks of the mesh flattened
    (``shard_chains``); x0s holds every chain on every rank.  Each rank runs
    its shard batched; one all-gather at the end gives every rank the
    whole ``HMCResult`` in chain order."""
    from sympgpr_tpu_torch.distributed.init import all_gather_rows

    x0, seed = shard_chains(x0s, mesh, int(kwargs.pop("seed", 0)))
    res = sample_hmc(logprob, x0, n_samples, seed=seed, **kwargs)
    return HMCResult(*all_gather_rows(res, mesh))


def nll_logprob(kernel: Kernel, X: Tensor, z: Tensor,
                sig2n: float) -> LogProb:
    """Batched log p(theta) = -NLL(10^theta) - sum (theta/3)^2 / 2 of the
    symplectic GP, a broad Gaussian prior on the log10 hyperparameters
    (sig last), -inf where it is not finite; ``nll_batched`` over the
    (C, d+1) rows."""

    def logprob(theta: Tensor) -> Tensor:
        hyp = 10.0 ** theta
        nll = nll_batched(kernel, hyp[:, :-1], hyp[:, -1], sig2n, X, z)
        prior = -0.5 * torch.sum((theta / 3.0) ** 2, -1)
        return _finite_or(-nll + prior, -math.inf)

    return logprob


def start_points(x0, chains: int, seed: int) -> np.ndarray:
    """(chains, d) start points x0 + 0.05 N(0, 1) from
    ``numpy.random.default_rng(seed)``, as the JAX CLI draws them."""
    x0 = np.asarray(x0, np.float64)
    rng = np.random.default_rng(seed)
    return x0[None, :] + 0.05 * rng.standard_normal((chains, len(x0)))
