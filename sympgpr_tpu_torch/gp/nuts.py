"""No-U-Turn Sampler over GP hyperparameters (PyTorch port of
``sympgpr_tpu/gp/nuts.py``): iterative multinomial NUTS, all chains
batched in lock-step.

The recursive tree doubling of Hoffman & Gelman (2014) is two nested
loops (doublings outside, leapfrog steps inside) plus a checkpoint buffer
of ``max_depth + 1`` states that reproduces exactly the U-turn checks the
recursion would make.  The chains move in lock-step, as under JAX's
``vmap``: at doubling k every chain still extending builds a subtree of
2^k leaves, and a chain that turns, diverges or reaches its subtree's end
is masked in every state update until the others finish.  The loop tests
("any chain still extending") are the only host reads besides the NLL's.

Checkpoint bookkeeping: number subtree leaves 1..2^d in generation order.
Leaf n odd is the left edge of one or more dyadic blocks and is stored at
slot ``popcount(n-1)``; leaf n even closes the blocks ``[n-2^j+1, n]`` for
j = 1..ctz(n), whose left edges sit at the contiguous slot range
``[popcount(n)-1, popcount(n)+ctz(n)-2]``.  In lock-step n is the same for
every chain, so the slots are host integers.

A transition is a pure function of its state and its draws
(``NUTSDraws``); ``sample_nuts_sharded`` deals the chains over the ranks of
a ``torch.distributed`` mesh.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sympgpr_tpu_torch.gp.hmc import LogProb, leapfrog, run_chains, \
    shard_chains

Tensor = torch.Tensor

_DIVERGENCE = 1000.0  # energy-error divergence threshold (Stan's default)


class NUTSResult(NamedTuple):
    samples: Tensor      # (chains, n_samples, dim)
    log_probs: Tensor    # (chains, n_samples)
    accept_stat: Tensor  # (chains,) mean Metropolis accept statistic
    mean_depth: Tensor   # (chains,) mean terminal tree depth
    n_divergent: Tensor  # (chains,) divergent transitions in sampling phase


class NUTSDraws(NamedTuple):
    """The random numbers of one transition of C chains."""

    r0: Tensor          # (C, dim) standard normal momenta
    dirs: Tensor        # (C, max_depth) +-1, the direction of doubling k
    u_leaf: Tensor      # (C, 2^(max_depth+1)) uniforms by global leaf id L + n
    u_doubling: Tensor  # (C, max_depth) uniforms of the doubling k


def draw(gen: torch.Generator, chains: int, dim: int, max_depth: int,
         dtype: torch.dtype, device) -> NUTSDraws:
    """One transition's draws from ``gen``, in the order of the fields."""
    kw = dict(generator=gen, device=device)
    r0 = torch.randn((chains, dim), dtype=dtype, **kw)
    dirs = 2 * torch.randint(0, 2, (chains, max_depth), **kw) - 1
    u_leaf = torch.rand((chains, 2 ** (max_depth + 1)), dtype=dtype, **kw)
    u_doubling = torch.rand((chains, max_depth), dtype=dtype, **kw)
    return NUTSDraws(r0, dirs.to(dtype), u_leaf, u_doubling)


def _popcount(n):
    if isinstance(n, Tensor):
        c = torch.zeros_like(n)
        for b in range(63):
            c = c + ((n >> b) & 1)
        return c
    return bin(n).count("1")


def _ctz(n):
    """Count of trailing zero bits (n > 0)."""
    return _popcount((n & -n) - 1)


def _store_slot(n):
    """Checkpoint slot for odd leaf n (1-indexed within its subtree)."""
    return _popcount(n - 1)


def _check_range(n):
    """(idx_min, idx_max) of checkpoint slots U-turn-checked against even
    leaf n."""
    lo = _popcount(n) - 1
    return lo, lo + _ctz(n) - 1


def _uturn(dx: Tensor, r_a: Tensor, r_b: Tensor) -> Tensor:
    """Generalized U-turn criterion on the segment a -> b (integration
    order), over the last dim: either end's momentum points back across
    the segment."""
    return ((dx * r_a).sum(-1) < 0.0) | ((dx * r_b).sum(-1) < 0.0)


def _sel(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """Per-chain select: mask (C,) against (C,) or (C, dim) states."""
    if new.dim() > mask.dim():
        mask = mask[:, None]
    return torch.where(mask, new, old)


def nuts_transition(logprob: LogProb, x0: Tensor, lp0: Tensor, g0: Tensor,
                    eps: Tensor, draws: NUTSDraws, max_depth: int):
    """One NUTS transition of every chain (``_kernel_one_chain``'s step).

    x0 (C, dim), lp0 (C,), g0 (C, dim) the gradient at x0, eps (C,).
    Returns (x, lp, g, accept statistic, depth, diverging), each per chain;
    x, lp and g are the new state.
    """
    C, dim = x0.shape
    r0 = draws.r0
    H0 = lp0 - 0.5 * (r0 * r0).sum(-1)
    zero = torch.zeros_like(lp0)
    false = torch.zeros(C, dtype=torch.bool, device=x0.device)
    # ends in the *global* time frame: momenta point in +time direction
    s = dict(x_l=x0, r_l=r0, g_l=g0, x_r=x0, r_r=r0, g_r=g0,
             x_prop=x0, lp_prop=lp0, g_prop=g0,
             logW=zero,  # leaf 0 has relative weight 1
             sum_alpha=zero, n_alpha=zero, turning=false, diverging=false,
             depth=zero)
    for k in range(max_depth):
        active = ~s["turning"] & ~s["diverging"]
        if not bool(active.any()):
            break
        direction = draws.dirs[:, k]
        fwd = direction > 0
        t = _subtree(logprob, s, k, direction, fwd, active, H0, eps, draws,
                     max_depth)
        ok = active & ~t["turning"] & ~t["diverging"]
        # biased progressive sampling across the doubling
        take = ok & (torch.log(draws.u_doubling[:, k])
                     < t["logW"] - s["logW"])
        n = dict(s)
        for key in ("x", "lp", "g"):
            n[f"{key}_prop"] = _sel(take, t[f"{key}_sub"], s[f"{key}_prop"])
        n["logW"] = _sel(ok, torch.logaddexp(s["logW"], t["logW"]),
                         s["logW"])
        # move the extended end (back to the global frame)
        r_glob = t["r"] * direction[:, None]
        for side, on in (("r", ok & fwd), ("l", ok & ~fwd)):
            n[f"x_{side}"] = _sel(on, t["x"], s[f"x_{side}"])
            n[f"r_{side}"] = _sel(on, r_glob, s[f"r_{side}"])
            n[f"g_{side}"] = _sel(on, t["g"], s[f"g_{side}"])
        turning = t["turning"] | (ok & _uturn(n["x_r"] - n["x_l"], n["r_l"],
                                               n["r_r"]))
        n["turning"] = _sel(active, turning, s["turning"])
        n["diverging"] = _sel(active, t["diverging"], s["diverging"])
        for key in ("sum_alpha", "n_alpha"):
            n[key] = s[key] + t[key]
        n["depth"] = s["depth"] + active.to(zero.dtype)
        s = n
    alpha_mean = s["sum_alpha"] / torch.clamp(s["n_alpha"], min=1.0)
    return (s["x_prop"], s["lp_prop"], s["g_prop"], alpha_mean, s["depth"],
            s["diverging"])


def _subtree(logprob, s, k, direction, fwd, active, H0, eps, draws,
             max_depth):
    """Integrate 2^k new leaves from the moving end of each active chain,
    in the integration frame: always step forward with eps, the momentum
    flipped so that backward extension is forward dynamics."""
    L = 1 << k
    x = _sel(fwd, s["x_r"], s["x_l"])
    r = _sel(fwd, s["r_r"], s["r_l"]) * direction[:, None]
    g = _sel(fwd, s["g_r"], s["g_l"])
    C, dim = x.shape
    zero = torch.zeros_like(H0)
    t = dict(x_sub=x, lp_sub=s["lp_prop"], g_sub=s["g_prop"],
             logW=torch.full_like(H0, -math.inf), sum_alpha=zero,
             n_alpha=zero, turning=torch.zeros_like(active),
             diverging=torch.zeros_like(active))
    ck_x = x.new_zeros((C, max_depth + 1, dim))
    ck_r = x.new_zeros((C, max_depth + 1, dim))
    for n in range(1, L + 1):
        live = active & ~t["turning"] & ~t["diverging"]
        if not bool(live.any()):
            break
        # a chain no longer extending is evaluated at its start point,
        # whose log-probability is finite; its results are masked
        x1, r1, lp, g1 = leapfrog(logprob, _sel(live, x, s["x_prop"]), r, g,
                                  eps)
        dH = (lp - 0.5 * (r1 * r1).sum(-1)) - H0
        dH = torch.where(torch.isfinite(dH), dH, -math.inf)
        diverging = dH < -_DIVERGENCE
        # progressive multinomial sampling within the subtree, by the
        # globally unique leaf id L + n
        new_logW = torch.logaddexp(t["logW"], dH)
        take = live & (torch.log(draws.u_leaf[:, L + n]) < dH - new_logW)
        t["x_sub"] = _sel(take, x1, t["x_sub"])
        t["lp_sub"] = _sel(take, lp, t["lp_sub"])
        t["g_sub"] = _sel(take, g1, t["g_sub"])
        # checkpoint store (odd leaves) / U-turn checks (even)
        if n & 1:
            slot = _store_slot(n)
            ck_x[:, slot] = _sel(live, x1, ck_x[:, slot])
            ck_r[:, slot] = _sel(live, r1, ck_r[:, slot])
            turning = torch.zeros_like(live)
        else:
            lo, hi = _check_range(n)
            dx = x1[:, None, :] - ck_x[:, lo:hi + 1]
            turning = _uturn(dx, ck_r[:, lo:hi + 1], r1[:, None, :]).any(-1)
        alpha = torch.clamp(torch.exp(dH), max=1.0)
        x, r, g = _sel(live, x1, x), _sel(live, r1, r), _sel(live, g1, g)
        t["logW"] = _sel(live, new_logW, t["logW"])
        t["sum_alpha"] = t["sum_alpha"] + torch.where(live, alpha, 0.0)
        t["n_alpha"] = t["n_alpha"] + live.to(zero.dtype)
        t["turning"] = _sel(live, turning, t["turning"])
        t["diverging"] = _sel(live, diverging, t["diverging"])
    t.update(x=x, r=r, g=g)
    return t


def sample_nuts(
    logprob: LogProb,
    x0s: Tensor,
    n_samples: int,
    *,
    n_warmup: int = 200,
    step_size: float = 0.05,
    max_depth: int = 8,
    seed: int = 0,
    adapt_step_size: bool = True,
    target_accept: float = 0.8,
) -> NUTSResult:
    """Run NUTS from (chains, dim) initial points; all chains batched.

    Warmup tunes the step size per chain by dual averaging (Hoffman &
    Gelman 2014, Algorithm 5) on the trajectory-mean accept statistic,
    from ``find_reasonable_eps``; sampling runs at the averaged step size.
    Each transition draws ``NUTSDraws`` in the order of its fields
    (``run_chains`` gives the order of the whole stream).
    """
    chains, dim = x0s.shape

    def step(x, lp, g, eps, draws):
        return nuts_transition(logprob, x, lp, g, eps, draws, max_depth)

    xs, lps, (alphas, depths, divs) = run_chains(
        logprob, x0s, n_samples, step,
        lambda gen: draw(gen, chains, dim, max_depth, x0s.dtype, x0s.device),
        n_warmup=n_warmup, step_size=step_size, seed=seed,
        adapt_step_size=adapt_step_size, target_accept=target_accept)
    return NUTSResult(xs, lps, alphas.mean(1), depths.mean(1),
                      divs.sum(1))


def sample_nuts_sharded(logprob: LogProb, x0s: Tensor, mesh, n_samples: int,
                        **kwargs) -> NUTSResult:
    """``sample_nuts`` with the chains over all ranks of the mesh flattened
    (``hmc.shard_chains``); no communication but one all-gather at the
    end, which gives every rank the whole ``NUTSResult`` in chain
    order."""
    from sympgpr_tpu_torch.distributed.init import all_gather_rows

    x0, seed = shard_chains(x0s, mesh, int(kwargs.pop("seed", 0)))
    res = sample_nuts(logprob, x0, n_samples, seed=seed, **kwargs)
    return NUTSResult(*all_gather_rows(res, mesh))
