"""Symplectic map application (PyTorch port of
``sympgpr_tpu/maps/symplectic.py``).

Per step the implicit map solves ``pGP(q, P) - p + P = 0`` for every orbit
and then updates ``Q = q + dq``.  The posterior mean of the generating
function is the scalar field ``g(v) = sig * sum_i alpha[i] . grad_u k(u_i,
v)``; everything the map needs is a derivative of it: ``pGP = dg/dq``,
``dq = dg/dP`` and the Newton slope ``d pGP / dP``.  The generic path takes
them all from ``torch.func`` (``grad`` and ``vmap`` over the kernel's own
``fn``), for any kernel: it is the oracle of the factorized fast path
(``maps/fast_apply.py``), which ``apply_map`` and ``apply_map_split`` take
by default.  The orbit batch advances in lock-step: one masked Newton loop
serves all orbits (converged and non-finite lanes are frozen; one host
sync per iteration), inside a Python loop over map steps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, grad_and_value, vmap

from sympgpr_tpu_torch.gp.model import AuxGP, SympGP

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Posterior mean machinery


def genfun_mean(sgp: SympGP, v: Tensor) -> Tensor:
    """Posterior mean (up to a constant) of the generating function at
    v = (q, P): g(v) = sig * sum_{i,r} alpha[r*N+i] * d k(u_i, v) / d u_r.
    Its v-gradient is the ``Kstar.T @ alpha`` prediction
    (``gp.predict.predict_df``)."""
    n = sgp.n_train
    gu = vmap(lambda u: sgp.kernel.grad_u(u, v, sgp.params))(sgp.X)
    a = sgp.alpha.reshape(2, n)
    return sgp.sig * (a[0] @ gu[:, 0] + a[1] @ gu[:, 1])


def dF_mean(sgp: SympGP, v: Tensor) -> Tensor:
    """(pGP, dq) at a single mixed point v = (q, P)."""
    return grad(lambda w: genfun_mean(sgp, w))(v)


def p_residual_and_slope(sgp: SympGP, q: Tensor, P: Tensor, p: Tensor):
    """Newton residual f(P) = pGP(q, P) - p + P and its exact df/dP (a third
    derivative of the kernel)."""

    def f(Pv):
        return dF_mean(sgp, torch.stack([q, Pv]))[0] - p + Pv

    slope, value = grad_and_value(f)(P)
    return value, slope


def aux_mean(aux: AuxGP, q: Tensor, p: Tensor) -> Tensor:
    """Posterior mean of the auxiliary ordinary GP at (q, p)."""
    v = torch.stack([q, p])
    kvec = vmap(lambda u: aux.kernel.fn(u, v, aux.params))(aux.X)
    return aux.sig * (kvec @ aux.alpha)


def guess_P(aux: AuxGP, q: Tensor, p: Tensor) -> Tensor:
    """Initial Newton guess for P."""
    m = aux_mean(aux, q, p)
    return p + m if aux.delta else m


# ---------------------------------------------------------------------------
# Batched implicit solve


def calc_P(sgp: SympGP, aux: AuxGP, q: Tensor, p: Tensor,
           tol: float = 1e-13, maxiter: int = 20) -> Tensor:
    """Solve pGP(q, P) - p + P = 0 for a whole batch of orbits at once.

    Masked lock-step Newton from the aux-GP guess: all lanes iterate
    together; a lane is done when its step falls below ``tol * (1 + |P|)``
    or its update is not finite (then it keeps its last P).  Ends when
    every lane is done or after ``maxiter`` iterations.  q, p: (B,).
    """
    P = vmap(lambda qq, pp: guess_P(aux, qq, pp))(q, p)
    res_slope = vmap(
        lambda qq, PP, pp: p_residual_and_slope(sgp, qq, PP, pp))
    done = ~torch.isfinite(P)
    it = 0
    while it < maxiter and not bool(done.all()):
        f, fp = res_slope(q, P, p)
        step = f / fp
        Pn = P - step
        bad = ~torch.isfinite(Pn)
        Pn = torch.where(done | bad, P, Pn)
        done = done | (torch.abs(step) < tol * (1.0 + torch.abs(Pn))) | bad
        P = Pn
        it += 1
    return P


def calc_Q(sgp: SympGP, q: Tensor, P: Tensor) -> Tensor:
    """Batched Delta q = dg/dP at (q, P_new)."""
    return vmap(lambda qq, PP: dF_mean(sgp, torch.stack([qq, PP]))[1])(q, P)


def calc_P_explicit(sgp: SympGP, q: Tensor, p: Tensor) -> Tensor:
    """Explicit update, "Algorithm 2": P = p - pGP(q, p); exact for
    separable (sum) kernels, where the implicit coupling vanishes."""
    pGP = vmap(lambda qq, pp: dF_mean(sgp, torch.stack([qq, pp]))[0])(q, p)
    return p - pGP


# ---------------------------------------------------------------------------
# Rollout


class MapConfig(NamedTuple):
    """Rollout configuration."""

    explicit: bool = False
    mod_q: float | None = 2.0 * 3.141592653589793
    mod_p: float | None = None
    track_pdiff: bool = False
    newton_tol: float = 1e-13
    newton_maxiter: int = 20


class Trajectory(NamedTuple):
    q: Tensor  # (nm, B)
    p: Tensor  # (nm, B)
    pdiff: Tensor | None = None  # (nm, B) unwrapped momentum


LossFn = Callable[[Tensor, Tensor, Tensor, int], Tensor]
# (q_old, q_new, P_new, step_index) -> (B,) bool mask of lost orbits


def _finish_step(q: Tensor, p: Tensor, P: Tensor, i: int, cfg: MapConfig,
                 loss_pre: LossFn | None, loss_post: LossFn | None,
                 q_update: Callable[[Tensor], Tensor]):
    """The rest of a step once P is solved, shared by the generic and the
    fast path: the loss check at the old q, the mod_p wrap, Q = q +
    q_update(P wrapped), the mod_q wrap, the loss check at the new q and
    NaN in Q wherever P is NaN.  Returns (Q, P wrapped, P - p)."""
    if loss_pre is not None:
        P = torch.where(loss_pre(q, q, P, i), torch.nan, P)
    dP = P - p
    Pw = torch.remainder(P, cfg.mod_p) if cfg.mod_p is not None else P
    Q = q_update(Pw) + q
    if cfg.mod_q is not None:
        Q = torch.remainder(Q, cfg.mod_q)
    if loss_post is not None:
        lost = loss_post(q, Q, Pw, i)
        Pw = torch.where(lost, torch.nan, Pw)
        Q = torch.where(lost, torch.nan, Q)
    Q = torch.where(torch.isnan(Pw), torch.nan, Q)
    return Q, Pw, dP


def _iterate(step: Callable[[int, Tensor, Tensor], tuple],
             q0: Tensor, p0: Tensor, nm: int,
             track_pdiff: bool) -> Trajectory:
    """nm - 1 steps ``step(i, q, p) -> (Q, P, dP)`` from (q0, p0); row 0 of
    the (nm, B) trajectories is the initial condition, pdiff sums dP."""
    q = torch.atleast_1d(q0)
    p = torch.atleast_1d(p0)
    pdiff = p
    qs, ps, pds = [q], [p], [p]
    for i in range(nm - 1):
        q, p, dP = step(i, q, p)
        qs.append(q)
        ps.append(p)
        if track_pdiff:
            pdiff = pdiff + dP
            pds.append(pdiff)
    return Trajectory(torch.stack(qs), torch.stack(ps),
                      torch.stack(pds) if track_pdiff else None)


def _map_step(sgp: SympGP, aux: AuxGP | None, q: Tensor, p: Tensor, i: int,
              cfg: MapConfig, loss_pre: LossFn | None,
              loss_post: LossFn | None):
    """One step of the generic path; returns (Q, P, dP)."""
    if cfg.explicit:
        P = calc_P_explicit(sgp, q, p)
    else:
        P = calc_P(sgp, aux, q, p, tol=cfg.newton_tol,
                   maxiter=cfg.newton_maxiter)
    return _finish_step(q, p, P, i, cfg, loss_pre, loss_post,
                        lambda Pw: calc_Q(sgp, q, Pw))


def _apply_map_generic(sgp: SympGP, aux: AuxGP | None, q0: Tensor,
                       p0: Tensor, nm: int, cfg: MapConfig = MapConfig(),
                       loss_pre: LossFn | None = None,
                       loss_post: LossFn | None = None) -> Trajectory:
    """Autodiff-everything rollout (any kernel; the fast path's oracle)."""
    return _iterate(
        lambda i, q, p: _map_step(sgp, aux, q, p, i, cfg, loss_pre,
                                  loss_post),
        q0, p0, nm, cfg.track_pdiff)


def apply_map(
    sgp: SympGP,
    aux: AuxGP | None,
    q0: Tensor,
    p0: Tensor,
    nm: int,
    cfg: MapConfig = MapConfig(),
    loss_pre: LossFn | None = None,
    loss_post: LossFn | None = None,
    prefer_fast: bool = True,
) -> Trajectory:
    """Iterate the learned map nm-1 times for a batch of orbits.

    Returns (nm, B) trajectories whose row 0 is the initial condition.
    Product and sum kernels (all of the family) take the factorized fast
    path; ``prefer_fast=False`` forces the generic autodiff path.
    """
    from sympgpr_tpu_torch.maps import fast_apply

    if prefer_fast and fast_apply.supports(sgp.kernel.name):
        return fast_apply.apply_map_fast(sgp, aux, q0, p0, nm, cfg,
                                         loss_pre, loss_post)
    return _apply_map_generic(sgp, aux, q0, p0, nm, cfg, loss_pre,
                              loss_post)


def apply_map_split(
    sgps: list[SympGP],
    auxes: list[AuxGP | None],
    q0: Tensor,
    p0: Tensor,
    nm: int,
    n_maps: int,
    cfg: MapConfig = MapConfig(),
    loss_post: LossFn | None = None,
    prefer_fast: bool = True,
) -> Trajectory:
    """Split variant: cycle through ``n_maps`` independently fitted
    sub-maps.

    ``sgps``/``auxes`` hold one model per sub-map (``stack_models``).
    Step i uses sub-map ``i % n_maps`` and applies ``loss_post`` at the new
    q.  Returns (nm, B) trajectories whose row 0 is the initial condition.
    The fast path by default; ``prefer_fast=False`` (or a kernel outside
    the fast family) runs every step on the generic path.
    """
    from sympgpr_tpu_torch.maps import fast_apply

    if len(sgps) != n_maps or len(auxes) != n_maps:
        raise ValueError(f"{n_maps} sub-maps, got {len(sgps)} models and "
                         f"{len(auxes)} aux models")
    if prefer_fast and all(fast_apply.supports(s.kernel.name) for s in sgps):
        return fast_apply.apply_map_split_fast(sgps, auxes, q0, p0, nm, cfg,
                                               loss_post=loss_post)
    return _iterate(
        lambda i, q, p: _map_step(sgps[i % n_maps], auxes[i % n_maps], q, p,
                                  i, cfg, None, loss_post),
        q0, p0, nm, cfg.track_pdiff)


def stack_models(models: list) -> list:
    """The sub-maps' models for ``apply_map_split``: a list, one model per
    sub-map (the JAX package stacks them into one pytree)."""
    return list(models)
