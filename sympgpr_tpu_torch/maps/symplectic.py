"""Symplectic map application: configuration, trajectory container and the
dispatch of ``apply_map`` (PyTorch port of part of
``sympgpr_tpu/maps/symplectic.py``).

Every kernel of the family is a product or sum kernel, so ``apply_map``
and the Split variant ``apply_map_split`` run the factorized fast path
(``maps/fast_apply.py``).  The autodiff generic path of the JAX package
(``calc_P``, ``calc_Q``, ``_apply_map_generic``), which is the fast
path's oracle there, is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from sympgpr_tpu_torch.gp.model import AuxGP, SympGP

Tensor = torch.Tensor


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


def apply_map(
    sgp: SympGP,
    aux: AuxGP | None,
    q0: Tensor,
    p0: Tensor,
    nm: int,
    cfg: MapConfig = MapConfig(),
    loss_pre: LossFn | None = None,
    loss_post: LossFn | None = None,
) -> Trajectory:
    """Iterate the learned map nm-1 times for a batch of orbits.

    Returns (nm, B) trajectories whose row 0 is the initial condition.
    """
    from sympgpr_tpu_torch.maps import fast_apply

    if fast_apply.supports(sgp.kernel.name):
        return fast_apply.apply_map_fast(sgp, aux, q0, p0, nm, cfg,
                                         loss_pre, loss_post)
    raise NotImplementedError(
        "the autodiff generic map path is not ported yet")


def apply_map_split(
    sgps: list[SympGP],
    auxes: list[AuxGP | None],
    q0: Tensor,
    p0: Tensor,
    nm: int,
    n_maps: int,
    cfg: MapConfig = MapConfig(),
    loss_post: LossFn | None = None,
) -> Trajectory:
    """Split variant: cycle through ``n_maps`` independently fitted
    sub-maps.

    ``sgps``/``auxes`` hold one model per sub-map (``stack_models``).
    Step i uses sub-map ``i % n_maps`` and applies ``loss_post`` at the new
    q.  Returns (nm, B) trajectories whose row 0 is the initial condition.
    """
    from sympgpr_tpu_torch.maps import fast_apply

    if len(sgps) != n_maps or len(auxes) != n_maps:
        raise ValueError(f"{n_maps} sub-maps, got {len(sgps)} models and "
                         f"{len(auxes)} aux models")
    if not all(fast_apply.supports(s.kernel.name) for s in sgps):
        raise NotImplementedError(
            "the autodiff generic map path is not ported yet")
    return fast_apply.apply_map_split_fast(sgps, auxes, q0, p0, nm, cfg,
                                           loss_post=loss_post)


def stack_models(models: list) -> list:
    """The sub-maps' models for ``apply_map_split``: a list, one model per
    sub-map (the JAX package stacks them into one pytree)."""
    return list(models)
