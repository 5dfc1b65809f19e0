"""What the Split rollout's driver (``drivers/rollout_split.py``), its
calls (``calls/deploy_split.py``, ``calls/rollout_split.py``) and their
controls share: a Split configuration's sub-maps one by one, the
reference's model of each, and the reference's Split rollout.

A Split configuration holds ``sub_maps`` maps: its training pairs are
(N, sub_maps) columns, one a sub-map, and each of the three lists of
``hyperparameters.sympgp`` and ``hyperparameters.aux`` (lx, ly, sig)
holds one value a sub-map.  Row t of a trajectory goes to row t + 1 by
sub-map t mod sub_maps.  Where the configuration checks losses at the
new q (``loss_at_new_q``), the system's loss rule is applied to the new
(Q, P), after the wraps; else to (P, the old q), before them.
"""

from __future__ import annotations

import math

import torch

from gpbench.reference import gp as ref_gp
from gpbench.rollouts import reference_model


def sub_maps(config: dict, train: dict) -> list[tuple[dict, dict]]:
    """(configuration, training pairs) of each sub-map: the configuration
    with the sub-map's hyperparameters, as a one-map configuration holds
    them, and the pairs' column of the sub-map."""
    hyp = config["hyperparameters"]
    out = []
    for m in range(config["sub_maps"]):
        h = {k: [v[m] for v in hyp[k]] for k in ("sympgp", "aux")}
        out.append((dict(config, hyperparameters=h),
                    {k: v[:, m] for k, v in train.items()}))
    return out


def reference_models(config: dict, train: dict) -> list[dict]:
    """The reference's float64 model of each sub-map
    (``rollouts.reference_model``: alpha of both GPs solved at the
    deployment noise)."""
    return [reference_model(c, d) for c, d in sub_maps(config, train)]


def rollout(models: list[dict], q0: torch.Tensor, p0: torch.Tensor, nm: int,
            iters: int, lost=None, at_new_q: bool = True):
    """``nm`` rows from (q0, p0) in the dtype of the inputs and the models,
    row t + 1 by ``models[t % len(models)]`` with ``iters`` Newton
    iterations a step: where ``lost(P, q)`` is given, the loss rule at the
    new (Q, P) after the wraps (``at_new_q``) or at the old q before them,
    NaN from the step that crosses it; Q wrapped into [0, mod_q) and P
    into [0, mod_p) where the models have those wraps.  Returns (Q, P),
    each (nm, B)."""
    mod_q, mod_p = models[0]["mod_q"], models[0]["mod_p"]
    qs, ps = [q0], [p0]
    q, p = q0, p0
    for t in range(nm - 1):
        Q, P, _ = ref_gp.map_step(models[t % len(models)], q, p, iters=iters,
                                  tol=0.0, rows=max(1, q.shape[0]))
        if lost is not None and not at_new_q:
            P = torch.where(lost(P, q), math.nan, P)
        if mod_p is not None:
            P = torch.remainder(P, mod_p)
        if mod_q is not None:
            Q = torch.remainder(Q, mod_q)
        if lost is not None and at_new_q:
            P = torch.where(lost(P, Q), math.nan, P)
        Q = torch.where(torch.isnan(P), math.nan, Q)
        qs.append(Q)
        ps.append(P)
        q, p = Q, P
    return torch.stack(qs), torch.stack(ps)
