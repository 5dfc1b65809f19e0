"""One launch of the fused rollout with the unwrapped momentum tracked.

``call`` is the program's ``rollout_in_kernel`` with the configuration's
Newton iterations, loss check and ``track_pdiff``: (Q, P, D), each
(nm, B), D the unwrapped momentum (row 0 = p0, then the running sum of
each step's P - p before P's wrap).  ``control`` is the reference's
rollout (``reference/gp.py::map_step`` a step, Newton for a fixed
``iters``) in bfloat16 over the model of ``control.CONTROLS["deploy"]``,
with D summed the same way.
"""

from __future__ import annotations

import math

import torch

from gpbench.reference import gp as ref_gp

BF16 = torch.bfloat16


def call(pm, q0: torch.Tensor, p0: torch.Tensor, nm: int, iters: int,
         loss_check: bool, track_pdiff: bool):
    from sympgpr_tpu_torch.ops.cuda_step import rollout_in_kernel

    return rollout_in_kernel(pm, q0, p0, nm, iters=iters,
                             loss_check=loss_check, track_pdiff=track_pdiff)


def rollout(model: dict, q0: torch.Tensor, p0: torch.Tensor, nm: int,
            iters: int, lost=None):
    """``ref_gp.rollout`` with D: ``nm`` rows from (q0, p0) in the dtype of
    the inputs and the model, where ``lost(P, q)`` is given the loss check
    at the old q, Q and P wrapped where the model has those wraps, and D
    the running sum of the unwrapped P - p.  Returns (Q, P, D), each
    (nm, B)."""
    mod_q, mod_p = model["mod_q"], model["mod_p"]
    qs, ps, ds = [q0], [p0], [p0]
    q, p, d = q0, p0, p0
    for _ in range(nm - 1):
        Q, P, _ = ref_gp.map_step(model, q, p, iters=iters, tol=0.0,
                                  rows=max(1, q.shape[0]))
        if lost is not None:
            P = torch.where(lost(P, q), math.nan, P)
        d = d + (P - p)
        if mod_p is not None:
            P = torch.remainder(P, mod_p)
        if mod_q is not None:
            Q = torch.remainder(Q, mod_q)
        Q = torch.where(torch.isnan(P), math.nan, Q)
        qs.append(Q)
        ps.append(P)
        ds.append(d)
        q, p = Q, P
    return torch.stack(qs), torch.stack(ps), torch.stack(ds)


def control(model: dict, q0: torch.Tensor, p0: torch.Tensor, nm: int,
            iters: int, loss_check: bool, track_pdiff: bool):
    Q, P, D = rollout(model, q0.to(BF16), p0.to(BF16), nm, iters,
                      model["lost"] if loss_check else None)
    return tuple(x.float().contiguous() for x in (Q, P, D))
