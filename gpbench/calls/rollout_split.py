"""One launch of the fused rollout over a Split deployment.

``call`` is the program's ``rollout_in_kernel`` with the configuration's
Newton iterations, loss check and place of that check
(``loss_at_new_q``): (Q, P), each (nm, B).  ``control`` is the
reference's Split rollout (``rollouts_split.rollout``) in bfloat16 over
the models of ``deploy_split.control``.
"""

from __future__ import annotations

import torch

from gpbench import rollouts_split

BF16 = torch.bfloat16


def call(pm, q0: torch.Tensor, p0: torch.Tensor, nm: int, iters: int,
         loss_check: bool, loss_at_new_q: bool):
    from sympgpr_tpu_torch.ops.cuda_step import rollout_in_kernel

    return rollout_in_kernel(pm, q0, p0, nm, iters=iters,
                             loss_check=loss_check,
                             loss_at_new_q=loss_at_new_q)


def control(models: list[dict], q0: torch.Tensor, p0: torch.Tensor, nm: int,
            iters: int, loss_check: bool, loss_at_new_q: bool):
    lost = models[0]["lost"] if loss_check else None
    Q, P = rollouts_split.rollout(models, q0.to(BF16), p0.to(BF16), nm,
                                  iters, lost, loss_at_new_q)
    return Q.float().contiguous(), P.float().contiguous()
