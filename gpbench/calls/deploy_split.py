"""The Split deployment: one pair of GPs a sub-map, packed together for
the rollout kernel's sub-map cycling.

``call`` is the program's: for each sub-map the symplectic GP and the
aux GP of the configuration's kernel and that sub-map's recorded
hyperparameters, solved in float64 on the data's device
(``SympGP.create``, ``AuxGP.create``), re-solved at the deployment jitter
where the configuration has one (``for_deployment``), then the sub-maps
packed in the configuration's ``dtype`` with its ``mod_q`` and ``mod_p``
wraps (``pack_models_split``).  ``control`` is the reference's model of
each sub-map in bfloat16 (alpha solved in float64, then rounded), with
the loss rule its rollout applies.
"""

from __future__ import annotations

import torch

from gpbench import control as controls
from gpbench.rollouts_split import sub_maps


def call(config: dict, d: dict):
    from sympgpr_tpu_torch import AuxGP, SympGP, get_kernel
    from sympgpr_tpu_torch.ops.cuda_step import pack_models_split

    kern = get_kernel(config["kernel"])
    aux, jitter = config["aux"], config["deployment_jitter"]
    na = aux["points"]
    sgps, auxes = [], []
    for cfg, s in sub_maps(config, d):
        hyp = cfg["hyperparameters"]
        X = torch.stack([s["q"], s["P"]], 1)
        z = torch.cat([s["p"] - s["P"], s["Q"] - s["q"]])
        sgp = SympGP.create(kern, hyp["sympgp"][:2], hyp["sympgp"][2],
                            config["sig2n"], X, z)
        Xa = torch.stack([s["q"][:na], s["p"][:na]], 1)
        agp = AuxGP.create(kern, hyp["aux"][:2], hyp["aux"][2],
                           aux["sig2n"], Xa, (s["P"] - s["p"])[:na],
                           delta=True)
        if jitter is not None:
            sgp, agp = sgp.for_deployment(jitter), agp.for_deployment(jitter)
        sgps.append(sgp)
        auxes.append(agp)
    return pack_models_split(sgps, auxes, mod_q=config["mod_q"],
                             mod_p=config["mod_p"],
                             dtype=getattr(torch, config["dtype"]))


def control(config: dict, d: dict) -> list[dict]:
    return [controls.CONTROLS["deploy"](cfg, s)
            for cfg, s in sub_maps(config, d)]
