"""The Split tokamak, plain PyTorch, float64: the tokamak field
(``systems/tokamak.py``) cut into ``sub_maps`` maps of 1 / ``sub_maps``
of a turn each.  A configuration names it with ``"system":
"tokamak_split"``; its ``N``, ``sub_maps``, ``nph``, ``r_scale``,
``momentum_scale`` and ``field`` are read here.

Sub-map m maps the state of a field line at the toroidal angle
m 2 pi / sub_maps to its state at (m + 1) 2 pi / sub_maps, along one
integrated turn of ``nph`` midpoint steps (SympGPR
``python/05_tokamak/Split_SympGPR/calc_fieldlines.py``): the sub-maps
differ by the perturbation's phase, so they are not copies of one map.
The initial conditions and the loss rule are the tokamak's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpbench.reference.systems.tokamak import (  # noqa: F401
    Ath, halton, initial_conditions, lost, near_boundary, timestep)

Tensor = torch.Tensor


def pairs(cfg: dict, blocks: list[int], device) -> list[dict[str, Tensor]]:
    """The training pairs of each Halton block (points 1 + block N ...
    (block + 1) N of the 3-d sequence; block 0 is the published set):
    float64 (N, sub_maps) tensors q, p, Q, P, column m the pairs of
    sub-map m, with p = pth * ``momentum_scale``.  r = 0.1 + r_scale s0,
    th = 2 pi s1 at ph = 0; the blocks are integrated together."""
    N, M, nph = cfg["N"], cfg["sub_maps"], cfg["nph"]
    if nph % M:
        raise ValueError(f"nph {nph} is no multiple of {M} sub-maps")
    s = np.concatenate([halton(N, 3, 1 + b * N) for b in blocks])
    f64 = dict(dtype=torch.float64, device=device)
    r0 = torch.as_tensor(s[:, 0] * cfg["r_scale"] + 0.1, **f64)
    th0 = torch.as_tensor(s[:, 1] * 2.0 * np.pi, **f64)
    z = torch.stack([Ath(r0, th0), th0, torch.zeros_like(r0)], dim=-1)
    rl = r0
    dph = 2.0 * math.pi / nph
    sections = [z]
    for i in range(nph):
        z, rl = timestep(cfg["field"], dph, z, rl)
        if (i + 1) % (nph // M) == 0:
            sections.append(z)
    sec = torch.stack(sections, dim=1)  # (blocks N, M + 1, 3)
    scale = cfg["momentum_scale"]
    d = dict(q=sec[:, :M, 1], p=sec[:, :M, 0] * scale, Q=sec[:, 1:, 1],
             P=sec[:, 1:, 0] * scale)
    return [{k: v[i * N:(i + 1) * N] for k, v in d.items()}
            for i in range(len(blocks))]
