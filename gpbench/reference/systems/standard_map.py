"""The Chirikov standard map, plain PyTorch, float64: the exact map that
makes the training pairs, the initial conditions of its orbits, and its
loss rule (none: no orbit is ever lost).  A configuration names it with
``"system": "standard_map"``; its ``N`` and ``k`` are read here.

  P = p + k sin(q),  Q = q + P

on the torus [0, 2 pi)^2 (SympGPR ``python/04_standard_map``, ``main.py``
and ``func.py``): one exact application from Halton points of the 2-d
sequence scaled to [0, 2 pi)^2 gives each training pair, unwrapped, as
the program's ``systems/standard_map.py::training_data`` makes them.
"""

from __future__ import annotations

import numpy as np
import torch

from gpbench.reference.systems.tokamak import halton

Tensor = torch.Tensor


def pairs(cfg: dict, blocks: list[int], device) -> list[dict[str, Tensor]]:
    """The training pairs of each Halton block (points 1 + block N ...
    (block + 1) N of the 2-d sequence; block 0 is the published set),
    (q, p) = 2 pi times the points, mapped once: float64 (N,) tensors q,
    p, Q, P."""
    N = cfg["N"]
    pts = np.concatenate([halton(N, 2, 1 + b * N) for b in blocks])
    x = torch.as_tensor(pts * 2.0 * np.pi, dtype=torch.float64,
                        device=device)
    q, p = x[:, 0], x[:, 1]
    P = p + cfg["k"] * torch.sin(q)
    Q = q + P
    d = dict(q=q, p=p, Q=Q, P=P)
    return [{k: v[i * N:(i + 1) * N] for k, v in d.items()}
            for i in range(len(blocks))]


def initial_conditions(cfg: dict, box, u: Tensor):
    """Initial conditions (q0, p0) from uniform draws ``u`` (2, ...) in
    [0, 1): q and p uniform over the ``box`` [[q_lo, q_hi], [p_lo,
    p_hi]]."""
    (q_lo, q_hi), (p_lo, p_hi) = box
    return q_lo + (q_hi - q_lo) * u[0], p_lo + (p_hi - p_lo) * u[1]


def lost(cfg: dict, P: Tensor, q: Tensor) -> Tensor:
    """No orbit of the map on the torus is lost."""
    return torch.zeros_like(P, dtype=torch.bool)


def near_boundary(cfg: dict, P: Tensor, q: Tensor, tol: float) -> Tensor:
    """No row lies near a loss boundary: there is none."""
    return torch.zeros_like(P, dtype=torch.bool)
