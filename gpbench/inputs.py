"""The inputs every cell hands to the program and to the reference alike:
training pairs made by the configuration's system
(``gpbench/reference/systems/<system>.py``), and initial conditions drawn
from the seed.

Training pairs of a configuration and block are kept in
``gpbench/.cache/`` inside the checkout (a fixed path, listed in
``.gitignore``), so a run that needs a set made before finds it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from gpbench.reference import system

CACHE = Path(__file__).resolve().parent / ".cache"
FIELDS = ("q", "p", "Q", "P")


def _path(config: dict, block: int) -> Path:
    return CACHE / f"{config['name']}-N{config['N']}-block{block}.npy"


def training_sets(config: dict, blocks: list[int], device,
                  cache: bool = True) -> list[dict[str, torch.Tensor]]:
    """float64 (N,) tensors q, p, Q, P of each of the system's training
    blocks (block 0 is the published set).  The blocks not cached are made
    together, in one batch."""
    todo = [b for b in blocks if not (cache and _path(config, b).exists())]
    fresh = {}
    if todo:
        for b, d in zip(todo, system(config).pairs(config, todo, device)):
            arr = torch.stack([d[x] for x in FIELDS])
            fresh[b] = arr
            if cache:
                CACHE.mkdir(exist_ok=True)
                tmp = _path(config, b).with_suffix(f".{os.getpid()}.npy")
                np.save(tmp, arr.cpu().numpy())
                tmp.replace(_path(config, b))
    out = []
    for b in blocks:
        arr = fresh.get(b)
        if arr is None:
            arr = torch.as_tensor(np.load(_path(config, b)), device=device)
        out.append(dict(zip(FIELDS, arr.unbind())))
    return out


def initial_conditions(config: dict, seed: int, batches: int, orbits: int,
                       box, device):
    """``batches`` pools of ``orbits`` initial conditions (q0, p0), float64
    (batches, orbits) on ``device``: uniform draws over the traffic's
    ``box`` from a generator on the device seeded with ``seed``, mapped to
    the phase space by the configuration's system."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    u = torch.rand((2, batches, orbits), generator=g, dtype=torch.float64,
                   device=device)
    return system(config).initial_conditions(config, box, u)
