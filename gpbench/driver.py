"""What every traffic kind's driver shares: the cell, the seed, the
device, the spans, the window's clock and the program it drives.

A driver (``gpbench/drivers/<kind>.py``, class ``Driver``) makes its
inputs from the seed and warms the program up in ``setup``, issues
requests for ``seconds`` in ``window``, reports its end-to-end metrics and
counters, and after ``release`` compares what the window produced with
the reference in ``check``.  It names the calls into the program that it
makes in ``calls`` (``gpbench.program.call``) and makes them through
``self.program`` only, where a control or a planted fault replaces them.
"""

from __future__ import annotations

import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from gpbench import program
from gpbench.harness import Cell, Spans


def now() -> float:
    return time.perf_counter()


class Done:
    """Completion of work queued on the device: a CUDA event, or nothing
    to wait for on the CPU (whose calls return when done)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> float:
        if self.event is not None:
            self.event.synchronize()
        return now()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Base:
    """A driver's state; ``sizes`` overrides traffic and configuration
    numbers (the tests' small runs on the CPU)."""

    libraries: tuple[str, ...] = ()  # the program's kernels it launches
    calls: tuple[str, ...] = ()      # the calls into the program it makes

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 spans: Spans | None = None, sizes: dict | None = None):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.spans = spans or Spans()
        self.config = dict(cell.config, name=cell.entry["config"],
                           **(sizes or {}).get("config", {}))
        self.traffic = dict(cell.traffic, **(sizes or {}).get("traffic", {}))
        self.rng = np.random.default_rng(self.seed)
        self.program = SimpleNamespace(**{k: program.call(k)
                                          for k in self.calls})
        self.build_s: dict[str, float] = {}
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Seconds of a part of set-up (synchronised at its end)."""
        t0 = now()
        yield
        sync(self.device)
        self.phases[name] = now() - t0

    def build(self) -> None:
        if self.device.type == "cuda":
            with self.phase("build"):
                self.build_s = program.build(list(self.libraries))

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
