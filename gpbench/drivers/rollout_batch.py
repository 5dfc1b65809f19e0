"""Traffic kind ``rollout_batch``: launches of ``orbits`` x ``steps``
through the fused rollout, issued back to back with ``in_flight`` queued
at once; each takes the next of ``ic_batches`` pools of initial
conditions drawn from the seed, and its trajectories stay on the card.
Every launch leaves a sample of ``check_rows`` of its rows, drawn from
the seed, for the check (one gather on the card).

End to end: ``orbit_steps_per_s``, (steps - 1) x orbits of every launch
completed in the window over the span from the window's start to the
last such completion.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from gpbench.driver import Done, now
from gpbench.rollouts import RolloutBase


class Driver(RolloutBase):

    def prepare(self) -> None:
        B, rows = self.traffic["orbits"], self.traffic["check_rows"]
        t, j = self._sample_indices(self.traffic["max_launches"], rows, B)
        self.picks = list(zip(t, j))
        flat = np.concatenate([t * B + j, (t + 1) * B + j, j], axis=1)
        self.flat = torch.as_tensor(flat, device=self.device)

    def window(self, seconds: float) -> None:
        gathered = []
        flight: collections.deque = collections.deque()
        self.completions = []
        t0 = now()
        self.t_start, self.deadline = t0, t0 + seconds
        k = 0
        with self.spans.span("window"):
            while now() < self.deadline and k < len(self.picks):
                Q, P = self._launch(k)
                gathered.append(torch.stack([Q.view(-1)[self.flat[k]],
                                             P.view(-1)[self.flat[k]]]))
                flight.append(Done(self.device))
                del Q, P
                k += 1
                if len(flight) >= self.traffic["in_flight"]:
                    self.completions.append(flight.popleft().wait())
            while flight:
                self.completions.append(flight.popleft().wait())
        self.requests = k
        for kk, g in enumerate(gathered):
            t, j = self.picks[kk]
            q, p = g.cpu().numpy().reshape(2, 3, -1)
            self.samples.append((kk, t, j, (q[0], p[0], q[1], p[1], q[2],
                                            p[2])))

    def end_to_end(self) -> dict:
        done = ([c for c in self.completions if c <= self.deadline]
                or self.completions[:1])
        span = done[-1] - self.t_start
        work = (self.nm - 1) * self.traffic["orbits"] * len(done)
        return {"orbit_steps_per_s": work / span}
