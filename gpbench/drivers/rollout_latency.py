"""Traffic kind ``rollout_latency``: one client sends requests one after
another, each a launch of ``orbits`` x ``steps`` through the fused
rollout from the next of ``ic_batches`` pools of initial conditions drawn
from the seed; a request ends when its (Q, P) are on the host.  Every
request leaves a sample of ``check_rows`` of its rows, drawn from the
seed, for the check.

End to end: ``rollout_p95_ms``, the 95th percentile of every request
issued in the window, each timed from its issue until its trajectories
are on the host.
"""

from __future__ import annotations

import numpy as np

from gpbench.driver import now
from gpbench.rollouts import RolloutBase


class Driver(RolloutBase):

    def prepare(self) -> None:
        B, rows = self.traffic["orbits"], self.traffic["check_rows"]
        t, j = self._sample_indices(self.traffic["max_requests"], rows, B)
        self.picks = list(zip(t, j))

    def window(self, seconds: float) -> None:
        self.latencies = []
        t0 = now()
        self.t_start, self.deadline = t0, t0 + seconds
        k = 0
        with self.spans.span("window"):
            while now() < self.deadline and k < len(self.picks):
                a = now()
                with self.spans.span("request"):
                    Q, P = self._launch(k)
                    Qh, Ph = Q.cpu().numpy(), P.cpu().numpy()
                self.latencies.append(now() - a)
                t, j = self.picks[k]
                self.samples.append((k, t, j, (
                    Qh[t, j], Ph[t, j], Qh[t + 1, j], Ph[t + 1, j],
                    Qh[0, j], Ph[0, j])))
                k += 1
        self.requests = k

    def end_to_end(self) -> dict:
        return {"rollout_p95_ms":
                1e3 * float(np.percentile(self.latencies, 95))}
