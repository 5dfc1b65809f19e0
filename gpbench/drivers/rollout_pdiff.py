"""Traffic kind ``rollout_pdiff``: the traffic of ``rollout_batch``
(launches of ``orbits`` x ``steps`` back to back, ``in_flight`` queued at
once, each from the next of ``ic_batches`` pools drawn from the seed, the
trajectories left on the card) with the unwrapped momentum D tracked
beside (Q, P) (``calls/rollout_pdiff.py``, the configuration's
``track_pdiff``).  Every launch leaves a sample of ``check_rows`` of its
rows, D's beside Q's and P's, for the check.

The check is ``RolloutBase.check`` (one reference step from each sampled
row, Q and P compared across their wraps, the wraps themselves) and adds
``pdiff_err``: for each sampled row t, D_{t+1} - D_t against the
reference's unwrapped P from (q_t, p_t) less p_t.  D's row 0 must be p0
exactly, which ``ic_err`` holds with Q's and P's row 0.

End to end: ``orbit_steps_per_s``, as ``rollout_batch``.  Counters: the
window's requests, and its change in the program's count of launches in
the mod_p / pdiff mode (``launches_wrap``, the ``rollout_wrap`` count;
left out where the program counts none).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpbench import harness, program
from gpbench.reference import gp as ref_gp
from gpbench.rollouts import reference_model

Batch = harness.driver_class("rollout_batch")


class Driver(Batch):
    calls = ("deploy", "rollout_pdiff")

    def _launch(self, k: int):
        b, c = self.pool(k), self.config
        with self.spans.span("rollout"):
            Q, P, D = self.program.rollout_pdiff(
                self.pm, self.q0[b], self.p0[b], self.nm, c["newton_iters"],
                c["loss_check"], c["track_pdiff"])
        # rows t, t + 1 and 0 of D, as the batch driver gathers Q's and P's
        self.d_gathered.append(D.view(-1)[self.flat[k]])
        return Q, P

    def prepare(self) -> None:
        super().prepare()
        self.d_gathered: list[torch.Tensor] = []

    def window(self, seconds: float) -> None:
        self.d_gathered = []  # not the warm-up's
        before = program.launch_counts()
        super().window(seconds)
        after = program.launch_counts()
        self.launched = {k: after[k] - before[k] for k in after}
        self.d_samples = [g.cpu().numpy().reshape(3, -1)
                          for g in self.d_gathered]

    def counters(self) -> dict:
        out = super().counters()
        if "rollout_wrap" in self.launched:
            out["launches_wrap"] = self.launched["rollout_wrap"]
        return out

    # ------------------------------------------------------------------
    # the check

    def check(self) -> list:
        checks = super().check()
        cfg, dev, f64 = self.config, self.device, torch.float64
        ics = [p.cpu().numpy() for p in self.p0]
        d0_err = 0.0
        rows = {"q": [], "p": [], "dD": []}
        for (k, t, j, (q_t, p_t, *_)), (d_t, d_n, d_0) in zip(
                self.samples, self.d_samples):
            d0_err = harness.worst(
                d0_err, np.max(np.abs(d_0 - ics[self.pool(k)][j])))
            live = np.isfinite(q_t) & np.isfinite(p_t)
            rows["q"].append(q_t[live])
            rows["p"].append(p_t[live])
            rows["dD"].append(d_n[live].astype(np.float64)
                              - d_t[live].astype(np.float64))
        q, p, dD = (torch.as_tensor(np.concatenate(rows[c]), dtype=f64,
                                    device=dev) for c in ("q", "p", "dD"))
        _, P, _ = ref_gp.map_step(reference_model(cfg, self.train), q, p)
        err = (dD - (P - p)).abs()  # a NaN in D stays NaN
        pdiff_err = float(err.max()) if err.numel() else math.nan
        lim = self.traffic["limits"]
        name, ic_err, ic_lim = checks[0]
        checks[0] = (name, harness.worst(ic_err, d0_err), ic_lim)
        self.check_detail = dict(self.check_detail, d0_err=d0_err)
        return checks + [("pdiff_err", pdiff_err, lim["pdiff_err"])]
