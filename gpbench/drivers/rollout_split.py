"""Traffic kind ``rollout_split``: the traffic of ``rollout_latency`` (one
client, requests of ``orbits`` x ``steps`` one after another, each ended
when its (Q, P) are on the host, ``check_rows`` rows of each kept for the
check) over a Split deployment: the configuration's ``sub_maps``
sub-maps packed together (``calls/deploy_split.py``), row t + 1 made by
sub-map t mod ``sub_maps``, the loss checked where the configuration's
``loss_at_new_q`` says (``calls/rollout_split.py``).

The check steps each sampled row t once by the reference's float64 model
of sub-map t mod ``sub_maps`` (Newton to convergence) and applies the
system's loss rule at the new (Q, P), after the wrap of Q, where the
configuration checks losses at the new q.  The traffic's orbits stay
far inside the loss boundary, so set-up adds a probe of the rule: one
launch of ``loss_probe.orbits`` x ``loss_probe.steps`` from initial
conditions drawn from the run's seed over ``loss_probe.box``, a band at
the boundary, whose every row the check holds to the same rule as the
traffic's.  The probe is not timed and not in the window.

End to end: ``rollout_p95_ms``, as ``rollout_latency``.  Counters: the
window's requests, and its change in the program's launch counts: the
rollout kernel's launches (``launches``) and those of its Split instance
(``launches_split``; left out where the program counts none).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpbench import harness, inputs, program, rollouts_split
from gpbench.reference import gp as ref_gp
from gpbench.reference import system
from gpbench.rollouts import EDGE, _gap

Latency = harness.driver_class("rollout_latency")


class Driver(Latency):
    calls = ("deploy_split", "rollout_split")

    def setup(self) -> None:
        # the set-up of RolloutBase deploys through ``program.deploy``: the
        # Split deployment (or what replaced it) in its place
        self.program.deploy = self.program.deploy_split
        super().setup()

    def prepare(self) -> None:
        super().prepare()
        probe = self.traffic["loss_probe"]
        q0, p0 = inputs.initial_conditions(self.config, self.seed, 1,
                                           probe["orbits"], probe["box"],
                                           self.device)
        self.probe_ics = (q0[0].to(torch.float32).contiguous(),
                          p0[0].to(torch.float32).contiguous())
        Q, P = self._call(*self.probe_ics, probe["steps"])
        self.probe = (Q.cpu().numpy(), P.cpu().numpy())

    def _call(self, q0: torch.Tensor, p0: torch.Tensor, nm: int):
        c = self.config
        return self.program.rollout_split(self.pm, q0, p0, nm,
                                          c["newton_iters"], c["loss_check"],
                                          c["loss_at_new_q"])

    def _launch(self, k: int):
        b = self.pool(k)
        with self.spans.span("rollout"):
            return self._call(self.q0[b], self.p0[b], self.nm)

    def window(self, seconds: float) -> None:
        before = program.launch_counts()
        super().window(seconds)
        after = program.launch_counts()
        self.launched = {k: after[k] - before[k] for k in after}

    def counters(self) -> dict:
        out = dict(super().counters(), launches=self.launched["rollout"])
        if "rollout_split" in self.launched:
            out["launches_split"] = self.launched["rollout_split"]
        return out

    # ------------------------------------------------------------------
    # the check

    def _rows(self):
        """The compared rows: (t, q_t, p_t, q_t+1, p_t+1, probe) arrays of
        the traffic's samples and of every row of the probe (``probe``
        True), and the largest gap of a row 0 from its initial
        condition."""
        ics = [(q.cpu().numpy(), p.cpu().numpy())
               for q, p in zip(self.q0, self.p0)]
        ic_err = 0.0
        parts = []
        for k, t, j, (q_t, p_t, q_n, p_n, q_0, p_0) in self.samples:
            ic_q, ic_p = ics[self.pool(k)]
            ic_err = max(ic_err, float(np.max(np.abs(q_0 - ic_q[j]))),
                         float(np.max(np.abs(p_0 - ic_p[j]))))
            t = np.asarray(t)
            parts.append((t, q_t, p_t, q_n, p_n, np.zeros(t.shape, bool)))
        Q, P = self.probe
        pq, pp = (x.cpu().numpy() for x in self.probe_ics)
        ic_err = max(ic_err, float(np.max(np.abs(Q[0] - pq))),
                     float(np.max(np.abs(P[0] - pp))))
        steps, B = Q.shape
        parts.append((np.repeat(np.arange(steps - 1), B), Q[:-1].ravel(),
                      P[:-1].ravel(), Q[1:].ravel(), P[1:].ravel(),
                      np.ones((steps - 1) * B, bool)))
        return [np.concatenate(c) for c in zip(*parts)], ic_err

    def check(self) -> list:
        """Compare every compared row with one reference step, by the
        sub-map that made it, from the row before it."""
        cfg, dev, f64 = self.config, self.device, torch.float64
        models = rollouts_split.reference_models(cfg, self.train)
        M = len(models)
        (t, q_t, p_t, q_n, p_n, probe), ic_err = self._rows()
        wraps = 0
        for key, pair in (("mod_q", (q_t[t > 0], q_n)),
                          ("mod_p", (p_t[t > 0], p_n))):
            if cfg[key] is None:
                continue
            top = float(np.float32(cfg[key]))  # row 0 is not wrapped
            for v in pair:
                fin = np.isfinite(v)
                wraps += int(np.sum(fin & ~((v >= 0) & (v <= top))))
        live = np.isfinite(q_t) & np.isfinite(p_t)
        # a row after a lost one stays lost
        bad_nan = int(np.sum(~live & (np.isfinite(q_n) | np.isfinite(p_n))))
        sys_ = system(cfg)
        errs, in_probe, newton, lost_ref = [], [], [], 0
        for m in range(M):
            sel = live & (t % M == m)
            q, p, Qn, Pn = (torch.as_tensor(v[sel], dtype=f64, device=dev)
                            for v in (q_t, p_t, q_n, p_n))
            Q, P, step = ref_gp.map_step(models[m], q, p)
            if not cfg["loss_check"]:
                gone = edge = torch.zeros_like(P, dtype=torch.bool)
            elif cfg["loss_at_new_q"]:
                Pw = P if cfg["mod_p"] is None else torch.remainder(
                    P, cfg["mod_p"])
                Qw = Q if cfg["mod_q"] is None else torch.remainder(
                    Q, cfg["mod_q"])
                gone = sys_.lost(cfg, Pw, Qw)
                edge = sys_.near_boundary(cfg, Pw, Qw, EDGE)
            else:
                gone = sys_.lost(cfg, P, q)
                edge = sys_.near_boundary(cfg, P, q, EDGE)
            prog_lost = torch.isnan(Pn) | torch.isnan(Qn)
            bad_nan += int(((gone != prog_lost) & ~edge).sum())
            lost_ref += int(gone.sum())
            ok = ~gone & ~prog_lost
            errs.append(torch.maximum(_gap(Qn[ok], Q[ok], cfg["mod_q"]),
                                      _gap(Pn[ok], P[ok], cfg["mod_p"])))
            in_probe.append(torch.as_tensor(probe[sel], device=dev)[ok])
            newton.append(step[ok].abs())
        err, newton = torch.cat(errs), torch.cat(newton)
        in_probe = torch.cat(in_probe)

        def largest(x):
            return float(x.max()) if x.numel() else math.nan

        step_err = largest(err)
        lim = self.traffic["limits"]
        Pp = self.probe[1]
        self.check_detail = dict(
            rows=int(live.sum()), lost_ref=lost_ref,
            probe_lost=int(np.isnan(Pp[-1]).sum()), probe_orbits=Pp.shape[1],
            step_err_traffic=largest(err[~in_probe]),
            step_err_probe=largest(err[in_probe]),
            newton_last_step=largest(newton))
        return [("ic_err", ic_err, lim["ic_err"]),
                ("step_err", step_err, lim["step_err"]),
                ("nan_mismatch", float(bad_nan), lim["nan_mismatch"]),
                ("wrap_viol", float(wraps), lim["wrap_viol"])]
