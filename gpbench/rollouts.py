"""What the two rollout drivers share: the deployment made in set-up from
the configuration's recorded hyperparameters, the pools of initial
conditions, the sample of rows taken from every request's trajectories,
and the comparison of those rows with the reference map.

The check is one step from each sampled row: for a row t of orbit j the
reference solves the map in float64 from the program's (q_t, p_t) with
its own alpha (solved from the same training pairs at the same noise,
with the configuration's kernel), its Newton run to convergence, and
compares with row t + 1; row 0 must be the initial condition itself;
where the configuration checks losses, the system's loss rule at the old
q (NaN from then on) is held row by row, and so are the wraps of Q into
[0, mod_q] and P into [0, mod_p] where the configuration has them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpbench import inputs
from gpbench.driver import Base, sync
from gpbench.reference import gp as ref_gp
from gpbench.reference import system

# rows whose reference lies this close to the loss boundary may be
# decided either way by the float32 program
EDGE = 1e-4


def reference_model(config: dict, train: dict, dtype=torch.float64) -> dict:
    """The map's model worked out by the reference from the training pairs
    and the configuration's kernel and hyperparameters, in ``dtype``:
    alpha of the symplectic and the aux GP solved at the deployment
    noise, with the configuration's wraps."""
    kern = ref_gp.kernel(config["kernel"])
    d = {k: v.to(dtype) for k, v in train.items()}
    hyp, aux = config["hyperparameters"], config["aux"]
    lx, ly, sig = hyp["sympgp"]
    X = torch.stack([d["q"], d["P"]], 1)
    z = torch.cat([d["p"] - d["P"], d["Q"] - d["q"]])
    K = ref_gp.cov(kern, X, X, lx, ly, sig)
    na = aux["points"]
    alx, aly, asig = hyp["aux"]
    Xa = torch.stack([d["q"][:na], d["p"][:na]], 1)
    Ka = kern.cov_reg(Xa, Xa, alx, aly, asig)
    za = (d["P"] - d["p"])[:na]
    jit = config["deployment_jitter"]
    s2n = ref_gp.deploy_jitter(K, jit) if jit is not None else config["sig2n"]
    s2a = (ref_gp.deploy_jitter(Ka, jit) if jit is not None
           else aux["sig2n"])
    return dict(kern=kern, X=X, alpha=ref_gp.solve(K, s2n, z), lx=lx, ly=ly,
                sig=sig, Xa=Xa, alpha_a=ref_gp.solve(Ka, s2a, za), alx=alx,
                aly=aly, asig=asig, mod_q=config["mod_q"],
                mod_p=config["mod_p"])


def reference_lost(config: dict):
    """The system's loss rule ``lost(P, q)`` where the configuration checks
    losses, else None."""
    if not config["loss_check"]:
        return None
    sys_ = system(config)
    return lambda P, q: sys_.lost(config, P, q)


class RolloutBase(Base):
    libraries = ("rollout_step",)
    calls = ("deploy", "rollout")

    def setup(self) -> None:
        self.build()
        t = self.traffic
        with self.phase("inputs"):
            (self.train,) = inputs.training_sets(self.config, [0],
                                                 self.device)
            # pools from the traffic's own seed where it fixes them: then
            # every run's seed orders the same work differently
            q0, p0 = inputs.initial_conditions(
                self.config, t.get("ic_seed", self.seed), t["ic_batches"],
                t["orbits"], t["ic_box"], self.device)
            self.order = self.rng.permutation(t["ic_batches"]).tolist()
            self.q0 = [q.to(torch.float32).contiguous() for q in q0]
            self.p0 = [p.to(torch.float32).contiguous() for p in p0]
        with self.phase("deploy"):
            self.pm = self.program.deploy(self.config, self.train)
        self.nm = t["steps"]
        self.samples: list[tuple[int, np.ndarray, np.ndarray, tuple]] = []
        self.requests = 0
        with self.phase("prepare"):
            self.prepare()
        with self.phase("warm_up"):
            # one launch of the cell's shape, as every request makes
            Q, P = self._launch(0)
            del Q, P

    def prepare(self) -> None:
        """What a traffic kind makes ready before its window."""

    def pool(self, k: int) -> int:
        """The pool of initial conditions of request k."""
        return self.order[k % len(self.order)]

    def _launch(self, k: int):
        b = self.pool(k)
        with self.spans.span("rollout"):
            return self.program.rollout(
                self.pm, self.q0[b], self.p0[b], self.nm,
                self.config["newton_iters"], self.config["loss_check"])

    def _sample_indices(self, count: int, rows: int, B: int):
        """``rows`` (t, j) for each of ``count`` requests, t in [0, nm - 2],
        drawn from the seed: two (count, rows) arrays."""
        g = np.random.default_rng([self.seed, 1])
        return (g.integers(0, self.nm - 1, (count, rows)),
                g.integers(0, B, (count, rows)))

    def release(self) -> None:
        del self.pm
        sync(self.device)

    def counters(self) -> dict:
        return {"requests": self.requests}

    # ------------------------------------------------------------------
    # the check

    def check(self) -> list:
        """Compare every sampled row with one reference step from the row
        before it."""
        cfg, dev, f64 = self.config, self.device, torch.float64
        model = reference_model(cfg, self.train)
        wraps_at = {k: float(np.float32(cfg[k])) for k in ("mod_q", "mod_p")
                    if cfg[k] is not None}
        ic_err, bad_nan, wraps = 0.0, 0, 0
        rows = {"q": [], "p": [], "Q": [], "P": []}
        ics = [(q.cpu().numpy(), p.cpu().numpy())
               for q, p in zip(self.q0, self.p0)]
        for k, t, j, (q_t, p_t, q_n, p_n, q_0, p_0) in self.samples:
            ic_q, ic_p = ics[self.pool(k)]
            ic_err = max(ic_err, float(np.max(np.abs(q_0 - ic_q[j]))),
                         float(np.max(np.abs(p_0 - ic_p[j]))))
            later = np.asarray(t) > 0  # row 0 is the initial condition
            for key, pair in (("mod_q", (q_t[later], q_n)),
                              ("mod_p", (p_t[later], p_n))):
                top = wraps_at.get(key)
                for v in pair if top is not None else ():
                    fin = np.isfinite(v)
                    wraps += int(np.sum(fin & ~((v >= 0) & (v <= top))))
            live = np.isfinite(q_t) & np.isfinite(p_t)
            # a row after a lost one stays lost
            bad_nan += int(np.sum(~live & (np.isfinite(q_n)
                                           | np.isfinite(p_n))))
            for key, v in zip("qpQP", (q_t, p_t, q_n, p_n)):
                rows[key].append(v[live])
        q, p, Qn, Pn = (torch.as_tensor(np.concatenate(rows[c]), dtype=f64,
                                        device=dev) for c in "qpQP")
        Q, P, step = ref_gp.map_step(model, q, p)
        if cfg["loss_check"]:
            sys_ = system(cfg)
            gone = sys_.lost(cfg, P, q)
            edge = sys_.near_boundary(cfg, P, q, EDGE)
        else:
            gone = edge = torch.zeros_like(P, dtype=torch.bool)
        prog_lost = torch.isnan(Pn) | torch.isnan(Qn)
        bad_nan += int(((gone != prog_lost) & ~edge).sum())
        ok = ~gone & ~prog_lost
        err = torch.maximum(_gap(Qn[ok], Q[ok], cfg["mod_q"]),
                            _gap(Pn[ok], P[ok], cfg["mod_p"]))
        step_err = float(err.max()) if err.numel() else math.nan
        newton = float(step[ok].abs().max()) if err.numel() else math.nan
        lim = self.traffic["limits"]
        self.check_detail = dict(rows=int(q.numel()), lost_ref=int(gone.sum()),
                                 newton_last_step=newton)
        return [("ic_err", ic_err, lim["ic_err"]),
                ("step_err", step_err, lim["step_err"]),
                ("nan_mismatch", float(bad_nan), lim["nan_mismatch"]),
                ("wrap_viol", float(wraps), lim["wrap_viol"])]


def _gap(a: torch.Tensor, b: torch.Tensor, period: float | None):
    """|a - b|, across the wrap where the coordinate has a period."""
    if period is None:
        return (a - b).abs()
    return (torch.remainder(a - b + period / 2, period) - period / 2).abs()
