"""Traffic kind ``fit_large``: whole large-N fits (Adam on the device over
the closed-form NLL, then alpha at the trained hyperparameters), issued
back to back on one training set of the configuration's N pairs: the
block of the system's training points that the seed picks (seed 0: the
published set).

End to end: ``fit_step_ms``, the span from the window's start to the end
of the last whole fit completed in it over ``steps`` x the number of
those fits (a jitter escalation's refit adds to the span, not the count).

Check: the reference runs the same Adam in float64 with the
configuration's kernel from the same inputs (the program's X and z in the
configuration's ``dtype``) and solves alpha in float64 at each
answer's hyperparameters; every fit of the window is compared.
"""

from __future__ import annotations

import numpy as np
import torch

from gpbench import inputs, program
from gpbench.harness import worst
from gpbench.driver import Base, now, sync
from gpbench.reference import gp as ref_gp

BLOCKS = 1 << 16  # training blocks a seed picks from


class Driver(Base):
    libraries = ("cov_blocks", "tri_matmul")
    calls = ("fit_large",)

    def setup(self) -> None:
        self.build()
        self.block = self.seed % BLOCKS
        with self.phase("inputs"):
            (d,) = inputs.training_sets(self.config, [self.block],
                                        self.device, cache=False)
            dt = getattr(torch, self.config["dtype"])
            self.X = torch.stack([d["q"], d["P"]], 1).to(dt).contiguous()
            self.z = torch.cat([d["p"] - d["P"], d["Q"] - d["q"]]).to(dt)
        self.answers: list[dict] = []
        with self.phase("warm_up"):
            self.program.fit_large(self.config, self.X, self.z)  # one fit

    def window(self, seconds: float) -> None:
        self.ends = []
        c0 = program.launch_counts()
        t0 = now()
        self.t_start, self.deadline = t0, t0 + seconds
        with self.spans.span("window"):
            while now() < self.deadline:
                with self.spans.span("fit"):
                    a = self.program.fit_large(self.config, self.X, self.z)
                self.ends.append(now())
                self.answers.append(a)
        c1 = program.launch_counts()
        self.launches = {k: c1[k] - c0[k] for k in c1}

    def _done(self) -> list[float]:
        """Ends of the fits completed in the window (the first fit, where
        none was: a window shorter than one fit)."""
        return [e for e in self.ends if e <= self.deadline] or self.ends[:1]

    def end_to_end(self) -> dict:
        done = self._done()
        steps = self.config["fit"]["steps"] * len(done)
        return {"fit_step_ms": 1e3 * (done[-1] - self.t_start) / steps}

    def counters(self) -> dict:
        return {"fits": len(self.ends), "fits_in_window": len(self._done()),
                "launches": self.launches,
                "escalations": sum(a["escalations"] for a in self.answers)}

    def release(self) -> None:
        for a in self.answers:
            a["theta"] = a["theta"].double().cpu()
            a["hist"] = np.asarray(a["hist"], np.float64)
            a["alpha"] = a["alpha"].double()
        sync(self.device)

    def check(self) -> list:
        f = self.config["fit"]
        kern = ref_gp.kernel(self.config["kernel"])
        X, z = self.X.double(), self.z.double()
        theta, hist = ref_gp.adam(kern, X, z, f["theta0"],
                                  self.config["sig2n"], f["steps"], f["lr"])
        theta, hist = theta.cpu(), hist.cpu().numpy()
        gaps = dict(theta_gap=0.0, nll_gap=0.0, alpha_gap=0.0, mse_gap=0.0)
        solved = {}
        for a in self.answers:
            gaps["theta_gap"] = worst(gaps["theta_gap"], float(
                (a["theta"] - theta).abs().max()))
            gaps["nll_gap"] = worst(gaps["nll_gap"], float(np.max(
                np.abs(a["hist"] - hist) / np.maximum(1.0, np.abs(hist)))))
            key = (a["theta"].numpy().tobytes(), a["sig2n"])
            if key not in solved:
                lx, ly, sig = (10.0 ** a["theta"]).tolist()
                K = ref_gp.cov(kern, X, X, lx, ly, sig)
                solved[key] = (ref_gp.solve(K, a["sig2n"], z), K)
            alpha, K = solved[key]
            gaps["alpha_gap"] = worst(gaps["alpha_gap"], float(
                (a["alpha"] - alpha).abs().max() / alpha.abs().max()))
            mse = float(torch.mean((K @ a["alpha"] - z) ** 2))
            gaps["mse_gap"] = worst(gaps["mse_gap"],
                                  abs(a["train_mse"] - mse) / mse)
        lim = self.traffic["limits"]
        return [(k, v, lim[k]) for k, v in gaps.items()]
