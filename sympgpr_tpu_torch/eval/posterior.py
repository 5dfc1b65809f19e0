"""Posterior-parity harness: the samplers held against a deterministic
quadrature of a 3-D GP hyperposterior (the port of the gates of the JAX
package's ``tests/test_posterior_parity.py``).

The target is the reduced pendulum workload's posterior (N = 18 training
pairs, sig2n 1e-8, PER_SE, log10 (lx, ly, sig)).  The truth is a 40^3
grid quadrature through ``likelihood.nll_batched`` with the boundary mass
asserted negligible.  Gates:

1. NUTS posterior moments: means within 3x the Monte-Carlo error, stds at
   rtol 0.3.
2. Adaptive HMC the same, stds at rtol 0.35.
3. Hyperparameter-marginalized predictive means and sigma bands at
   held-out points: NUTS draws against quadrature-weighted draws.
4. Coverage of the point fit's +-2 sigma band on held-out map targets
   >= 0.8, and the band informative.

``tests/test_torch_posterior_parity.py`` runs it on the CPU and
``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from sympgpr_tpu_torch.gp import hmc, nuts, predict
from sympgpr_tpu_torch.gp.model import SympGP
from sympgpr_tpu_torch.kernels import PER_SE

Tensor = torch.Tensor

SIG2N = 1e-8
N_TRAIN = 18
LO = np.array([1.0, 0.7, 0.5])
HI = np.array([2.4, 1.7, 4.5])
N_GRID = 40
CHUNK = 4096
X0 = np.array([0.0, 0.0, 0.7])
# sampler configurations
NUTS_RUN = dict(chains=4, n_samples=250, n_warmup=150, step_size=0.05,
                max_depth=6, seed=1, start_seed=0)
HMC_RUN = dict(chains=4, n_samples=600, n_warmup=300, step_size=0.02,
               n_leapfrog=16, seed=2, start_seed=3)
# gates
NUTS_STD_RTOL = 0.3
HMC_STD_RTOL = 0.35
NUTS_MIN_ACCEPT = 0.5
HMC_MIN_ACCEPT = 0.4
COVERAGE_MIN = 0.8


def pendulum_problem(device, X=None, z=None) -> dict:
    """Training data (the port's pendulum system unless X, z are given),
    the batched log-posterior and 30 held-out targets: an independent
    uniform draw (seed 7) through the same one-map-time RK4."""
    from sympgpr_tpu_torch.systems import pendulum as sys_pend

    cfg = sys_pend.PendulumConfig(N=N_TRAIN)
    if X is None:
        data = sys_pend.training_data(cfg, device)
        X, z = data["X"], data["z"]
    X = torch.as_tensor(X, dtype=torch.float64, device=device)
    z = torch.as_tensor(z, dtype=torch.float64, device=device)
    rng = np.random.default_rng(7)
    n2 = 30
    q2 = rng.uniform(cfg.qmin, cfg.qmax, n2)
    p2 = rng.uniform(cfg.pmin, cfg.pmax, n2)
    yf = sys_pend.integrate_rk4(
        torch.as_tensor(q2, device=device), torch.as_tensor(p2, device=device),
        cfg.dtsymp * cfg.Nm, 10 * cfg.Nm)
    Q2, P2 = yf[:, 0].cpu().numpy(), yf[:, 1].cpu().numpy()
    X_test = torch.as_tensor(np.stack([q2, P2], 1), device=device)
    z_test = torch.as_tensor(np.concatenate([p2 - P2, Q2 - q2]),
                             device=device)
    return dict(X=X, z=z, logprob=hmc.nll_logprob(PER_SE, X, z, SIG2N),
                X_test=X_test, z_test=z_test)


def grid() -> np.ndarray:
    axes = [np.linspace(LO[i], HI[i], N_GRID) for i in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def quadrature(logprob, device) -> dict:
    """The MC-free truth: weights, mean and std of the posterior on the
    grid, in chunks of ``CHUNK`` rows of ``nll_batched``."""
    G = grid()
    with torch.no_grad():
        lp = np.concatenate([
            logprob(torch.as_tensor(G[i:i + CHUNK], device=device))
            .cpu().numpy() for i in range(0, len(G), CHUNK)])
    w = np.exp(lp - lp.max())
    w /= w.sum()
    axes = [np.linspace(LO[i], HI[i], N_GRID) for i in range(3)]
    edge = np.zeros(len(G), bool)
    for i in range(3):
        edge |= (G[:, i] <= axes[i][1]) | (G[:, i] >= axes[i][-2])
    mean = (w[:, None] * G).sum(0)
    std = np.sqrt((w[:, None] * (G - mean) ** 2).sum(0))
    return dict(G=G, w=w, mean=mean, std=std, edge_mass=float(w[edge].sum()))


def _starts(chains: int, seed: int, device) -> Tensor:
    rng = np.random.default_rng(seed)
    return torch.as_tensor(X0[None] + 0.05 * rng.standard_normal((chains, 3)),
                           device=device)


def run_nuts(logprob, device) -> nuts.NUTSResult:
    c = NUTS_RUN
    return nuts.sample_nuts(
        logprob, _starts(c["chains"], c["start_seed"], device),
        c["n_samples"], n_warmup=c["n_warmup"], step_size=c["step_size"],
        max_depth=c["max_depth"], seed=c["seed"])


def run_hmc(logprob, device) -> hmc.HMCResult:
    c = HMC_RUN
    return hmc.sample_hmc(
        logprob, _starts(c["chains"], c["start_seed"], device),
        c["n_samples"], n_warmup=c["n_warmup"], step_size=c["step_size"],
        n_leapfrog=c["n_leapfrog"], seed=c["seed"], adapt_step_size=True)


def mc_err(s: np.ndarray) -> np.ndarray:
    """Conservative MC standard error: IID formula x 5 autocorrelation
    inflation."""
    return 5.0 * s.std(0) / np.sqrt(len(s))


def moment_check(s: np.ndarray, quad: dict, std_rtol: float) -> dict:
    """Gate 1/2: |mean - truth| <= 3 max(MC error, 1e-3) and std within
    ``std_rtol`` of the truth's."""
    tol = 3.0 * np.maximum(mc_err(s), 1e-3)
    mean_err = np.abs(s.mean(0) - quad["mean"])
    std_rel = np.abs(s.std(0) - quad["std"]) / quad["std"]
    return dict(mean=s.mean(0).tolist(), std=s.std(0).tolist(),
                mean_err=mean_err.tolist(), mean_tol=tol.tolist(),
                std_rel_err=std_rel.tolist(),
                ok=bool(np.all(mean_err <= tol) and np.all(std_rel <= std_rtol)))


def _marginal_bands(prob: dict, samples: np.ndarray, k: int = 40):
    V = prob["X_test"][:8]
    means, varis = [], []
    for th in samples[:k]:
        hyp = 10.0 ** th
        m = SympGP.create(PER_SE, hyp[:2], hyp[2], SIG2N, prob["X"],
                          prob["z"])
        mu, var = predict.predict_df(m, V)
        means.append(mu.cpu().numpy())
        varis.append(var.cpu().numpy())
    means, varis = np.stack(means), np.stack(varis)
    # law of total variance: E[var] + Var[mean]
    return means.mean(0), varis.mean(0) + means.var(0)


def bands_check(prob: dict, nuts_samples: np.ndarray, quad: dict) -> dict:
    """Gate 3: marginalized predictive mean within 0.05 std(z) and sigma
    bands within 0.1 std(z) + 0.5 relative, NUTS against quadrature-weighted
    draws (40 each)."""
    thin = nuts_samples[:: max(1, len(nuts_samples) // 40)]
    rng = np.random.default_rng(11)
    quad_draws = quad["G"][rng.choice(len(quad["G"]), size=40, p=quad["w"])]
    mu_n, var_n = _marginal_bands(prob, thin)
    mu_q, var_q = _marginal_bands(prob, quad_draws)
    scale = float(prob["z"].std(correction=0))
    mean_err = float(np.max(np.abs(mu_n - mu_q)))
    sd_err = np.abs(np.sqrt(var_n) - np.sqrt(var_q))
    sd_ok = bool(np.all(sd_err <= 0.1 * scale + 0.5 * np.sqrt(var_q)))
    return dict(mean_err=mean_err, mean_tol=0.05 * scale,
                sd_err=float(sd_err.max()),
                ok=bool(mean_err <= 0.05 * scale and sd_ok))


def coverage_check(prob: dict) -> dict:
    """Gate 4: the point fit's +-2 sigma band (fixed sig = 2 max|z|^2,
    L-BFGS over log10 lengthscales) covers >= 0.8 of the held-out map
    targets, with a median sigma under half the targets' spread."""
    from sympgpr_tpu_torch.gp.train import fit_sympgp

    X, z = prob["X"], prob["z"]
    sig = 2.0 * float(torch.max(torch.abs(z)) ** 2)
    sgp, _ = fit_sympgp(PER_SE, X, z, sig2n=SIG2N, x0=(-1.0, -1.0),
                        fixed_sig=sig, bounds=((-10, 1), (-10, 1)))
    mu, var = predict.predict_df(sgp, prob["X_test"])
    z_test = prob["z_test"].cpu().numpy()
    resid = mu.cpu().numpy().T.reshape(-1) - z_test
    sd = np.sqrt(var.cpu().numpy().T.reshape(-1) + SIG2N)
    cover = float(np.mean(np.abs(resid) <= 2.0 * sd))
    informative = float(np.median(sd)) < 0.5 * float(np.std(z_test))
    return dict(coverage=cover, median_sd=float(np.median(sd)),
                ok=bool(cover >= COVERAGE_MIN and informative))
