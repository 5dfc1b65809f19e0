"""Poincare portraits, energy-drift plots and cost landscapes (matplotlib,
headless; PyTorch port of ``sympgpr_tpu/plotting.py``).

``portrait`` and ``energy_drift`` take numpy-convertible arrays (CPU
tensors too; move CUDA tensors to the host first).  ``cost_landscape``
takes a batched torch objective.
"""

from __future__ import annotations

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def portrait(
    qmap, pmap, q_ref=None, p_ref=None, path="portrait.png",
    xlabel="$q$", ylabel="$p$", title=None,
):
    """Three-panel phase portrait: GP map / reference / overlay."""
    plt = _plt()
    qmap, pmap = np.asarray(qmap), np.asarray(pmap)
    fig, axes = plt.subplots(1, 3 if q_ref is not None else 1,
                             figsize=(10, 3), squeeze=False)
    axes = axes[0]
    axes[0].plot(qmap, pmap, "k^", markersize=0.5)
    axes[0].set_xlabel(xlabel)
    axes[0].set_ylabel(ylabel)
    if q_ref is not None:
        axes[1].plot(np.asarray(q_ref), np.asarray(p_ref), ".",
                     color="dodgerblue", markersize=0.5)
        axes[1].set_xlabel(xlabel)
        axes[2].plot(np.asarray(q_ref), np.asarray(p_ref), ".",
                     color="dodgerblue", markersize=0.5)
        axes[2].plot(qmap, pmap, "k^", markersize=0.5)
        axes[2].set_xlabel(xlabel)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def energy_drift(H, path="energy.png", title="Energy drift"):
    """Semilog |H(t) - H(0)| / H(0) (``main.py:218-222``)."""
    plt = _plt()
    H = np.asarray(H)
    fig, ax = plt.subplots(figsize=(5, 3))
    drift = np.abs(H - H[0]) / np.abs(H[0])
    ax.semilogy(np.maximum(drift, 1e-18))
    ax.set_xlabel("n")
    ax.set_ylabel(r"$|H(t)-H(0)|/H(0)$")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def cost_landscape(objective, bounds, path="cost.png", n=40, title="NLL",
                   *, dtype: torch.dtype = torch.float64,
                   device: torch.device | str = "cuda"):
    """Contour of a 2-D objective + finite-difference-vs-autograd gradient
    check, mirroring the reference's ``plot_cost_function(_jac)`` visual
    diagnostics (``python/05_tokamak/SympGPR/plotting.py:9-63``).

    ``objective`` maps an (M, 2) tensor of points to (M,) values; the
    n x n grid is evaluated in one call (the JAX package vmaps a scalar
    objective), the gradient at the midpoint comes from autograd and the
    central finite difference at step 1e-5 from four evaluations, all on
    ``device``.  Returns (path, grad_autograd, grad_fd) as numpy arrays.
    """
    plt = _plt()
    (x0, x1), (y0, y1) = bounds
    xs = np.linspace(x0, x1, n)
    ys = np.linspace(y0, y1, n)
    XX, YY = np.meshgrid(xs, ys)
    pts = torch.as_tensor(np.stack([XX.ravel(), YY.ravel()], 1), dtype=dtype,
                          device=device)
    with torch.no_grad():
        Z = objective(pts).cpu().numpy().reshape(n, n)
    Z = np.where(np.isfinite(Z), Z, np.nan)

    mid = torch.tensor([[0.5 * (x0 + x1), 0.5 * (y0 + y1)]], dtype=dtype,
                       device=device, requires_grad=True)
    (g,) = torch.autograd.grad(objective(mid).sum(), mid)
    g_ad = g[0].cpu().numpy()
    eps = 1e-5
    steps = torch.tensor([[eps, 0.0], [-eps, 0.0], [0.0, eps], [0.0, -eps]],
                         dtype=dtype, device=device)
    with torch.no_grad():
        f = objective(mid.detach() + steps).cpu().numpy()
    g_fd = np.array([(f[0] - f[1]) / (2 * eps), (f[2] - f[3]) / (2 * eps)])

    fig, ax = plt.subplots(figsize=(5, 4))
    c = ax.contourf(XX, YY, Z, levels=30)
    fig.colorbar(c, ax=ax)
    ax.set_title(
        f"{title}  |grad_ad - grad_fd| = {np.abs(g_ad - g_fd).max():.1e}"
    )
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path, g_ad, g_fd
