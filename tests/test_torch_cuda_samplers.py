"""The slice's float64 paths on the card: ``nll_batched`` against the same
rows on CPU tensors (a failed row's fallback and NaN pattern included),
the host reads of one HMC transition, and Adam loops that never make the
host wait.  Needs a CUDA device; skips otherwise.  Needs no JAX:
  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_samplers.py
"""

import pytest

pytest.importorskip("torch")

import warnings  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy, toy_data  # noqa: E402

from sympgpr_tpu_torch.gp import hmc, likelihood, train  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as kv  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _vg(params, sig, X, z, device, sig2n=1e-3):
    p = torch.tensor(params, dtype=torch.float64, device=device,
                     requires_grad=True)
    s = torch.tensor(sig, dtype=torch.float64, device=device,
                     requires_grad=True)
    v = likelihood.nll_batched(kv.PER_SE, p, s, sig2n,
                               torch.tensor(X, device=device),
                               torch.tensor(z, device=device))
    gp, gs = torch.autograd.grad(v.sum(), (p, s))
    return npy(v), npy(gp), npy(gs)


def test_nll_batched_on_card_matches_cpu_with_failed_rows(cuda):
    """Healthy rows at 1e-10; an indefinite row (negative sig) takes the
    eigh value with a NaN gradient, a non-finite row (lx = 0) is NaN."""
    X, z, _, _ = toy_data(6, seed=4)
    params = [[0.9, 1.2], [0.9, 1.2], [0.0, 1.2], [1.1, 0.8]]
    sig = [1.5, -0.5, 1.0, 0.7]
    got = _vg(params, sig, X, z, cuda)
    want = _vg(params, sig, X, z, torch.device("cpu"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-10)
    assert np.isnan(got[1][1]).all() and np.isfinite(got[0][1])


def _sync_warnings(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(x.message) for x in w)


def test_hmc_transition_reads_the_host_once_a_leapfrog_step(cuda):
    """The only host read of a transition is the NLL's, one a step."""
    X, z, _, _ = toy_data(12, seed=1)
    logprob = hmc.nll_logprob(kv.PER_SE, torch.tensor(X, device=cuda),
                              torch.tensor(z, device=cuda), 1e-6)
    x = torch.zeros((4, 3), dtype=torch.float64, device=cuda)
    lp, g = hmc.value_and_grad(logprob, x)
    p0 = torch.randn((4, 3), dtype=torch.float64, device=cuda)
    u = torch.rand(4, dtype=torch.float64, device=cuda)
    eps = torch.full((4,), 0.01, dtype=torch.float64, device=cuda)
    n = _sync_warnings(lambda: hmc.hmc_transition(logprob, x, lp, g, eps,
                                                  p0, u, 8))
    assert n == 8


def test_adam_loops_issue_no_sync(cuda):
    """``adam_update`` (a NaN gradient counts as zero) makes the host wait
    for the card nowhere, in the large-N fit's loop and alone; the batched
    fit waits only for the batched NLL's one read a call."""
    X, z, _, _ = toy_data(16, seed=2)
    Xc = torch.tensor(X, device=cuda)
    zc = torch.tensor(z, device=cuda)
    theta = torch.zeros(3, dtype=torch.float64, device=cuda)
    s2n = torch.tensor(1e-6, dtype=torch.float64, device=cuda)
    train._adam(kv.PER_SE, Xc, zc, theta, s2n, 2, 3e-2)  # loads, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        th, hist = train._adam(kv.PER_SE, Xc, zc, theta, s2n, 3, 3e-2)
        mu = torch.zeros_like(th)
        th2, _, _ = train.adam_update(th, torch.full_like(th, torch.nan),
                                      mu, mu, 0, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(hist).all() and torch.equal(th2, th)
    steps = 3
    n = _sync_warnings(lambda: train.fit_batch_adam(
        kv.PER_SE, Xc[None].expand(2, -1, -1), zc[None].expand(2, -1),
        sig2n=1e-6, x0=(0.0, 0.0, 0.0), steps=steps))
    # the copy of x0 to the card, then the NLL's one read a step and one
    # for the final NLLs
    assert n == 1 + steps + 1
