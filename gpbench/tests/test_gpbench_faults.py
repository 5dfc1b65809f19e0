"""The check of ``correct`` against wrong programs: each cell's run driven
on the CPU at a small size (the harness's look for a card skipped, the
kernels' plain versions in their place), first sound, then with the timed
path broken underneath, once for each fault the cell can have (a step
that returns its state unchanged; half of the batch left out; an answer
altered where it is produced; no cell spans chips), and with the control,
the reference in a lower precision in the program's place."""

import copy
import math

import pytest
import torch

from gpbench import control, harness, inputs, program
from gpbench import run as runner
from gpbench.tests.small import SIZES

SEED = 4000000001


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE", tmp_path)
    torch.set_num_threads(2)


def _run(cell: str, overrides: dict | None = None, seconds: float = 0.5):
    return runner.run(cell, SEED, seconds, False, torch.device("cpu"),
                      sizes=SIZES[cell], program=overrides,
                      t0=runner.time.perf_counter())


# --- faults of the rollout ------------------------------------------------

def _rollout_unchanged(pm, q0, p0, nm, iters, loss_check):
    Q, P = program.rollout(pm, q0, p0, nm, iters, loss_check)
    return Q[:1].expand_as(Q).contiguous(), P[:1].expand_as(P).contiguous()


def _rollout_half(pm, q0, p0, nm, iters, loss_check):
    h = q0.shape[0] // 2
    Qh, Ph = program.rollout(pm, q0[:h].contiguous(), p0[:h].contiguous(),
                             nm, iters, loss_check)
    Q = torch.zeros((nm, q0.shape[0]), dtype=Qh.dtype)
    P = torch.zeros_like(Q)
    Q[:, :h], P[:, :h] = Qh, Ph
    return Q, P


def _rollout_altered(pm, q0, p0, nm, iters, loss_check):
    Q, P = program.rollout(pm, q0, p0, nm, iters, loss_check)
    P[1:] *= 1.01
    return Q, P


# --- faults of the large-N fit ----------------------------------------------

def _large_unchanged(config, X, z):
    a = program.fit_large(config, X, z)
    th0 = torch.log10(torch.tensor(config["fit"]["theta0"], dtype=X.dtype))
    return dict(a, theta=th0, hist=a["hist"][:1].repeat(len(a["hist"])))


def _large_half(config, X, z):
    a = program.fit_large(config, X, z)
    n, h = X.shape[0], X.shape[0] // 2
    half = program.fit_large(config, X[:h].contiguous(),
                             torch.cat([z[:h], z[n:n + h]]))
    return dict(a, theta=half["theta"], hist=2 * half["hist"])


def _large_altered(config, X, z):
    """Each part of the answer off by half: theta (log10), alpha and the
    training error."""
    a = program.fit_large(config, X, z)
    return dict(a, theta=a["theta"] + math.log10(1.5), alpha=a["alpha"] * 1.5,
                train_mse=a["train_mse"] * 1.5)


FAULTS = {
    "tokamak.rollout_batch": {"rollout": (_rollout_unchanged, _rollout_half,
                                          _rollout_altered)},
    "tokamak_large.rollout": {"rollout": (_rollout_unchanged, _rollout_half,
                                          _rollout_altered)},
    "tokamak_large.fit": {"fit_large": (_large_unchanged, _large_half,
                                        _large_altered)},
}
CASES = [(c, k, i) for c, d in FAULTS.items() for k in d for i in range(3)]


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1


@pytest.mark.parametrize("cell,call,which", CASES,
                         ids=[f"{c}-{['unchanged', 'half', 'altered'][i]}"
                              for c, _, i in CASES])
def test_fault_is_not_correct(cell, call, which):
    res = _run(cell, {call: FAULTS[cell][call][which]})
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tokamak.rollout_batch",
                                  "tokamak_large.rollout"])
def test_control_is_not_correct(cell):
    res = _run(cell, control.control_program(harness.load_cell(cell)))
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_control_of_the_large_fit_on_the_card():
    """TF32 products exist on the card only: the cell at its own size."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need a CUDA device")
    cell = "tokamak_large.fit"
    res = runner.run(cell, SEED, 0.5, False, torch.device("cuda", 0),
                     program=control.control_program(
                         harness.load_cell(cell)),
                     t0=runner.time.perf_counter())
    assert not res["correct"], res["checks"]
    theta_gap = dict((n, v) for n, v, _ in res["checks"])["theta_gap"]
    assert theta_gap > 0.5


@pytest.mark.parametrize("fault", [None, _rollout_altered],
                         ids=["sound", "altered"])
@pytest.mark.parametrize("cell", ["tokamak.rollout_batch",
                                  "tokamak_large.rollout"])
def test_rollout_without_loss_check_with_a_wrap_of_p(cell, fault):
    """The configuration's settings that no cell uses today, driven through
    the program and the check: no loss check, and P wrapped (the program's
    q update reads the wrapped P)."""
    sizes = copy.deepcopy(SIZES[cell])
    sizes.setdefault("config", {}).update(loss_check=False, mod_p=2.0)
    res = runner.run(cell, SEED, 0.5, False, torch.device("cpu"),
                     sizes=sizes, program={"rollout": fault} if fault else None,
                     t0=runner.time.perf_counter())
    assert res["correct"] == (fault is None), res["checks"]
