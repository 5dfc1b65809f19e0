"""The standard map's cell, ``standard_map.rollout_batch``, and the
tokamak's full-batch cell at N = 4096, ``tokamak_large.rollout_batch``, on
the CPU: the reference system's training pairs against the program's, the
program's plain path with the wrap of P and pdiff against the reference
row by row, four planted faults of the timed path and the control, each
driven through the cell's set-up, window and check at the small size that
``conftest.py`` registers, and the new metric readers."""

import dataclasses
import math
from types import SimpleNamespace

import pytest
import torch

from gpbench import control, harness, inputs, program
from gpbench import run as runner
from gpbench.reference import gp as ref_gp
from gpbench.reference.systems import standard_map as ref_sys
from gpbench.rollouts import reference_model
from gpbench.tests.small import SIZES

CELL = "standard_map.rollout_batch"
SEED = 4000000005
_call = program.call_file("rollout_pdiff").call


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE", tmp_path)
    torch.set_num_threads(2)


def _config() -> dict:
    cell = harness.load_cell(CELL)
    return dict(cell.config, name=cell.entry["config"])


def test_pairs_equal_the_programs_training_data():
    from sympgpr_tpu_torch.systems import standard_map as sm

    cfg = _config()
    want = sm.training_data(sm.StandardMapConfig(k=cfg["k"], N=cfg["N"]),
                            "cpu")
    (got,) = ref_sys.pairs(cfg, [0], "cpu")
    for k in "qpQP":
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_plain_path_equals_the_reference_row_by_row(seed):
    """The program's deployment and plain rollout (``rollout_reference``
    with the wrap of P and pdiff, float64, Newton run to convergence) on
    seeded random hyperparameters and training pairs of the exact map:
    each row t + 1 against one reference step from row t (Q and P across
    their wraps), D's increment against the reference's unwrapped P less
    p_t (1e-10: two float64 solves of alpha at the deployment noise), and
    D's row 0 equal to p0."""
    g = torch.Generator().manual_seed(seed)

    def uniform(lo, hi, n=()):
        return lo + (hi - lo) * torch.rand(n, generator=g,
                                           dtype=torch.float64)

    q, p = uniform(0, 2 * math.pi, 24), uniform(0, 2 * math.pi, 24)
    P = p + 2.0 * torch.sin(q)
    train = dict(q=q, p=p, Q=q + P, P=P)
    # around the fitted lengths (10.8, 5.3), sig as the fit fixes it: far
    # shorter lengths can leave the map without a root near the aux
    # guess, where Newton runs on without converging
    hyp = [float(uniform(5.0, 15.0)), float(uniform(3.0, 8.0)),
           2.0 * float(torch.cat([p - P, P]).abs().max()) ** 2]
    aux = [float(uniform(0.1, 1.0)), float(uniform(0.1, 1.0)), 8.0]
    cfg = dict(_config(), N=24, aux={"points": 24, "sig2n": 1e-10},
               sig2n=1e-10, dtype="float64",
               hyperparameters={"sympgp": hyp, "aux": aux})
    pm = program.deploy(cfg, train)
    q0, p0 = uniform(0, 2 * math.pi, 40), uniform(0, 2 * math.pi, 40)
    Qt, Pt, Dt = _call(pm, q0, p0, 12, 60, False, True)
    assert torch.equal(Dt[0], p0)
    model = reference_model(cfg, train)
    for t in range(11):
        Q, Pu, _ = ref_gp.map_step(model, Qt[t], Pt[t])
        torch.testing.assert_close(
            torch.remainder(Q, 2 * math.pi), Qt[t + 1], rtol=0, atol=1e-10)
        torch.testing.assert_close(
            torch.remainder(Pu, 2 * math.pi), Pt[t + 1], rtol=0, atol=1e-10)
        torch.testing.assert_close(Dt[t + 1] - Dt[t], Pu - Pt[t], rtol=0,
                                   atol=1e-10)
    assert float(Pt.max()) < 2 * math.pi and float(Pt.min()) >= 0


def _run(cell: str = CELL, overrides: dict | None = None):
    return runner.run(cell, SEED, 0.5, False, torch.device("cpu"),
                      sizes=SIZES[cell], program=overrides,
                      t0=runner.time.perf_counter())


def test_sound_run_reads_d_and_its_counter():
    res = _run()
    assert res["correct"], res["checks"]
    checks = {n: v for n, v, _ in res["checks"]}
    assert checks["pdiff_err"] < 1e-4 and res["detail"]["d0_err"] == 0
    # the plain version runs on the CPU: no launch in the window
    assert res["counters"] == {"requests": res["attempted"],
                               "launches_wrap": 0}


def test_counter_left_out_where_the_program_counts_none(monkeypatch):
    """A program without the ``rollout_wrap`` count (the parent's) still
    runs the cell; its counters leave ``launches_wrap`` out."""
    counts = program.launch_counts()
    counts.pop("rollout_wrap", None)
    monkeypatch.setattr(program, "launch_counts", lambda: dict(counts))
    res = _run()
    assert res["correct"], res["checks"]
    assert "launches_wrap" not in res["counters"]


# --- faults of the rollout with pdiff -------------------------------------

def _altered(pm, q0, p0, nm, iters, loss_check, pdiff):
    Q, P, D = _call(pm, q0, p0, nm, iters, loss_check, pdiff)
    P[1:] *= 1.01
    return Q, P, D


def _no_wrap(pm, q0, p0, nm, iters, loss_check, pdiff):
    """P left unwrapped: the models as packed without mod_p, whose value
    (column 8 of the constants, which the kernel wraps by) is then 0."""
    scal = pm.scal.clone()
    scal[:, 8] = 0.0
    return _call(dataclasses.replace(pm, mod_p=None, scal=scal), q0, p0, nm,
                 iters, loss_check, pdiff)


def _d_of_wrapped(pm, q0, p0, nm, iters, loss_check, pdiff):
    """D summed from the wrapped momenta: off by 2 pi at each crossing."""
    Q, P, _ = _call(pm, q0, p0, nm, iters, loss_check, pdiff)
    D = torch.cat([P[:1], P[:1] + torch.cumsum(P[1:] - P[:-1], 0)])
    return Q, P, D


def _d_at_p0(pm, q0, p0, nm, iters, loss_check, pdiff):
    Q, P, _ = _call(pm, q0, p0, nm, iters, loss_check, pdiff)
    return Q, P, P[:1].expand_as(P).contiguous()


FAULTS = {"altered": (_altered, "step_err"),
          "wrap_skipped": (_no_wrap, "wrap_viol"),
          "d_of_wrapped_p": (_d_of_wrapped, "pdiff_err"),
          "d_left_at_p0": (_d_at_p0, "pdiff_err")}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault):
    fn, number = FAULTS[fault]
    res = _run(overrides={"rollout_pdiff": fn})
    assert not res["correct"], res["checks"]
    # the number that sees it is over its limit
    value, limit = next((v, lim) for n, v, lim in res["checks"]
                        if n == number)
    assert not value <= limit, res["checks"]


@pytest.mark.parametrize("cell", [CELL, "tokamak_large.rollout_batch"])
def test_control_is_not_correct(cell):
    res = _run(cell, control.control_program(harness.load_cell(cell)))
    assert not res["correct"], res["checks"]


def test_altered_full_batch_is_not_correct():
    """The tokamak's full-batch cell at N = 4096 (a traffic file on the
    batch driver) with P x 1.01."""
    def altered(pm, q0, p0, nm, iters, loss_check):
        Q, P = program.rollout(pm, q0, p0, nm, iters, loss_check)
        P[1:] *= 1.01
        return Q, P

    res = _run("tokamak_large.rollout_batch", {"rollout": altered})
    assert not res["correct"], res["checks"]


# --- the new metric readers ----------------------------------------------

def _ctx(device_ops: list, counters: dict):
    cell = harness.load_cell(CELL)
    tr = harness.Trace(device=device_ops,
                       host=[("gpbench::window", 0, 10**9)],
                       window=(0, 10**9))
    drv = SimpleNamespace(config=cell.config, traffic=cell.traffic)
    return SimpleNamespace(trace=tr, driver=drv, cell=cell, counters=counters)


@pytest.mark.parametrize("metric", ["rollout_roofline.stdmap",
                                    "device_idle.stdmap"])
def test_reader_returns_none_without_the_kernel(metric):
    ops = [] if metric == "device_idle.stdmap" else [("aten::copy_", 10, 20)]
    ctx = _ctx(ops, {"launches_wrap": 3})
    assert harness.metric_reader(metric)(ctx) is None


def test_roofline_counts_the_wrap_launches():
    """Without ``launches_wrap`` (a program that counts none) the share is
    left out; with it, launches x one launch's bound (the 20 real points,
    8 Newton iterations, D's writes) over the kernel's device time."""
    from gpbench import rooflines

    read = harness.metric_reader("rollout_roofline.stdmap")
    ops = [("rollout_kernel<float, 1>", 0, 25_000_000)]  # 25 ms
    assert read(_ctx(ops, {})) is None
    b = rooflines.rollout_bound(32768, 1000, 20, 20, 4, 8)
    assert b["bound_by"] == "operations"
    assert read(_ctx(ops, {"launches_wrap": 2})) == pytest.approx(
        100.0 * 2 * b["bound_ms"] / 25.0)
