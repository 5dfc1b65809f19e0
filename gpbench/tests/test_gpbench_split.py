"""The Split tokamak's cell, ``tokamak_split.rollout``, on the CPU: the
reference system's training pairs and map step against the program's, the
cell's sound run, six planted faults of the timed path and the control,
each driven through the cell's set-up, window and check at the small size
that ``conftest.py`` registers, and the new metric readers on a trace that
holds nothing to read."""

import dataclasses
import math
from types import SimpleNamespace

import pytest
import torch

from gpbench import control, harness, inputs, program, rollouts_split
from gpbench import run as runner
from gpbench.reference.systems import tokamak_split as ref_sys
from gpbench.tests.small import SIZES

CELL = "tokamak_split.rollout"
SEED = 4000000003
_call = program.call_file("rollout_split").call


@pytest.fixture(autouse=True)
def _cache(tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE", tmp_path)
    torch.set_num_threads(2)


def _config(N: int = 16) -> dict:
    cell = harness.load_cell(CELL)
    return dict(cell.config, name=cell.entry["config"], N=N)


def test_pairs_equal_the_programs_training_data():
    from sympgpr_tpu_torch.__main__ import SPLIT
    from sympgpr_tpu_torch.systems import tokamak as tk

    cfg = _config()
    want = tk.training_data(tk.TokamakConfig(**dict(SPLIT, N=16)), "cpu")
    (got,) = ref_sys.pairs(cfg, [0], "cpu")
    for k in "qpQP":
        assert got[k].shape == (16, cfg["sub_maps"])
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-13)


def test_map_step_equals_the_programs_split_step():
    """The reference's models of the sub-maps, each stepped once from the
    same rows, against the program's ``apply_map_split_fast`` over its
    own float64 models of the same pairs at the deployment noise
    (``for_deployment``), step i by sub-map i mod 4, Newton to
    convergence on both sides."""
    from sympgpr_tpu_torch import AuxGP, SympGP, get_kernel
    from sympgpr_tpu_torch.maps import fast_apply
    from sympgpr_tpu_torch.maps.symplectic import MapConfig

    cfg = dict(_config(), aux={"points": 16, "sig2n": 1e-14})
    (train,) = inputs.training_sets(cfg, [0], "cpu")
    models = rollouts_split.reference_models(cfg, train)
    kern, jit = get_kernel(cfg["kernel"]), cfg["deployment_jitter"]
    sgps, auxes = [], []
    for c, d in rollouts_split.sub_maps(cfg, train):
        h = c["hyperparameters"]
        X = torch.stack([d["q"], d["P"]], 1)
        z = torch.cat([d["p"] - d["P"], d["Q"] - d["q"]])
        sgps.append(SympGP.create(kern, h["sympgp"][:2], h["sympgp"][2],
                                  cfg["sig2n"], X, z).for_deployment(jit))
        auxes.append(AuxGP.create(
            kern, h["aux"][:2], h["aux"][2], cfg["aux"]["sig2n"],
            torch.stack([d["q"], d["p"]], 1), d["P"] - d["p"],
            delta=True).for_deployment(jit))
    g = torch.Generator().manual_seed(3)
    q0, p0 = ref_sys.initial_conditions(cfg, [[0.16, 0.31], [0, 2 * math.pi]],
                                        torch.rand((2, 12), generator=g,
                                                   dtype=torch.float64))
    traj = fast_apply.apply_map_split_fast(
        sgps, auxes, q0, p0, 9,
        MapConfig(mod_q=None, newton_tol=1e-14, newton_maxiter=50))
    for t in range(8):
        Q, P, _ = rollouts_split.ref_gp.map_step(models[t % 4], traj.q[t],
                                                 traj.p[t])
        torch.testing.assert_close(Q, traj.q[t + 1], rtol=0, atol=1e-10)
        torch.testing.assert_close(P, traj.p[t + 1], rtol=0, atol=1e-10)


def _run(overrides: dict | None = None):
    return runner.run(CELL, SEED, 0.5, False, torch.device("cpu"),
                      sizes=SIZES[CELL], program=overrides,
                      t0=runner.time.perf_counter())


def test_sound_run_is_correct_and_probes_the_loss_rule():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    # the probe loses some of its orbits, not all
    assert 0 < res["detail"]["probe_lost"] < res["detail"]["probe_orbits"]


# --- faults of the Split rollout ----------------------------------------

def _unchanged(pm, q0, p0, nm, iters, loss_check, new_q):
    Q, P = _call(pm, q0, p0, nm, iters, loss_check, new_q)
    return Q[:1].expand_as(Q).contiguous(), P[:1].expand_as(P).contiguous()


def _half(pm, q0, p0, nm, iters, loss_check, new_q):
    h = q0.shape[0] // 2
    Qh, Ph = _call(pm, q0[:h].contiguous(), p0[:h].contiguous(), nm, iters,
                   loss_check, new_q)
    Q = torch.zeros((nm, q0.shape[0]), dtype=Qh.dtype, device=Qh.device)
    P = torch.zeros_like(Q)
    Q[:, :h], P[:, :h] = Qh, Ph
    return Q, P


def _altered(pm, q0, p0, nm, iters, loss_check, new_q):
    Q, P = _call(pm, q0, p0, nm, iters, loss_check, new_q)
    P[1:] *= 1.01
    return Q, P


def _reorder(pm, index):
    """The packed sub-maps in another order: block m of the result is
    block ``index[m]`` of ``pm``."""
    M = pm.n_maps

    def blocks(col):
        return col.reshape(M, -1)[index].reshape(col.shape).contiguous()

    return dataclasses.replace(
        pm, **{f: blocks(getattr(pm, f)) for f in (
            "uq", "uP", "a0", "a1", "auxq", "auxp", "auxa", "scal")})


def _cycled_off_by_one(pm, q0, p0, nm, iters, loss_check, new_q):
    index = [(m + 1) % pm.n_maps for m in range(pm.n_maps)]
    return _call(_reorder(pm, index), q0, p0, nm, iters, loss_check, new_q)


def _sub_map_0(pm, q0, p0, nm, iters, loss_check, new_q):
    return _call(_reorder(pm, [0] * pm.n_maps), q0, p0, nm, iters,
                 loss_check, new_q)


def _old_q(pm, q0, p0, nm, iters, loss_check, new_q):
    return _call(pm, q0, p0, nm, iters, loss_check, False)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered,
          "cycled_off_by_one": _cycled_off_by_one, "sub_map_0": _sub_map_0,
          "loss_at_old_q": _old_q}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_is_not_correct(fault):
    res = _run({"rollout_split": FAULTS[fault]})
    assert not res["correct"], res["checks"]


def test_control_is_not_correct():
    res = _run(control.control_program(harness.load_cell(CELL)))
    assert not res["correct"], res["checks"]


# --- the new metric readers ----------------------------------------------

METRICS = ["split_step_us.split", "rollout_roofline.split",
           "device_idle.split", "launch_idle.split"]


def _ctx(device_ops: list, counters: dict):
    cell = harness.load_cell(CELL)
    tr = harness.Trace(device=device_ops,
                       host=[("gpbench::window", 0, 1000)], window=(0, 1000))
    drv = SimpleNamespace(config=cell.config, traffic=cell.traffic)
    return SimpleNamespace(trace=tr, driver=drv, cell=cell, counters=counters)


@pytest.mark.parametrize("metric", METRICS)
def test_reader_returns_none_without_the_kernel(metric):
    """A window with no rollout kernel (device_idle: no device operation
    at all) and no program span reads nothing."""
    ops = [] if metric == "device_idle.split" else [("aten::copy_", 10, 20)]
    ctx = _ctx(ops, {"launches_split": 0})
    assert harness.metric_reader(metric)(ctx) is None


def test_split_step_reads_nothing_without_the_counter():
    """A program that counts no Split launch (no ``launches_split``)
    leaves ``split_step_us.split`` out, kernel or not; with the counter
    it is the kernel's time over launches x (steps - 1), in us."""
    read = harness.metric_reader("split_step_us.split")
    ops = [("rollout_kernel<float, 0, 0, true>", 100, 100 + 3999 * 7)]
    assert read(_ctx(ops, {})) is None
    assert read(_ctx(ops, {"launches_split": 2})) == pytest.approx(3.5e-3)
