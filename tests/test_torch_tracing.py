"""The port's spans (``profiling.span``): recorded in ``torch.profiler``'s
trace while a profiler runs, and nothing made while none does.

The large-N fit's spans are held on the CPU in both branches of
``nll_value_and_grad`` (the autodiff build, and the kernels' fused entries
through their plain versions); the rollout launch's children need the
card:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import contextlib
import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch_parity import ics, toy_data, tt  # noqa: E402

from sympgpr_tpu_torch import profiling  # noqa: E402
from sympgpr_tpu_torch.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu_torch.gp.train import fit_sympgp_ondevice  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as kv  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_cov  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_step as cs  # noqa: E402

STEP_CHILDREN = ("sympgpr::nll.build", "sympgpr::nll.factor",
                 "sympgpr::nll.alpha", "sympgpr::linalg.tri_inv",
                 "sympgpr::linalg.syrk", "sympgpr::nll.contraction",
                 "sympgpr::fit.update")
LAUNCH_CHILDREN = ("sympgpr::rollout.validate", "sympgpr::rollout.alloc",
                   "sympgpr::rollout.launch")


def _fit(steps=3):
    X, z, _, _ = toy_data(24, seed=3)
    return fit_sympgp_ondevice(kv.PER_SE, tt(X), tt(z), sig2n=1e-4,
                               steps=steps)


def _packed(device, dtype=torch.float32):
    X, z, Xp, zp = toy_data(20, seed=1)
    f64 = dict(dtype=torch.float64, device=device)
    sgp = SympGP.create(kv.PER_SE, [0.9, 1.2], 1.5, 1e-2,
                        torch.tensor(X, **f64), z)
    aux = AuxGP.create(kv.PER_SE, [0.9, 1.2], 1.5, 1e-2,
                       torch.tensor(Xp, **f64), zp)
    pm = cs.pack_models(sgp, aux, mod_q=2 * math.pi, dtype=dtype)
    q0, p0 = (torch.tensor(x, dtype=dtype, device=device)
              for x in ics(2, b=30))
    return pm, q0, p0


def _spans(prof) -> list[tuple[str, int, int]]:
    """The program's spans of a finished profiler: (name, start, end) in
    ns, in order of start."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("sympgpr::") and \
                e.device_type() == torch.autograd.DeviceType.CPU:
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return sorted(out, key=lambda s: s[1])


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = profiling.span("sympgpr::a"), profiling.span("sympgpr::b")
    assert a is b is profiling._OFF
    assert isinstance(a, contextlib.nullcontext)
    with a, b:  # shared, nested: still nothing
        pass


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = profiling.span("sympgpr::probe")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(4).sum()
    assert [n for n, _, _ in _spans(prof)] == ["sympgpr::probe"]
    assert profiling.span("sympgpr::after") is profiling._OFF


def _raise(*args, **kwargs):
    raise AssertionError("record_function made with no profiler running")


@pytest.mark.parametrize("path", ["fit", "rollout"])
def test_no_record_function_without_a_profiler(monkeypatch, path):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    if path == "fit":
        _, hist, _, _ = _fit()
        assert np.isfinite(hist).all()
    else:
        pm, q0, p0 = _packed(torch.device("cpu"))
        Q, _ = cs.rollout_in_kernel(pm, q0, p0, 4)
        assert Q.shape == (4, 30)


@pytest.mark.parametrize("fused", [False, True])
def test_fit_spans_nest_by_time(monkeypatch, fused):
    """One fit of 3 steps: one fit, 3 steps and one finish in it; each
    step holds one each of its seven children, and every child lies inside
    its parent.  ``fused`` takes the kernels' entries (their plain
    versions on the CPU)."""
    if fused:
        monkeypatch.setattr(cuda_cov, "want_cuda_build", lambda k, X: True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit(steps=3)
    spans = _spans(prof)
    by = {}
    for s in spans:
        by.setdefault(s[0], []).append(s)
    (fit,) = by["sympgpr::fit"]
    (finish,) = by["sympgpr::fit.finish"]
    steps = by["sympgpr::fit.step"]
    assert len(steps) == 3
    assert _inside(finish, fit) and all(_inside(s, fit) for s in steps)
    assert finish[1] >= steps[-1][2]
    for name in STEP_CHILDREN:
        assert len(by[name]) == 3, name
        for step in steps:
            assert sum(_inside(c, step) for c in by[name]) == 1, name
    assert set(by) == {"sympgpr::fit", "sympgpr::fit.step",
                       "sympgpr::fit.finish", *STEP_CHILDREN}


def test_rollout_span_per_call_on_the_cpu():
    pm, q0, p0 = _packed(torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            cs.rollout_in_kernel(pm, q0, p0, 3)
    assert [n for n, _, _ in _spans(prof)] == ["sympgpr::rollout"] * 2


@pytest.mark.cuda
def test_launch_spans_on_the_card():
    """On the card each call holds one validate, alloc and launch span, in
    that order; with the profiler off the launch still runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    pm, q0, p0 = _packed(dev)
    cs.rollout_in_kernel(pm, q0, p0, 3)  # build and load the library
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(2):
            cs.rollout_in_kernel(pm, q0, p0, 3)
        torch.cuda.synchronize()
    spans = _spans(prof)
    calls = [s for s in spans if s[0] == "sympgpr::rollout"]
    assert len(calls) == 2
    for call in calls:
        kids = [s for s in spans if s is not call and _inside(s, call)]
        assert tuple(n for n, _, _ in kids) == LAUNCH_CHILDREN
        assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))
