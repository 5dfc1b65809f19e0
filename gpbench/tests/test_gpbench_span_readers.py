"""The readers of the program's spans (``gpbench/span_readers.py`` and
the four metrics over them) on hand-built traces whose answers are known,
on a trace without ``sympgpr::`` spans (None, as at a parent without
them), and on traced CPU runs of the two cells that report them."""

import random
from types import SimpleNamespace

import pytest
import torch

from gpbench import harness, span_readers
from gpbench import run as runner
from gpbench.tests.small import SIZES

SEED = 2**31 + 12345
FIT = ("host_step_ms.fit", "launches_per_step.fit")
LATENCY = ("launch_host_p95_ms.latency", "launch_idle.latency")


def _read(metric: str, trace) -> float | None:
    return harness.metric_reader(metric)(SimpleNamespace(trace=trace))


def _fit_trace() -> harness.Trace:
    step = "sympgpr::fit.step"
    host = [
        ("gpbench::window", 1000, 11000),
        (step, 500, 1500),  # starts before the window: left out
        ("cudaLaunchKernel", 600, 700),
        (step, 2000, 3000),
        ("cudaLaunchKernel", 2100, 2200),
        ("cudaLaunchKernel", 2500, 2600),
        (step, 4000, 6000),
        ("cuLaunchKernel", 4100, 4200),
        ("cudaMemcpyAsync", 4500, 4600),  # not a launch
        ("cudaLaunchKernelExC", 5000, 5100),
        ("cudaLaunchKernel", 5950, 6050),  # ends after its step
        (step, 7000, 8000),
        ("cudaLaunchKernel", 9000, 9100),  # in no step
        (step, 11500, 12000),  # starts after the window
    ]
    return harness.Trace([], host, (1000, 11000))


def test_host_step_ms_leaves_out_the_runtime_s_calls():
    step = "sympgpr::fit.step"
    host = [("gpbench::window", 1000, 20000),
            (step, 500, 1500),  # starts before the window: left out
            (step, 2000, 3000),  # own 800 ns
            ("cudaLaunchKernel", 2100, 2200), ("aten::mm", 2300, 2400),
            ("cudaMemcpyAsync", 2500, 2600),
            (step, 4000, 6000),  # own 600 ns: a cuXxx call inside a
            ("cudaLaunchKernel", 4100, 5500),  # cudaXxx call counts once
            ("cuLaunchKernel", 4200, 4300),
            ("cublasSgemm_v2", 5600, 5700),  # a library's range: own time
            (step, 7000, 8500),  # own 1500 ns: a wait outside the step
            ("cudaStreamSynchronize", 8500, 9000)]
    tr = harness.Trace([], host, (1000, 20000))
    assert _read("host_step_ms.fit", tr) == pytest.approx(8e-4)
    assert span_readers.percentile_ms(tr, step, 50) == pytest.approx(1.5e-3)


def test_launches_per_step_counts_launches_inside_steps():
    # 2 + 2 launches inside the window's 3 steps
    assert _read("launches_per_step.fit", _fit_trace()) == \
        pytest.approx(4 / 3)


def test_launch_p95_is_taken_over_spans():
    host = [("gpbench::window", 0, 10**9),
            ("sympgpr::rollout", -10, 10**8)]  # starts before: left out
    for k in range(1, 101):
        a = 10**6 * k
        host.append(("sympgpr::rollout", a, a + 1000 * k))
        host.append(("cudaLaunchKernel", a + 10, a + 20))
    tr = harness.Trace([], host, (0, 10**9))
    # durations 1000 ... 100,000 ns: numpy's 95th percentile is 95,050
    assert _read("launch_host_p95_ms.latency", tr) == pytest.approx(0.09505)


def test_launch_idle_subtracts_the_busy_part_of_each_span():
    host = [("gpbench::window", 0, 10000),
            ("sympgpr::rollout", -500, 500),  # starts before: left out
            ("sympgpr::rollout", 1000, 2000),
            ("sympgpr::rollout", 3000, 5000)]
    device = [("rollout_kernel", 1500, 2500),
              ("Memcpy DtoH", 3200, 3400), ("Memset", 3300, 3600),
              ("rollout_kernel", 4800, 6000)]
    tr = harness.Trace(device, host, (0, 10000))
    # idle under the spans: (1000 - 500) + (2000 - 400 - 200) of 10000
    assert _read("launch_idle.latency", tr) == pytest.approx(19.0)


def test_idle_under_spans_agrees_with_busy_ns():
    rng = random.Random(7)
    device = []
    for _ in range(300):
        a = rng.randrange(0, 10**6)
        device.append(("k", a, a + rng.randrange(0, 5000)))
    spans = []
    for _ in range(100):
        a = rng.randrange(0, 10**6)
        spans.append(("sympgpr::rollout", a, a + rng.randrange(1, 20000)))
    tr = harness.Trace(device, [("gpbench::window", 0, 10**6)] + spans,
                       (0, 10**6))
    want = sum((b - a) - tr.busy_ns(a, b) for _, a, b in spans)
    assert span_readers.idle_under_pct(tr, "sympgpr::rollout") == \
        pytest.approx(100.0 * want / 10**6)


@pytest.mark.parametrize("metric", FIT + LATENCY)
def test_none_without_the_program_s_spans(metric):
    """A parent's trace: the benchmark's own ranges, operators, launches
    and kernels, but no ``sympgpr::`` span."""
    host = [("gpbench::window", 0, 10**6), ("gpbench::rollout", 10, 500),
            ("aten::empty_strided", 20, 30), ("cudaLaunchKernel", 40, 50)]
    tr = harness.Trace([("rollout_kernel", 45, 9000)], host, (0, 10**6))
    assert _read(metric, tr) is None


@pytest.mark.parametrize("cell,metrics", [("tokamak_large.fit", FIT),
                                          ("tokamak_large.rollout", LATENCY)])
def test_traced_cpu_run_reads_the_spans(cell, metrics):
    res = runner.run(cell, SEED, 0.5, True, torch.device("cpu"),
                     sizes=SIZES[cell], t0=runner.time.perf_counter())
    for m in metrics:
        assert res["metrics"][m]["value"] >= 0, m
    if cell == "tokamak_large.fit":
        assert res["metrics"]["host_step_ms.fit"]["value"] > 0
        # the plain versions on the CPU launch no kernel
        assert res["metrics"]["launches_per_step.fit"]["value"] == 0
    else:
        assert res["metrics"]["launch_host_p95_ms.latency"]["value"] > 0
