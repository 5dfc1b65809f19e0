"""One run of one cell of the port's benchmark.

    python -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with ``BENCHMARK.json``.  The run builds (or
loads) the program's kernels that the cell launches, makes its inputs
from the seed, warms the cell's shapes up (all of that is ``setup_s``),
issues the cell's traffic for ``--seconds``, and then checks what the
window produced against the plain reference.  It prints the compared
numbers with their limits as the last lines of standard error, and as the
last line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics read from ``torch.profiler``'s trace
of the window), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.

It needs a CUDA device: without one, or with fewer than the cell asks
for, it exits with status 2 and prints no result.  It exits with status 3
and prints no result if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

CACHE = Path(__file__).resolve().parent / ".cache"
# every build and kernel cache of the process at a fixed path inside the
# checkout; the program's own kernels build into sympgpr_tpu_torch/_build/
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# one process, one host thread for its numerical libraries: the host's
# cores are shared, and idle pool threads only add to the spread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

import torch  # noqa: E402

from gpbench import harness  # noqa: E402


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, sizes: dict | None = None,
        program: dict | None = None, root: Path | None = None,
        t0: float | None = None) -> dict:
    """One run; returns the result's fields.  ``sizes`` and ``program``
    (replacements of the driver's calls into the program) serve the
    controls and the tests; the benchmark's runs pass neither."""
    t0 = T0 if t0 is None else t0
    cell = harness.load_cell(cell_name, root)
    spans = harness.Spans(traced=trace)
    drv = harness.driver_class(cell.driver)(cell, seed, device, spans, sizes)
    for k, fn in (program or {}).items():
        setattr(drv.program, k, fn)
    t_setup = time.perf_counter()
    drv.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
    drv.window(seconds)
    if cuda:
        torch.cuda.synchronize(device)
    if prof is not None:
        prof.__exit__(None, None, None)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0)}
    counters = drv.counters()
    out: dict = {}
    if trace:
        tr = harness.collect_trace(prof)
        del prof
        dev["busy_s"] = tr.busy_ns() * 1e-9
        dev["window_s"] = (tr.window[1] - tr.window[0]) * 1e-9
        ctx = SimpleNamespace(trace=tr, driver=drv, cell=cell,
                              counters=counters)
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = tr.breakdown()
    else:
        values = dict(drv.end_to_end(), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if cuda:
        limit = power_limit()
        if limit:
            dev["name_power_limit"] = limit
    drv.release()
    checks = drv.check()
    return dict(correct=harness.passes(checks), attempted=counters.get(
        "requests", counters.get("fits", 0)), failed=0, metrics=metrics,
        device=dev, counters=counters, build_s=drv.build_s,
        setup_phases=dict(drv.phases, before_setup=t_setup - t0),
        detail=getattr(drv, "check_detail", None), **out, checks=checks)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = harness.load_cell(args.workload)
    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gpbench: the cell needs {need} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"gpbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    checks = res.pop("checks")
    print(json.dumps({k: res[k] for k in ("counters", "build_s", "setup_phases",
                                        "detail")},
                     default=str), file=sys.stderr)
    harness.print_checks(checks)
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device")}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = harness.limits_line(checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
