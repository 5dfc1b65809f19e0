"""The benchmark's core: cells found by name in the data files, spans
around the calls into the program, the window's clock, the reduction of a
profiler trace, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its
configuration is ``gpbench/configs/<config>.json``, its traffic
``gpbench/workloads/<cell>.json`` (whose ``driver`` names
``gpbench/drivers/<driver>.py``), and each per-layer metric a reader
``gpbench/metrics/<metric>.py`` with ``read(ctx)``.  Nothing here names a
cell, a configuration or a metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sympgpr_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file whose name may hold dots (a metric's)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell with everything the data files say of it."""

    name: str
    entry: dict        # its line of BENCHMARK.json's workloads
    config: dict       # gpbench/configs/<config>.json
    traffic: dict      # gpbench/workloads/<cell>.json
    end_to_end: list   # BENCHMARK.json metrics that this cell reports
    per_layer: list

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (default: the working
    directory, a checkout's root)."""
    root = Path.cwd() if root is None else root
    bench = read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = read_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = read_json(HERE / "workloads" / f"{name}.json")
    return Cell(name, entry, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def driver_class(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py",
                       f"gpbench_driver_{kind}").Driver


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "gpbench_metric_" + name.replace(".", "_")).read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``sympgpr_tpu_torch`` is not ``sympgpr_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class Spans:
    """Spans of the benchmark's own calls into the program: (name, start,
    end) on the host's clock, and, while a profiler runs, a
    ``record_function`` range ``gpbench::<name>`` in its trace."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if self.traced:
            from torch.profiler import record_function
            ctx = record_function(f"gpbench::{name}")
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter()))


# ---------------------------------------------------------------------------
# The profiler's trace


@dataclasses.dataclass
class Trace:
    """Device operations and host ranges of a traced window, in ns of the
    profiler's clock."""

    device: list       # (name, start, end): kernels, copies, memsets
    host: list         # (name, start, end): operators and annotations
    window: tuple      # (start, end) of the gpbench::window range

    def busy_ns(self, lo: int | None = None, hi: int | None = None) -> int:
        """ns within [lo, hi] (default: the window) in which some device
        operation ran: the union of their intervals."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        total, cur_a, cur_b = 0, None, None
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            total += cur_b - cur_a
        return total

    def kernel_ns(self, match, lo: int | None = None,
                  hi: int | None = None) -> tuple[int, int]:
        """(summed ns, count) of device operations whose name satisfies
        ``match`` and that start within [lo, hi] (default: the window)."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        total = count = 0
        for n, a, b in self.device:
            if lo <= a <= hi and match(n):
                total += b - a
                count += 1
        return total, count

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (summed by name) and
        the longest idle gaps of the device, each named by what the host
        was doing at its middle (the shortest host range around it)."""
        lo, hi = self.window
        by_name: dict[str, int] = {}
        for n, a, b in self.device:
            if lo <= a <= hi:
                by_name[n] = by_name.get(n, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, last = [], lo
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if a > last:
                gaps.append((last, min(a, hi)))
            last = max(last, b)
            if last >= hi:
                break
        if last < hi:
            gaps.append((last, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            around = sorted((hb - ha, n) for n, ha, hb in self.host
                            if ha <= mid <= hb)
            inner = [n for _, n in around if not n.startswith("gpbench::")]
            what = (inner[0] if inner else f"{around[0][1]}, no operator"
                    if around else "outside the window's spans")
            named.append([_short(what), (b - a) * 1e-9])
        return {"device_ops": [[_short(n), t * 1e-9] for n, t in ops],
                "idle_gaps": named}


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def collect_trace(prof) -> Trace:
    """Device operations and host ranges of a finished
    ``torch.profiler.profile`` (CPU and CUDA activities).  A range of the
    benchmark's own (``gpbench::``) also appears on the device's timeline
    as an annotation; only the host's copy is kept."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        name = e.name()
        annotation = name.startswith("gpbench::") or bool(
            getattr(e, "is_user_annotation", lambda: False)())
        if e.device_type() == DeviceType.CUDA:
            if not annotation:
                device.append((name, a, b))
        else:
            host.append((name, a, b))
    window = next(((a, b) for n, a, b in host if n == "gpbench::window"),
                  None)
    if window is None:
        raise RuntimeError("the trace holds no gpbench::window range")
    return Trace(device, host, window)


# ---------------------------------------------------------------------------
# The result


def worst(a: float, b: float) -> float:
    """The larger of two readings, NaN if either is NaN."""
    a, b = float(a), float(b)
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def limits_line(checks: list) -> dict:
    """{name: {"value": v, "limit": l}} of the compared numbers (a value
    that is not a finite number as null)."""
    return {n: {"value": v if isinstance(v, (int, float)) and math.isfinite(v)
                else None, "limit": lim} for n, v, lim in checks}


def passes(checks: list) -> bool:
    """Each number at or below its limit, and a number (not NaN)."""
    return all(isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
               for _, v, lim in checks)


def print_checks(checks: list) -> None:
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
