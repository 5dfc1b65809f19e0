"""The harness: every cell, configuration and metric found by name in the
data files; no run without a card; no JAX in a run's process; the result
line's shape."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gpbench import harness

ROOT = Path(harness.HERE).parent
BENCH = harness.read_json(ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = harness.load_cell(cell, ROOT)
    assert c.entry["config"] in {k["name"] for k in BENCH["configs"]}
    assert callable(harness.driver_class(c.driver))
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads_by_name(metric):
    assert callable(harness.metric_reader(metric))


def test_configs_name_their_files_and_sources():
    for c in BENCH["configs"]:
        cfg = harness.read_json(ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert len(cfg["hyperparameters"]["sympgp"]) == 3


def test_benchmark_file_within_its_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_run_fails_without_a_card():
    p = subprocess.run(
        [sys.executable, "-m", "gpbench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "5000000001",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


_SETUP_ONLY = """
import json, sys, torch
from pathlib import Path
import gpbench.inputs as inputs
inputs.CACHE = Path(sys.argv[1])
from gpbench import harness
from gpbench.tests.small import SIZES
for name, sizes in SIZES.items():
    cell = harness.load_cell(name)
    drv = harness.driver_class(cell.driver)(cell, 5000000002,
                                            torch.device("cpu"), None, sizes)
    drv.setup()
print(json.dumps(harness.forbidden_modules()))
"""


def test_no_jax_after_every_drivers_setup(tmp_path):
    p = subprocess.run([sys.executable, "-c", _SETUP_ONLY, str(tmp_path)],
                       cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sympgpr_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert "jaxfoo" not in harness.forbidden_modules()
    assert "sympgpr_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sympgpr_tpu.gp", sys)
    assert "sympgpr_tpu.gp" in harness.forbidden_modules()


class _Tracked(dict):
    """A configuration that records every key read from it, nested groups
    included, as dotted paths in ``seen``."""

    def __init__(self, d: dict, seen: set, path: str = ""):
        super().__init__({k: _Tracked(v, seen, f"{path}{k}.")
                          if isinstance(v, dict) else v
                          for k, v in d.items()})
        self.seen, self.path = seen, path

    def __getitem__(self, k):
        self.seen.add(self.path + k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.seen.add(self.path + k)
        return super().get(k, default)


def _paths(d: dict, path: str = "") -> set:
    out = set()
    for k, v in d.items():
        out |= (_paths(v, f"{path}{k}.") if isinstance(v, dict)
                else {path + k})
    return out


# what a configuration file records for its reader, and no code reads
RECORDS = {"source", "reduced", "assumed", "hyperparameters.from"}


def test_every_config_key_is_read(tmp_path, monkeypatch):
    """Each key of a configuration file is read by a run of one of its
    cells (at the tests' small sizes, on the CPU): no setting in a file
    does nothing."""
    import torch

    from gpbench import inputs
    from gpbench.tests.small import SIZES

    monkeypatch.setattr(inputs, "CACHE", tmp_path)
    seen: dict[str, set] = {}
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], ROOT)
        drv = harness.driver_class(cell.driver)(
            cell, 5000000003, torch.device("cpu"), None, SIZES[w["name"]])
        drv.config = _Tracked(drv.config, seen.setdefault(w["config"], set()))
        drv.setup()
        drv.window(0.2)
        drv.end_to_end()
        drv.release()
        drv.check()
    for c in BENCH["configs"]:
        keys = _paths(harness.read_json(ROOT / c["file"])) - RECORDS
        assert keys <= seen[c["name"]], sorted(keys - seen[c["name"]])
