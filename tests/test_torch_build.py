"""Names of the built kernel libraries (``sympgpr_tpu_torch/ops/_build.py``).

A library's file name carries a hash of its ``.cu`` source, of every
header under ``csrc/`` and of nvcc's flags, so an edited source or header
is rebuilt and never served from a stale library.  Only the path is
computed here: no nvcc needed.
"""

import re

import pytest

pytest.importorskip("torch")

from sympgpr_tpu_torch.ops import _build  # noqa: E402


def test_library_path_hashes_source_and_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libk-")
    (tmp_path / "a.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    third = _build.library_path("k")
    (tmp_path / "b.cuh").write_text("")
    fourth = _build.library_path("k")
    assert len({first, second, third, fourth}) == 4


@pytest.mark.parametrize("name", ["rollout_step", "cov_blocks", "tri_matmul"])
def test_every_local_include_is_hashed(name):
    """Each quoted include of a shipped source is a ``.cuh`` header beside
    it, one of those ``library_path`` hashes."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    hashed = {p.name for p in _build.CSRC.glob("*.cuh")}
    for inc in re.findall(r'#include\s+"([^"]+)"', src):
        assert inc in hashed, inc
