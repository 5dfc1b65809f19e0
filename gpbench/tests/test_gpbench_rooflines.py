"""The roofline counts at the cells' shapes."""

import pytest

from gpbench import rooflines


def test_rollout_bounds_at_the_cells_shapes():
    batch = rooflines.rollout_bound(32768, 1000, 80, 80, 4)
    assert batch["bound_ms"] == pytest.approx(4.7344, abs=1e-4)
    assert batch["bound_by"] == "operations"
    latency = rooflines.rollout_bound(30, 1000, 4096, 512, 4)
    assert latency["bound_ms"] == pytest.approx(0.19868, abs=1e-5)
    assert latency["bytes"] == 4 * (4 * 4096 + 3 * 512 + 60 + 60000)


def test_fit_step_counts():
    n = 8192
    step = rooflines.fit_step(4096, 4)
    assert step["flops"] == pytest.approx(n**3)
    # three n^3/3 products at 67 TFLOP/s and ~0.2 ms of bytes
    assert step["bound_ms"] == pytest.approx(3 * n**3 / 3 / 67e9 + 0.201,
                                             abs=2e-3)
    assert rooflines.syrk_flops(n) == pytest.approx(n**3 / 3)
    # the blocked inverse's products: n^3/3 less its base blocks
    assert rooflines.tri_inv_flops(n) == pytest.approx(
        8192 * (512**2 + 1024**2 + 2048**2 + 4096**2))
    assert rooflines.tri_inv_flops(n) < n**3 / 3


def test_covariance_bytes():
    assert rooflines.cov_build_bytes(4096, 4) == 4 * (4 * 4096**2 + 8192)
    # half of S: the lower triangles of its qq and PP blocks and its
    # lower-left block
    assert rooflines.cov_contraction_bytes(4096, 4) == pytest.approx(
        4 * 2 * 4096**2, rel=1e-3)
