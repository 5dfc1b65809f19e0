"""The rollout kernel's Split instances of the explicit update, Algorithm 2
and mod_p / pdiff (the library ``csrc/rollout_split_modes.cu``) against
its plain version, on the card.

Needs a CUDA device and nvcc; skips otherwise.  Needs no JAX:

  python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_split_modes.py

Layouts: two sub-maps that differ (20 and 12 points; Split cycling) and
one map checked at the new q.  Gates, as ``chip_smoke.py``'s
``split_modes_kernel_vs_plain``: float64 one kernel step from each row of
the plain trajectory, by the sub-map that made the next row, within 1e-12
(``rollout_check.step_err``), NaN patterns equal; float32 against the
float64 rollout of the same columns within 3x the plain version's own
error (``rollout_check.f32_vs_f64``).  Two wrong kernels fail them:
sub-map 0 on every step, and pdiff taken after the new q's NaN.  M copies
of one model through the Split instance equal the one-map instance.
"""

import dataclasses
import math

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch_parity import boundary_data, ics, toy_data  # noqa: E402

from sympgpr_tpu_torch.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu_torch.kernels import variants as kv  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_step as cs  # noqa: E402
from sympgpr_tpu_torch.ops import rollout_check as rc  # noqa: E402

pytestmark = pytest.mark.cuda

TWO_PI = 2 * math.pi
ATOL_F64_STEP = 1e-12
NM = 30


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _toy(kind, n, seed, device, aux):
    X, z, Xp, zp = toy_data(n, seed)
    k = kv.get_kernel(kind)
    params = [0.9, 1.2, 0.55][: k.n_params]
    f64 = dict(dtype=torch.float64, device=device)
    sgp = SympGP.create(k, params, 1.5, 1e-2, torch.tensor(X, **f64),
                        torch.tensor(z, **f64))
    if not aux:
        return sgp, None
    return sgp, AuxGP.create(k, params, 1.5, 1e-2, torch.tensor(Xp, **f64),
                             torch.tensor(zp, **f64), delta=True)


def _boundary(n, seed, shift, device):
    X, z = boundary_data(n, seed, shift)
    f64 = dict(dtype=torch.float64, device=device)
    X = torch.tensor(X, **f64)
    sgp = SympGP.create(kv.PER_SE, [0.9, 1.2], 1.5, 1e-2, X,
                        torch.tensor(z, **f64))
    aux = AuxGP.create(kv.PER_SE, [0.9, 1.2], 1.5, 1e-2, X,
                       torch.zeros(n, **f64), delta=True)
    return sgp, aux


# case: (two sub-maps' models, mod_p, rollout keywords, ICs)
CASES = {
    "explicit_per_se": (("per_se", False), TWO_PI, dict(explicit=True)),
    "explicit_se_se": (("se_se", False), TWO_PI, dict(explicit=True)),
    "sum": (("sum_per_se", False), TWO_PI, {}),
    "mod_p_per_se": (("per_se", True), TWO_PI, {}),
    "mod_p_se_se": (("se_se", True), TWO_PI, {}),
    "boundary": (None, 4 * math.pi, dict(loss_check=True)),
}


def _case(name, layout, device, dtype=torch.float64, B=300):
    """(pack, ICs, keywords) of a case: pdiff always; the new-q layout one
    map checked at the new q, the other two sub-maps (the boundary case
    checked at the old q)."""
    spec, mod_p, kw = CASES[name]
    if spec is None:
        pairs = [_boundary(24, 0, 1.0, device), _boundary(16, 1, 0.5, device)]
        q0 = torch.linspace(0, TWO_PI, B + 1, dtype=torch.float64)[:-1]
        p0 = torch.linspace(11.0, 13.5, B, dtype=torch.float64)[
            torch.randperm(B, generator=torch.Generator().manual_seed(0))]
    else:
        pairs = [_toy(spec[0], 20, 10, device, spec[1]),
                 _toy(spec[0], 12, 11, device, spec[1])]
        q, p = ics(3, b=B)
        q0, p0 = torch.tensor(q), torch.tensor(p * 8 + 3.0)
    kw = dict(kw, track_pdiff=True)
    if layout == "new_q":
        pairs = pairs[:1]
        kw.update(loss_check=True, loss_at_new_q=True)
    pm = cs.pack_models_split(*map(list, zip(*pairs)), mod_q=TWO_PI,
                              mod_p=mod_p, dtype=dtype)
    return pm, (q0.to(device, dtype), p0.to(device, dtype)), kw


def _kernel(team=None):
    def rollout(pm, q, p, nm, iters=5, loss_check=False, **kw):
        return cs._launch(pm, q, p, nm, iters, loss_check, team=team, **kw)
    return rollout


@pytest.mark.parametrize("team", [None, 4, 64])
@pytest.mark.parametrize("layout", ["two_maps", "new_q"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_float64_one_step_from_plain_rows(cuda, name, layout, team):
    pm, (q0, p0), kw = _case(name, layout, cuda)
    assert cs._library(pm, kw.get("loss_at_new_q", False),
                       kw.get("explicit", False),
                       True) == "rollout_split_modes"
    before = cs.LAUNCHES
    got = _kernel(team)(pm, q0, p0, NM, **kw)
    torch.cuda.synchronize()
    assert cs.LAUNCHES == before + 1 and len(got) == 3
    ref = cs.rollout_reference(pm, q0, p0, NM, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
    err = rc.step_err(_kernel(team), pm, ref, kw)
    assert err <= ATOL_F64_STEP, err
    if name == "boundary":
        P, D = ref[1], ref[2]
        lost = torch.isnan(P)
        assert int(lost[-1].sum()) >= 10
        if layout == "new_q":  # pdiff finite in the row an orbit is lost in
            assert torch.equal(torch.isnan(D[1:]), lost[:-1])
        else:
            assert torch.equal(torch.isnan(D), lost)


@pytest.mark.parametrize("layout", ["two_maps", "new_q"])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_float32_within_3x_plain(cuda, name, layout):
    pm, (q0, p0), kw = _case(name, layout, cuda, torch.float32)
    got = cs.rollout_in_kernel(pm, q0, p0, NM, **kw)
    torch.cuda.synchronize()
    ref = cs.rollout_reference(pm, q0, p0, NM, **kw)
    r = rc.f32_vs_f64(pm, q0, p0, kw, got, ref)
    assert r["err_kernel"] <= r["err_bound"], r
    assert r["residual_kernel"] <= r["residual_bound"], r
    if name != "boundary":  # no orbit near the loss boundary
        assert r["nan_pattern_equal"], r


def _first_twice(pm):
    """A wrong Split model on purpose: sub-map 0 in both places."""
    cols = {f: torch.cat([getattr(pm, f).reshape(pm.n_maps, -1)[0]] * 2)
            for f in rc.COLUMNS if f != "scal"}
    return dataclasses.replace(pm, **cols, scal=pm.scal[[0, 0]], n_maps=2)


def _copies(pm, n):
    """A one-map model's columns ``n`` times: a Split model of copies."""
    cols = {f: torch.cat([getattr(pm, f)] * n)
            for f in rc.COLUMNS if f != "scal"}
    return dataclasses.replace(pm, **cols, scal=pm.scal[[0] * n], n_maps=n)


@pytest.mark.parametrize("name", list(CASES))
def test_wrong_kernels_fail_the_gates(cuda, name):
    """Sub-map 0 on every step (the kernel run on sub-map 0 twice) fails
    the float64 and float32 gates; pdiff taken after the new q's NaN (the
    boundary case: NaN in the row an orbit is lost in) fails float64's."""
    pm, (q0, p0), kw = _case(name, "two_maps", cuda)
    ref = cs.rollout_reference(pm, q0, p0, NM, **kw)
    assert rc.step_err(_kernel(), _first_twice(pm), ref, kw) > ATOL_F64_STEP
    pm32, (q, p), _ = _case(name, "two_maps", cuda, torch.float32)
    ref32 = cs.rollout_reference(pm32, q, p, NM, **kw)
    r = rc.f32_vs_f64(pm32, q, p, kw, ref32, ref32)
    wrong32 = cs.rollout_in_kernel(_first_twice(pm32), q, p, NM, **kw)
    assert r["err"](wrong32) > r["err_bound"]
    if name == "boundary":
        kw_new = dict(kw, loss_at_new_q=True)
        got = cs.rollout_in_kernel(pm, q0, p0, NM, **kw_new)
        ref = cs.rollout_reference(pm, q0, p0, NM, **kw_new)
        late = torch.where(torch.isnan(ref[1]), torch.nan, ref[2])
        assert not torch.equal(late.isnan(), ref[2].isnan())
        assert rc.max_abs_diff(got[2], late) > ATOL_F64_STEP
        assert rc.step_err(_kernel(), pm, ref, kw_new) <= ATOL_F64_STEP


@pytest.mark.parametrize("name", list(CASES))
def test_copies_through_split_instance_equal_one_map_instance(cuda, name):
    """Three copies of sub-map 0, cycled by the Split instance and checked
    at the old q, against the one-map instance of the same mode: equal
    within 1e-12 over every row (float64)."""
    pm, (q0, p0), kw = _case(name, "new_q", cuda)
    kw = dict(kw, loss_at_new_q=False)
    three = _copies(pm, 3)
    assert cs._library(three, False, kw.get("explicit", False), True) \
        == "rollout_split_modes"
    assert cs._library(pm, False, kw.get("explicit", False), True) \
        == "rollout_step"
    a = cs.rollout_in_kernel(pm, q0, p0, NM, **kw)
    b = cs.rollout_in_kernel(three, q0, p0, NM, **kw)
    for x, y in zip(a, b):
        assert rc.max_abs_diff(x, y) <= ATOL_F64_STEP
