"""PyTorch port vs JAX: the rollout's explicit update, Algorithm 2 and
mod_p / pdiff together with Split cycling (two sub-maps that differ) or
the loss check at the new q (one map), in the kernel's plain version
``rollout_reference`` and through ``rollout_in_kernel`` and
``rollout_model`` on the CPU.

* float32 against the Pallas kernel in interpret mode, packed from the
  same models by both packages' ``pack_models_split``, at the tolerances
  of the one-map mode tests (``test_torch_cuda_step.py``, from
  ``tests/test_pallas_step.py``): the explicit product update 2e-5 at
  steps 1-2, Algorithm 2 5e-5 at steps 1-2, mod_p / pdiff 5e-4 over the
  rows;
* an orbit lost at the new q keeps a finite pdiff in the row it is lost
  in and turns NaN in the next (at the old q: in the same row), as the
  Pallas kernel sums P - p before the check;
* float64 one step from each plain row against JAX's generic
  ``apply_map_split`` under x64 at 1e-12 (Q and P: it returns no pdiff);
* M copies of one model through the Split path equal the one-map path.

The kernel itself on the card: ``test_torch_cuda_split_modes.py``.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import (  # noqa: E402
    boundary_data,
    ics,
    jax_models_to_port,
    npy,
    toy_data,
    tt,
)

from sympgpr_tpu.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu.kernels import variants as jvar  # noqa: E402
from sympgpr_tpu.maps import symplectic as jsm  # noqa: E402
from sympgpr_tpu.ops import pallas_step as ps  # noqa: E402
from sympgpr_tpu.systems.tokamak import TokamakConfig as JTok  # noqa: E402
from sympgpr_tpu.workloads.tokamak import make_loss_fn as jloss  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_step as cs  # noqa: E402

TWO_PI = 2 * np.pi
MOD_P_BOUNDARY = 4 * np.pi  # wraps the boundary models' P > 4 pi to [0, 1.4)
LAYOUTS = ["two_maps", "new_q"]


def toy_models(name, n, seed, dtype=jnp.float32, aux=True, sig2n=1e-2):
    """The toys of tests/test_pallas_step.py (smooth targets; jitter 1e-2
    keeps |alpha| ~ O(1) in float32)."""
    X, z, Xp, zp = toy_data(n, seed)
    k = jvar.get_kernel(name)
    params = jnp.asarray([0.9, 1.2, 0.55][: k.n_params], dtype)
    sgp = SympGP.create(k, params, 1.5, sig2n, jnp.asarray(X, dtype),
                        jnp.asarray(z, dtype))
    if not aux:
        return sgp, None
    return sgp, AuxGP.create(k, params, 1.5, sig2n, jnp.asarray(Xp, dtype),
                             jnp.asarray(zp, dtype), delta=True)


def boundary_models(n, seed, shift, dtype=jnp.float32):
    """per_se toys near r = 0.5 (``boundary_data``), an aux GP of P - p = 0
    on the same points."""
    X, z = boundary_data(n, seed, shift)
    params = jnp.asarray([0.9, 1.2], dtype)
    X = jnp.asarray(X, dtype)
    sgp = SympGP.create(jvar.PER_SE, params, 1.5, 1e-2, X,
                        jnp.asarray(z, dtype))
    aux = AuxGP.create(jvar.PER_SE, params, 1.5, 1e-2, X,
                       jnp.zeros(n, dtype), delta=True)
    return sgp, aux


def packs(pairs, layout, mod_q, mod_p=None, dtype=torch.float32):
    """The JAX and the port's packs of the layout: both sub-maps (Split
    cycling) or the first alone (checked at the new q); the port's models
    through the shared artifact keys."""
    if layout == "new_q":
        pairs = pairs[:1]
    sj, aj = (list(x) for x in zip(*pairs))
    st, at = (list(x) for x in zip(*(jax_models_to_port(s, a)
                                      for s, a in pairs)))
    return (ps.pack_models_split(sj, aj, mod_q=mod_q, mod_p=mod_p),
            cs.pack_models_split(st, at, mod_q=mod_q, mod_p=mod_p,
                                 dtype=dtype))


def both(pj, pt, q0, p0, nm, **kw):
    """The Pallas kernel (interpret mode) and the port's plain version on
    the same float32 ICs."""
    outj = ps.rollout_in_kernel(pj, jnp.asarray(q0, jnp.float32),
                                jnp.asarray(p0, jnp.float32), nm,
                                interpret=True, **kw)
    outt = cs.rollout_reference(pt, tt(q0, torch.float32),
                                tt(p0, torch.float32), nm, **kw)
    assert len(outt) == len(outj) and outt[0].shape == (nm, len(q0))
    return outj, outt


def assert_rows_close(outj, outt, rows, atol):
    for a, b in zip(outt, outj):
        np.testing.assert_array_equal(np.isnan(npy(a)), np.isnan(npy(b)))
        for i in rows:
            np.testing.assert_allclose(npy(a[i]), npy(b[i]), atol=atol)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", ["per_se", "se_se"])
def test_explicit_split_matches_pallas(name, layout):
    """The explicit product update P = p - pGP(q, p) cycling two sub-maps
    (20 and 12 points) or checked at the new q: 2e-5 at steps 1-2."""
    pj, pt = packs([toy_models(name, 20, 10), toy_models(name, 12, 11)],
                   layout, TWO_PI)
    q0, p0 = ics(7)
    kw = dict(explicit=True, loss_check=layout == "new_q",
              loss_at_new_q=layout == "new_q")
    outj, outt = both(pj, pt, q0, p0, 3, **kw)
    assert_rows_close(outj, outt, (1, 2), 2e-5)
    if layout == "two_maps":  # step 2 is sub-map 1's
        first = cs.pack_models_split([cs._models_of(pt, 0)[0]] * 2,
                                     [None] * 2, mod_q=TWO_PI)
        Pf = cs.rollout_reference(first, tt(q0, torch.float32),
                                  tt(p0, torch.float32), 3, **kw)[1]
        assert float((Pf[2] - outt[1][2]).abs().max()) > 1e-3


@pytest.mark.parametrize("layout", LAYOUTS)
def test_algorithm2_split_matches_pallas(layout):
    """sum_per_se (Algorithm 2, no aux model) cycling two sub-maps or
    checked at the new q: 5e-5 at steps 1-2."""
    pj, pt = packs([toy_models("sum_per_se", 20, 4, aux=False),
                    toy_models("sum_per_se", 16, 5, aux=False)],
                   layout, TWO_PI)
    assert pt.kind == 3
    q0, p0 = ics(4)
    outj, outt = both(pj, pt, q0, p0, 3, loss_check=layout == "new_q",
                      loss_at_new_q=layout == "new_q")
    assert_rows_close(outj, outt, (1, 2), 5e-5)


@pytest.mark.parametrize("layout,loss_check", [
    ("two_maps", False), ("two_maps", True), ("new_q", True)])
def test_mod_p_pdiff_split_matches_pallas(layout, loss_check):
    """The implicit map with the mod_p wrap and pdiff (P crossing 0 and
    2 pi) cycling two sub-maps (without and with the loss check at the
    old q) or checked at the new q: 5e-4 over the rows, NaN patterns
    equal."""
    pj, pt = packs([toy_models("per_se", 20, 8), toy_models("per_se", 12, 9)],
                   layout, TWO_PI, TWO_PI)
    q0, p0 = ics(8)
    p0 = p0 * 8 + 3.0
    outj, outt = both(pj, pt, q0, p0, 4, loss_check=loss_check,
                      loss_at_new_q=layout == "new_q", track_pdiff=True)
    Qt, Pt, Dt = outt
    np.testing.assert_array_equal(npy(Dt[0]), np.float32(p0))
    assert np.nanmax(np.abs(npy(Dt) - npy(Pt))) > 6  # some orbits wrapped
    assert np.nanmin(npy(Pt[1:])) >= 0
    # the check at the old q sees P < 0 before the wrap; the one at the new
    # q sees the wrapped P, which these orbits' r never takes past 0.5
    assert np.isnan(npy(Pt)).any() == (loss_check and layout == "two_maps")
    assert_rows_close(outj, outt, range(1, 4), 5e-4)


@pytest.mark.parametrize("new_q", [False, True])
def test_pdiff_of_orbits_lost_at_the_new_q(new_q):
    """Two sub-maps near the loss boundary with mod_p = 4 pi and pdiff: at
    the new q an orbit's pdiff stays finite in the row it is lost in and
    turns NaN in the next; at the old q it is NaN from that row on.  Both
    as the Pallas kernel, 5e-4 over the rows."""
    pairs = [boundary_models(24, 0, 1.0), boundary_models(16, 1, 0.5)]
    pj, pt = packs(pairs, "two_maps", TWO_PI, MOD_P_BOUNDARY)
    q0 = np.linspace(0, TWO_PI, 128, endpoint=False)
    p0 = np.linspace(11.0, 13.5, 128)[np.random.default_rng(0)
                                      .permutation(128)]
    nm = 5
    outj, outt = both(pj, pt, q0, p0, nm, loss_check=True,
                      loss_at_new_q=new_q, track_pdiff=True)
    assert_rows_close(outj, outt, range(1, nm), 5e-4)
    P, D = npy(outt[1]), npy(outt[2])
    lost = np.isnan(P)
    first = np.where(lost.any(0), lost.argmax(0), nm)
    gone = first < nm - 1
    assert gone.sum() >= 5 and (P[1:][~lost[1:]] < 13).any()  # some wrapped
    cols = np.flatnonzero(gone)
    if new_q:
        assert np.isfinite(D[first[cols], cols]).all()
        assert np.isnan(D[first[cols] + 1, cols]).all()
        np.testing.assert_array_equal(np.isnan(D[1:]), lost[:-1])
    else:
        np.testing.assert_array_equal(np.isnan(D), lost)


def f64_pairs(name, mode_aux, n=20):
    """Two float64 sub-maps of one size (JAX's ``stack_models``)."""
    return [toy_models(name, n, 12, jnp.float64, aux=mode_aux, sig2n=1e-4),
            toy_models(name, n, 13, jnp.float64, aux=mode_aux, sig2n=1e-4)]


F64_MODES = {  # mode: kernel, aux model, mod_p, rollout keywords
    "explicit": ("per_se", False, TWO_PI, dict(explicit=True)),
    "sum": ("sum_per_se", False, TWO_PI, {}),
    "implicit_mod_p": ("per_se", True, TWO_PI, dict(track_pdiff=True)),
    "boundary_new_q": ("boundary", True, MOD_P_BOUNDARY,
                       dict(track_pdiff=True, loss_check=True,
                            loss_at_new_q=True)),
}


@pytest.mark.parametrize("mode", list(F64_MODES))
def test_split_modes_float64_match_apply_map_split(mode):
    """float64: one step of JAX's generic ``apply_map_split`` (autodiff
    derivatives, Newton to convergence; the loss at the new q) from each
    row of the port's plain Split trajectory, with the sub-map that made
    the row after it, equals that row at 1e-12 (Q and P)."""
    name, with_aux, mod_p, kw = F64_MODES[mode]
    if name == "boundary":
        pairs = [boundary_models(20, 0, 1.0, jnp.float64),
                 boundary_models(20, 1, 0.5, jnp.float64)]
        q0 = np.linspace(0, TWO_PI, 32, endpoint=False)
        p0 = np.linspace(11.0, 13.5, 32)
    else:
        pairs = f64_pairs(name, with_aux)
        q0, p0 = ics(3, b=32)
        p0 = p0 * 8 + 3.0
    st, at = (list(x) for x in zip(*(jax_models_to_port(s, a)
                                     for s, a in pairs)))
    pt = cs.pack_models_split(st, at, mod_q=TWO_PI, mod_p=mod_p,
                              dtype=torch.float64)
    nm = 7
    Qt, Pt = cs.rollout_reference(pt, tt(q0), tt(p0), nm, iters=8,
                                  **kw)[:2]
    cfg = jsm.MapConfig(explicit=kw.get("explicit", False)
                        or name == "sum_per_se",
                        mod_p=mod_p, newton_tol=1e-15, newton_maxiter=20)
    loss = (jloss(JTok(), use_new_q=True) if kw.get("loss_at_new_q")
            else None)
    sgps, auxes = zip(*pairs)
    for r in range(2):  # rows r, r + 2, ... step by sub-map r
        order = [r, 1 - r]
        rows = slice(r, nm - 1, 2)
        q, p = (npy(t[rows]).reshape(-1) for t in (Qt, Pt))
        ref = jsm.apply_map_split(
            jsm.stack_models([sgps[m] for m in order]),
            None if not with_aux else jsm.stack_models(
                [auxes[m] for m in order]),
            jnp.asarray(q), jnp.asarray(p), 2, 2, cfg, loss_post=loss)
        for got, want in ((Qt, ref.q), (Pt, ref.p)):
            g = npy(got[1:][rows]).reshape(-1)
            np.testing.assert_allclose(g, np.asarray(want[1]), rtol=1e-12,
                                       atol=1e-12)
    if name == "boundary":
        assert np.isnan(npy(Pt[-1])).sum() >= 3  # lost at the new q


@pytest.mark.parametrize("mode", list(F64_MODES))
def test_split_copies_equal_one_map(mode):
    """Three copies of one sub-map through the Split path give the one-map
    path's trajectories, to the bit (float64)."""
    name, with_aux, mod_p, kw = F64_MODES[mode]
    pair = (boundary_models(20, 0, 1.0, jnp.float64) if name == "boundary"
            else f64_pairs(name, with_aux)[0])
    s, a = jax_models_to_port(*pair)
    one = cs.pack_models(s, a, mod_q=TWO_PI, mod_p=mod_p,
                         dtype=torch.float64)
    three = cs.pack_models_split([s] * 3, [a] * 3, mod_q=TWO_PI, mod_p=mod_p,
                                 dtype=torch.float64)
    q0 = np.linspace(0, TWO_PI, 16, endpoint=False)
    p0 = np.linspace(11.0, 13.5, 16) if name == "boundary" else ics(3, 16)[1]
    a1 = cs.rollout_reference(one, tt(q0), tt(p0), 6, **kw)
    a3 = cs.rollout_reference(three, tt(q0), tt(p0), 6, **kw)
    for x, y in zip(a1, a3):
        np.testing.assert_array_equal(npy(x), npy(y))


def test_rollout_entry_points_take_split_modes():
    """``rollout_in_kernel`` (CPU tensors: the plain version, no launch)
    and ``rollout_model`` with a list of sub-maps take the Split modes, as
    JAX's ``rollout_pallas`` does: mod_p / pdiff with two sub-maps,
    deployment jitter 1e-3, float32, 5e-5 at step 1 (and step 2, sub-map
    1's)."""
    X, z, Xp, zp = toy_data(24, seed=6)
    X2, z2, Xp2, zp2 = toy_data(24, seed=7)
    models = []
    for x, y, xp, yp in ((X, z, Xp, zp), (X2, z2, Xp2, zp2)):
        models.append((
            SympGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-8,
                          jnp.asarray(x), jnp.asarray(y)),
            AuxGP.create(jvar.PER_SE, jnp.asarray([0.9, 1.2]), 1.5, 1e-8,
                         jnp.asarray(xp), jnp.asarray(yp), delta=True)))
    sj, aj = (list(x) for x in zip(*models))
    st, at = (list(x) for x in zip(*(jax_models_to_port(s, a)
                                     for s, a in models)))
    q0, p0 = ics(6, b=40)
    kw = dict(mod_q=TWO_PI, mod_p=TWO_PI, track_pdiff=True, iters=8,
              deployment_jitter=1e-3, loss_check=True, loss_at_new_q=True)
    outj = ps.rollout_pallas(sj, aj, jnp.asarray(q0), jnp.asarray(p0), 3,
                             **kw)
    before = cs.LAUNCHES
    outt = cs.rollout_model(st, at, tt(q0), tt(p0), 3, **kw)
    assert cs.LAUNCHES == before
    assert len(outt) == 3 and outt[2].dtype == torch.float32
    for a, b in zip(outt, outj):
        for i in (1, 2):
            np.testing.assert_allclose(npy(a[i]), np.asarray(b[i]),
                                       atol=5e-5)
    pm = cs.pack_models_split([s.for_deployment(1e-3) for s in st],
                              [a.for_deployment(1e-3) for a in at],
                              mod_q=TWO_PI, mod_p=TWO_PI)
    args = (pm, tt(q0, torch.float32), tt(p0, torch.float32), 3)
    kw = dict(iters=8, explicit=True, track_pdiff=True)
    for x, y in zip(cs.rollout_in_kernel(*args, **kw),
                    cs.rollout_reference(*args, **kw)):
        np.testing.assert_array_equal(npy(x), npy(y))
