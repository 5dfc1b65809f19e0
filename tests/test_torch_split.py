"""PyTorch port vs JAX: the Split tokamak (``nphmap`` sub-maps of a
fraction of a turn each, fitted with CMA-ES) and the pieces it runs.

* ``minimize_cmaes``: the port copies the JAX strategy line for line with
  the same ``np.random.default_rng(seed)`` stream, so the two searches draw
  the same members and follow the same path while their objective values
  agree.  On Rosenbrock the values agree to rounding, and the results to
  1e-12; on GP likelihoods they agree to ~1e-13 and the two searches
  end within 1e-6 relative of each other (near-ties in the last
  generations, where the stop test looks at 1e-11 changes), so the fitted
  hyperparameters are held at rtol 1e-4, as the L-BFGS fits of
  ``test_torch_likelihood.py``.
* packing of several sub-maps for the rollout kernel: float32 columns and
  ``scal`` bit-equal to the JAX package's;
* the kernel's plain version with Split cycling and the loss check at the
  new q against the Pallas kernel in interpret mode (the cases of
  ``tests/test_pallas_step.py``), float32 at 1e-4;
* ``apply_map_split`` in float64 at 1e-10;
* the Split tokamak's training data at 1e-12.

The workload itself, in both backends against the JAX run:
``test_torch_split_workload.py``.
"""

import functools

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import CPU, jax_models_to_port, npy, t64, tt  # noqa: E402

from sympgpr_tpu.gp import train as jtrain  # noqa: E402
from sympgpr_tpu.gp.model import AuxGP, SympGP  # noqa: E402
from sympgpr_tpu.kernels import PER_SE  # noqa: E402
from sympgpr_tpu.maps import symplectic as jsm  # noqa: E402
from sympgpr_tpu.ops import pallas_step as ps  # noqa: E402
from sympgpr_tpu.systems import tokamak as jtk  # noqa: E402
from sympgpr_tpu.workloads import tokamak as jwl  # noqa: E402
from sympgpr_tpu_torch.gp import train as ttrain  # noqa: E402
from sympgpr_tpu_torch.kernels import PER_SE as T_PER_SE  # noqa: E402
from sympgpr_tpu_torch.maps import symplectic as tsm  # noqa: E402
from sympgpr_tpu_torch.ops import cuda_step as cs  # noqa: E402
from sympgpr_tpu_torch.profiling import launch_counts  # noqa: E402
from sympgpr_tpu_torch.systems import tokamak as ttk  # noqa: E402
from sympgpr_tpu_torch.workloads import tokamak as twl  # noqa: E402

# a small Split configuration: the JAX tokamak_split's shapes, fewer points
SPLIT = dict(N=24, nphmap=4, nph=32, r_scale=0.38, qminmap=0.16,
             qmaxmap=0.31)


def rosenbrock(x):
    return (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def test_cmaes_rosenbrock_matches_jax():
    """tests/test_train.py::test_cmaes_rosenbrock on both packages: the
    same draws and the same objective values give the same search."""
    kw = dict(sigma0=0.5, maxiter=400, seed=0)
    rj = jtrain.minimize_cmaes(rosenbrock, [-1.0, 1.0], **kw)
    rt = ttrain.minimize_cmaes(rosenbrock, [-1.0, 1.0], device=CPU, **kw)
    np.testing.assert_allclose(rt.theta, [1.0, 1.0], atol=2e-2)
    assert rt.fun < 1e-3
    assert rt.nfev == rj.nfev
    np.testing.assert_allclose(rt.theta, rj.theta, rtol=1e-12)
    # fun ~ 2e-10: the two evaluations round apart in its last digits
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=0, atol=1e-18)


def test_cmaes_restarts_match_jax():
    """IPOP restarts (population doubled) from the same stream."""
    kw = dict(maxiter=60, seed=1, restarts=1)
    rj = jtrain.minimize_cmaes(rosenbrock, [-1.0, 1.0], **kw)
    rt = ttrain.minimize_cmaes(rosenbrock, [-1.0, 1.0], device=CPU, **kw)
    assert rt.nfev == rj.nfev
    np.testing.assert_allclose(rt.theta, rj.theta, rtol=1e-12)


def test_fit_auxgp_cmaes_matches_jax():
    """tests/test_train.py::test_fit_auxgp_cmaes_path on both packages."""
    rng = np.random.default_rng(1)
    n = 12
    q = rng.uniform(0, 2 * np.pi, n)
    p = rng.uniform(-1, 1, n)
    X = np.stack([q, p], 1)
    z = 0.5 * np.sin(q) * p
    kw = dict(sig2n=1e-8, x0=(-0.5, 0.0, 0.0), optimizer="cmaes",
              maxiter=60, seed=0)
    aux_j, res_j = jtrain.fit_auxgp(PER_SE, jnp.asarray(X), jnp.asarray(z),
                                    **kw)
    aux_t, res_t = ttrain.fit_auxgp(T_PER_SE, t64(X), t64(z), **kw)
    assert res_t.success and res_t.message == "cma-es"
    np.testing.assert_allclose(npy(aux_t.params), np.asarray(aux_j.params),
                               rtol=1e-4)
    np.testing.assert_allclose(float(aux_t.sig), float(aux_j.sig), rtol=1e-4)
    np.testing.assert_allclose(res_t.fun, res_j.fun, rtol=1e-8)
    from sympgpr_tpu_torch.gp.covariance import build_Kreg

    K = build_Kreg(T_PER_SE, aux_t.X, aux_t.X, aux_t.params, aux_t.sig)
    assert float(torch.mean((K @ aux_t.alpha - t64(z)) ** 2)) < 1e-3


def test_fit_sympgp_takes_cmaes_and_refuses_adam():
    """CMA-ES as JAX's; Adam, refused until it was ported, is now taken
    as JAX's too, and a name outside the minimizers is refused."""
    rng = np.random.default_rng(2)
    q, P = rng.uniform(0, 2 * np.pi, 8), rng.uniform(-1, 1, 8)
    X = np.stack([q, P], 1)
    z = np.concatenate([0.1 * np.sin(q) * P, 0.1 * np.cos(q)])
    kw = dict(sig2n=1e-8, x0=(0.5, 2.5, 2.0), transform="linear",
              optimizer="cmaes", maxiter=15, seed=0)
    sj, rj = jtrain.fit_sympgp(PER_SE, jnp.asarray(X), jnp.asarray(z), **kw)
    st, rt = ttrain.fit_sympgp(T_PER_SE, t64(X), t64(z), **kw)
    np.testing.assert_allclose(npy(st.params), np.asarray(sj.params),
                               rtol=1e-6)
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=1e-10)
    kw = dict(sig2n=1e-8, x0=(0.0, 0.0, 0.0), optimizer="adam", steps=20)
    sj, rj = jtrain.fit_sympgp(PER_SE, jnp.asarray(X), jnp.asarray(z), **kw)
    st, rt = ttrain.fit_sympgp(T_PER_SE, t64(X), t64(z), **kw)
    np.testing.assert_allclose(rt.theta, np.asarray(rj.theta), rtol=1e-8)
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=1e-8)
    with pytest.raises(NotImplementedError, match="sgd"):
        ttrain.fit_sympgp(T_PER_SE, t64(X), t64(z), sig2n=1e-8,
                          x0=(0.0, 0.0, 0.0), optimizer="sgd")


def f32_models(n, seed):
    """The float32 toys of tests/test_pallas_step.py (f32_models)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(-1, 1, n)
    X = jnp.asarray(np.stack([q, P], 1), jnp.float32)
    z = jnp.asarray(np.concatenate([0.1 * np.sin(q) * P,
                                    0.1 * np.cos(q) + 0.05 * P]), jnp.float32)
    params = jnp.asarray([0.9, 1.2], jnp.float32)
    sgp = SympGP.create(PER_SE, params, 1.5, 1e-2, X, z)
    p = rng.uniform(-1, 1, n)
    Xp = jnp.asarray(np.stack([q, p], 1), jnp.float32)
    zp = jnp.asarray(0.1 * np.sin(q) * p, jnp.float32)
    aux = AuxGP.create(PER_SE, params, 1.5, 1e-2, Xp, zp, delta=True)
    return sgp, aux


@functools.cache
def split_pair():
    """Two sub-maps that differ, of 20 and 12 points (the JAX package's
    test_rollout_split_cycles_submaps)."""
    (s0, a0), (s1, a1) = f32_models(20, 10), f32_models(12, 11)
    t0, u0 = jax_models_to_port(s0, a0)
    t1, u1 = jax_models_to_port(s1, a1)
    return [s0, s1], [a0, a1], [t0, t1], [u0, u1]


def ics(seed, b=128):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 2 * np.pi, b).astype(np.float32),
            rng.uniform(-0.5, 0.5, b).astype(np.float32))


def test_pack_models_split_matches_jax():
    sj, aj, st, at = split_pair()
    pj = ps.pack_models_split(sj, aj, mod_q=2 * np.pi)
    pt = cs.pack_models_split(st, at, mod_q=2 * np.pi)
    assert (pt.n_maps, pt.ns, pt.nas, pt.kind, pt.aux_kind) == (
        pj.n_maps, pj.ns, pj.nas, pj.kind, pj.aux_kind) == (2, 24, 24, 0, 0)
    for f in ("uq", "uP", "a0", "a1", "auxq", "auxp", "auxa"):
        a, b = npy(getattr(pt, f)), np.asarray(getattr(pj, f))[:, 0]
        assert a.dtype == np.float32 and a.shape == (48,)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(npy(pt.scal), np.asarray(pj.scal))
    # one map: pack_models is pack_models_split of one
    one = cs.pack_models(st[0], at[0], mod_q=2 * np.pi)
    assert one.n_maps == 1 and one.scal.shape == (1, cs.NSCAL)
    np.testing.assert_array_equal(npy(one.a0), npy(pt.a0)[:24])


def test_pack_models_split_refuses_mixed_models():
    _, _, st, at = split_pair()
    with pytest.raises(ValueError, match="one aux"):
        cs.pack_models_split(st, at[:1], mod_q=None)
    with pytest.raises(ValueError, match="delta"):
        cs.pack_models_split(st, [at[0], None], mod_q=None)


def test_reference_split_cycles_like_pallas():
    """Split cycling: the plain version and the Pallas kernel over four
    steps with two sub-maps that differ; float32 at 1e-4.  Sub-map 0 alone
    is far outside that: the phase of the cycling shows."""
    sj, aj, st, at = split_pair()
    q0, p0 = ics(10)
    nm = 5
    Qj, Pj = ps.rollout_in_kernel(ps.pack_models_split(sj, aj, 2 * np.pi),
                                  jnp.asarray(q0), jnp.asarray(p0), nm,
                                  interpret=True)
    pt = cs.pack_models_split(st, at, mod_q=2 * np.pi)
    Qt, Pt = cs.rollout_reference(pt, tt(q0, torch.float32),
                                  tt(p0, torch.float32), nm)
    assert Qt.shape == (nm, 128) and Qt.dtype == torch.float32
    for i in range(1, nm):
        np.testing.assert_allclose(npy(Pt[i]), np.asarray(Pj[i]), atol=1e-4)
        np.testing.assert_allclose(npy(Qt[i]), np.asarray(Qj[i]), atol=1e-4)
    first = cs.pack_models_split([st[0], st[0]], [at[0], at[0]],
                                 mod_q=2 * np.pi)
    Qf, Pf = cs.rollout_reference(first, tt(q0, torch.float32),
                                  tt(p0, torch.float32), nm)
    assert float((Pf[2:] - Pt[2:]).abs().max()) > 1e-2


def test_reference_loss_at_new_q_like_pallas():
    """The loss check at the new q (the loss_at_new_q part of
    test_rollout_in_kernel_loss_check_poisons): orbits with P < 0 are
    poisoned at step 1 and stay NaN; with one map and with two."""
    sj, aj, st, at = split_pair()
    q0, _ = ics(3)
    p0 = np.full(128, -0.5, np.float32)
    for pj, pt in ((ps.pack_models(sj[0], aj[0], mod_q=2 * np.pi),
                    cs.pack_models(st[0], at[0], mod_q=2 * np.pi)),
                   (ps.pack_models_split(sj, aj, mod_q=2 * np.pi),
                    cs.pack_models_split(st, at, mod_q=2 * np.pi))):
        Qj, Pj = ps.rollout_in_kernel(pj, jnp.asarray(q0), jnp.asarray(p0),
                                      3, loss_check=True, loss_at_new_q=True,
                                      interpret=True)
        Qt, Pt = cs.rollout_in_kernel(pt, tt(q0, torch.float32),
                                      tt(p0, torch.float32), 3,
                                      loss_check=True, loss_at_new_q=True)
        assert torch.isnan(Pt[1:]).all() and torch.isnan(Qt[1:]).all()
        np.testing.assert_array_equal(npy(torch.isnan(Pt)),
                                      np.isnan(np.asarray(Pj)))
        np.testing.assert_array_equal(npy(torch.isnan(Qt)),
                                      np.isnan(np.asarray(Qj)))


def shift_models(n, seed, shift):
    """float32 toys near the tokamak's loss boundary: P in [10, 14] (r =
    0.5 at cos q = 0.12 for P = 12), and a map that turns q by ~``shift``
    a step while P moves little."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(10, 14, n)
    X = jnp.asarray(np.stack([q, P], 1), jnp.float32)
    z = jnp.asarray(np.concatenate([0.01 * np.sin(q),
                                    shift + 0.1 * np.cos(q)]), jnp.float32)
    params = jnp.asarray([0.9, 1.2], jnp.float32)
    sgp = SympGP.create(PER_SE, params, 1.5, 1e-2, X, z)
    Xp = jnp.asarray(np.stack([q, P], 1), jnp.float32)
    aux = AuxGP.create(PER_SE, params, 1.5, 1e-2, Xp,
                       jnp.zeros(n, jnp.float32), delta=True)
    return sgp, aux


def test_reference_loss_at_new_q_differs_from_old_q():
    """On the tokamak's loss boundary r = 0.5 the check at the new q and
    the one at the old q flag other orbits at other steps: the plain
    version follows the Pallas kernel in both modes (float32, NaN patterns
    equal, values at 1e-4 at steps 1-2)."""
    (s0, a0), (s1, a1) = shift_models(24, 0, 1.0), shift_models(16, 1, 0.5)
    pj = ps.pack_models_split([s0, s1], [a0, a1], mod_q=2 * np.pi)
    pt = cs.pack_models_split(*map(list, zip(jax_models_to_port(s0, a0),
                                             jax_models_to_port(s1, a1))),
                              mod_q=2 * np.pi)
    q0 = np.linspace(0, 2 * np.pi, 128, endpoint=False).astype(np.float32)
    p0 = np.full(128, 12.0, np.float32)
    lost = {}
    for new_q in (False, True):
        Qj, Pj = ps.rollout_in_kernel(pj, jnp.asarray(q0), jnp.asarray(p0),
                                      4, loss_check=True,
                                      loss_at_new_q=new_q, interpret=True)
        Qt, Pt = cs.rollout_reference(pt, tt(q0, torch.float32),
                                      tt(p0, torch.float32), 4,
                                      loss_check=True, loss_at_new_q=new_q)
        lost[new_q] = npy(torch.isnan(Pt))
        np.testing.assert_array_equal(lost[new_q], np.isnan(np.asarray(Pj)))
        for i in (1, 2):
            np.testing.assert_allclose(npy(Pt[i]), np.asarray(Pj[i]),
                                       atol=1e-4)
            np.testing.assert_allclose(npy(Qt[i]), np.asarray(Qj[i]),
                                       atol=1e-4)
    assert 0 < lost[True][1].sum() < 128
    assert (lost[True][1] != lost[False][1]).any()


def toy_models(n=6, seed=0):
    """float64 toys of tests/test_maps.py (toy_models)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 2 * np.pi, n)
    P = rng.uniform(-1, 1, n)
    X = jnp.asarray(np.stack([q, P], 1))
    z = jnp.asarray(rng.normal(size=2 * n) * 0.1)
    sgp = SympGP.create(PER_SE, jnp.array([1.0, 1.0]), 1.0, 1e-10, X, z)
    Xp = jnp.asarray(np.stack([q, rng.uniform(-1, 1, n)], 1))
    zp = jnp.asarray(rng.normal(size=n) * 0.1)
    aux = AuxGP.create(PER_SE, jnp.array([1.0, 1.0]), 1.0, 1e-10, Xp, zp,
                       delta=True)
    return sgp, aux


def test_apply_map_split_matches_jax():
    """float64, two sub-maps of tests/test_maps.py's sizes, the Split
    loss check after each step (some orbits lost): 1e-10.  Step 0 is
    sub-map 0 alone."""
    (m1, a1), (m2, a2) = toy_models(seed=0), toy_models(seed=1)
    rng = np.random.default_rng(4)
    q0, p0 = rng.uniform(0, 2 * np.pi, 16), rng.uniform(-0.2, 0.6, 16)
    jcfg, tcfg = jtk.TokamakConfig(nphmap=2), ttk.TokamakConfig(nphmap=2)
    ref = jsm.apply_map_split(
        jsm.stack_models([m1, m2]), jsm.stack_models([a1, a2]),
        jnp.asarray(q0), jnp.asarray(p0), nm=5, n_maps=2,
        loss_post=jwl.make_loss_fn(jcfg, use_new_q=True))
    (t1, u1), (t2, u2) = jax_models_to_port(m1, a1), jax_models_to_port(m2,
                                                                         a2)
    got = tsm.apply_map_split(tsm.stack_models([t1, t2]),
                              tsm.stack_models([u1, u2]), t64(q0), t64(p0),
                              nm=5, n_maps=2,
                              loss_post=twl.make_loss_fn(tcfg, True))
    assert got.q.shape == (5, 16) and got.q.dtype == torch.float64
    lost = np.isnan(np.asarray(ref.p[-1]))
    assert 0 < lost.sum() < 16
    np.testing.assert_array_equal(npy(torch.isnan(got.p)),
                                  np.isnan(np.asarray(ref.p)))
    np.testing.assert_allclose(npy(got.q), np.asarray(ref.q), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(npy(got.p), np.asarray(ref.p), rtol=1e-10,
                               atol=1e-10)
    one = tsm.apply_map(t1, u1, t64(q0), t64(p0), nm=2,
                        loss_post=twl.make_loss_fn(tcfg, True))
    np.testing.assert_array_equal(npy(got.q[1]), npy(one.q[1]))
    with pytest.raises(ValueError, match="sub-maps"):
        tsm.apply_map_split([t1], [u1, u2], t64(q0), t64(p0), nm=2,
                            n_maps=2)


def test_rollout_model_takes_sub_map_lists():
    """Model level: a list of sub-maps (with a list of aux models, or one
    aux model for all) is conditioned at the deployment jitter, packed and
    rolled out as pack_models_split's columns; CPU tensors launch no
    kernel."""
    (m1, a1), (m2, a2) = toy_models(n=14, seed=2), toy_models(n=9, seed=3)
    st, at = map(list, zip(jax_models_to_port(m1, a1),
                           jax_models_to_port(m2, a2)))
    rng = np.random.default_rng(6)
    q0, p0 = t64(rng.uniform(0, 2 * np.pi, 40)), t64(rng.uniform(0, .5, 40))
    before = launch_counts()["rollout"]
    Qt, Pt = cs.rollout_model(st, at, q0, p0, 5, loss_check=True,
                              loss_at_new_q=True)
    assert launch_counts()["rollout"] == before
    assert Qt.shape == (5, 40) and Qt.dtype == torch.float32
    pm = cs.pack_models_split([s.for_deployment(1e-3) for s in st],
                              [a.for_deployment(1e-3) for a in at],
                              mod_q=2 * np.pi)
    Qr, Pr = cs.rollout_reference(pm, q0.float(), p0.float(), 5,
                                  loss_check=True, loss_at_new_q=True)
    assert torch.equal(Qt.nan_to_num(7.0), Qr.nan_to_num(7.0))
    assert torch.equal(Pt.nan_to_num(7.0), Pr.nan_to_num(7.0))
    Q1, _ = cs.rollout_model(st, at[0], q0, p0, 3)
    pm1 = cs.pack_models_split([s.for_deployment(1e-3) for s in st],
                               [at[0].for_deployment(1e-3)] * 2,
                               mod_q=2 * np.pi)
    assert torch.equal(Q1, cs.rollout_reference(pm1, q0.float(), p0.float(),
                                                3)[0])


def test_training_data_split_matches_jax():
    dj = jtk.training_data(jtk.TokamakConfig(**SPLIT))
    dt = ttk.training_data(ttk.TokamakConfig(**SPLIT), CPU)
    for k in ("q", "p", "Q", "P"):
        assert dt[k].shape == (24, 4)
        np.testing.assert_allclose(npy(dt[k]), dj[k], rtol=1e-12,
                                   atol=1e-12)
