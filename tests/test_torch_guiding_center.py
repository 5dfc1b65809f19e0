"""``systems/guiding_center.py`` of the port against the JAX package's, on
the cases of ``tests/test_guiding_center.py`` (its points, its golden
transcription of the reference's derivative chains, its Newton case), in
float64."""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy, t64  # noqa: E402

from sympgpr_tpu.systems import guiding_center as jgc  # noqa: E402
from sympgpr_tpu_torch.systems import guiding_center as gc  # noqa: E402

import test_guiding_center as golden  # noqa: E402

RTOL = 1e-12  # port against JAX
NAMES = ["H", "pth", "vpar", "dHdx", "dHdpph", "dpthdx", "dpthdpph",
         "dvpardx", "dvpardpph", "d2pthdx2", "d2pthdpphdz", "d2Hdx2",
         "d2Hdpphdz", "d2vpardx2", "d2vpardpphdz"]


def _close(got, want, name=""):
    np.testing.assert_allclose(npy(got), np.asarray(want), rtol=RTOL,
                               atol=1e-18, err_msg=name)


def test_constants_are_jax():
    assert (gc.B0, gc.IOTA0, gc.A_MINOR, gc.R0, gc.TAUB) == (
        jgc.B0, jgc.IOTA0, jgc.A_MINOR, jgc.R0, jgc.TAUB)
    assert gc.GCParams() == gc.GCParams(**vars(jgc.GCParams()))


def test_field_and_pph_are_jax():
    zs = golden._points()
    for z in zs:
        for name, a, b in zip(gc.FieldVals._fields,
                              gc.field_eval(*t64(z[:3])),
                              jgc.field_eval(*z[:3])):
            _close(a, b, name)
    r, th, ph = (t64(zs[:, i]) for i in range(3))
    vpar0 = t64(np.linspace(-0.01, 0.01, len(zs)))
    _close(gc.pph_from_ics(r, th, ph, vpar0),
           jgc.pph_from_ics(zs[:, 0], zs[:, 1], zs[:, 2], npy(vpar0)))


def test_get_der2_is_jax_and_the_golden_spec():
    for z in golden._points(4):
        got = gc.get_der2(t64(z))
        for name, a, b in zip(NAMES, got, jgc.get_der2(z)):
            _close(a, b, name)
        ref = golden._ref_der2(z)
        for name, a in zip(NAMES, got):
            want = ref[name]
            if name == "d2Hdpphdz":
                # the reference leaves [3] unassigned; the true value
                np.testing.assert_allclose(
                    float(a[3]), 1.0 / (golden.M * ref["hph"] ** 2),
                    rtol=1e-12)
                a, want = a[:3], want[:3]
            np.testing.assert_allclose(npy(a), want, rtol=1e-9, atol=1e-18,
                                       err_msg=name)


def test_get_val_and_get_der_are_jax():
    for z in golden._points():
        for name, a, b in zip(NAMES, gc.get_val(t64(z)), jgc.get_val(z)):
            _close(a, b, name)
        for name, a, b in zip(NAMES, gc.get_der(t64(z)), jgc.get_der(z)):
            _close(a, b, name)


@pytest.mark.parametrize("fn", ["get_val", "get_der", "get_der2"])
def test_batched_are_jax(fn):
    zs = golden._points(6)
    got = getattr(gc, f"{fn}_batch")(t64(zs))
    want = getattr(jgc, f"{fn}_batch")(zs, jgc.GCParams())
    assert len(got) == len(want)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, name)
    for i, z in enumerate(zs):  # and the one-point version
        for a, b in zip(getattr(gc, fn)(t64(z)), got):
            np.testing.assert_allclose(npy(a), npy(b[i]), rtol=1e-14,
                                       atol=1e-18)


def test_pph_roundtrip_and_timesteps():
    r, th, ph, vpar0 = 0.1, 1.5, 0.0, 0.37
    pph0 = gc.pph_from_ics(r, th, ph, vpar0)
    _close(pph0, jgc.pph_from_ics(r, th, ph, vpar0))
    _, _, vpar = gc.get_val(torch.stack([t64(r), t64(th), t64(ph), pph0]))
    np.testing.assert_allclose(float(vpar), vpar0, rtol=1e-13)
    assert gc.timesteps(100, 3) == jgc.timesteps(100, 3) == (78.0, 300)


def test_newton_scalar_is_jax():
    """Batched cubic x^3 = a with per-lane targets, one lane starting at 0
    (the additive seeding of the previous iterate keeps it moving)."""
    a = np.array([8.0, 27.0, 0.001, 5.0, 2.0])
    x0 = np.array([2.5, 2.5, 2.5, 2.5, 0.0])

    def fdf(x, a):
        return x**3 - a, 3 * x**2 + 1e-3

    x = gc.newton_scalar(fdf, t64(x0), rtol=1e-14, atol=1e-14,
                         args=(t64(a),))
    xj = jgc.newton_scalar(fdf, x0, rtol=1e-14, atol=1e-14, args=(a,))
    _close(x, xj)
    np.testing.assert_allclose(npy(x), np.cbrt(a), rtol=1e-3)
    x = gc.newton_scalar(lambda x, a: (x**3 - a, 3 * x**2), t64(x0[:4]),
                         rtol=1e-14, atol=1e-14, args=(t64(a[:4]),))
    np.testing.assert_allclose(npy(x), np.cbrt(a[:4]), rtol=1e-12)
