"""PyTorch port vs JAX: the triangular products and the blocked inverse
(``ops/cuda_trimm.py``, ``ops/cuda_syrk.py``, ``linalg/triangular.py``);
and the alpha product ``ops/cuda_matvec.py``, which JAX lacks, against
``torch.cholesky_solve``.

JAX runs its Pallas kernels in interpret mode on the CPU with the calls of
``tests/test_fast_grad.py`` (tile 128, ``precision="highest"``); the port
runs the kernels' plain versions (CPU tensors), float64.  Everything at
1e-10 absolute, as the JAX tests, on well-conditioned inputs.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity import npy, tt  # noqa: E402

from sympgpr_tpu.linalg import triangular as jtri  # noqa: E402
from sympgpr_tpu.ops.pallas_syrk import syrk_lower as jsyrk  # noqa: E402
from sympgpr_tpu.ops.pallas_trimm import (  # noqa: E402
    matmul_tril_left as jleft, matmul_tril_right as jright)
from sympgpr_tpu_torch.linalg import triangular  # noqa: E402
from sympgpr_tpu_torch.linalg.triangular import (  # noqa: E402
    spd_inverse_from_chol, tri_inv_blocked)
from sympgpr_tpu_torch.ops import (  # noqa: E402
    cuda_matvec, cuda_syrk, cuda_trimm)


def _tril_case(n, seed):
    rng = np.random.default_rng(seed)
    return np.tril(rng.standard_normal((n, n))) + n * np.eye(n)


@pytest.mark.parametrize("n", [1, 64, 129, 200, 256, 300])
def test_syrk_lower(n):
    rng = np.random.default_rng(n)
    W = np.tril(rng.standard_normal((n, n)))
    S = npy(cuda_syrk.syrk_lower(tt(W)))
    np.testing.assert_allclose(S, W.T @ W, atol=1e-10)
    np.testing.assert_allclose(S, np.asarray(jsyrk(jnp.asarray(W), tile=128)),
                               atol=1e-10)


@pytest.mark.parametrize("right", [True, False])
def test_trimm_matches_jax_and_dense(right):
    rng = np.random.default_rng(3)
    nb, s = 2, 256
    A = rng.standard_normal((nb, s, s))
    Lt = np.tril(rng.standard_normal((nb, s, s)))
    if right:
        got = cuda_trimm.matmul_tril_right(tt(A), tt(Lt))
        ref = jright(jnp.asarray(A), jnp.asarray(Lt), tile=128,
                     precision="highest")
        dense = A @ Lt
    else:
        got = cuda_trimm.matmul_tril_left(tt(Lt), tt(A))
        ref = jleft(jnp.asarray(Lt), jnp.asarray(A), tile=128,
                    precision="highest")
        dense = Lt @ A
    np.testing.assert_allclose(npy(got), np.asarray(ref), atol=1e-10)
    np.testing.assert_allclose(npy(got), dense, atol=1e-10)


@pytest.mark.parametrize("right", [True, False])
def test_trimm_ignores_upper_garbage(right):
    """The whole strict upper triangle of L is NaN, the in-tile part
    included (stronger than the JAX test, which poisons whole tiles)."""
    rng = np.random.default_rng(4)
    s = 128
    A = rng.standard_normal((1, s, s))
    Lt = np.tril(rng.standard_normal((1, s, s)))
    poisoned = Lt + np.triu(np.full((s, s), np.nan), 1)
    if right:
        got = cuda_trimm.matmul_tril_right(tt(A), tt(poisoned))
        dense = A @ Lt
    else:
        got = cuda_trimm.matmul_tril_left(tt(poisoned), tt(A))
        dense = Lt @ A
    np.testing.assert_allclose(npy(got), dense, atol=1e-10)


def _view(t, pad):
    """t as a view with row stride s + pad, starting pad elements into a
    NaN-filled buffer; returns the view and the buffer."""
    nb, s, _ = t.shape
    buf = torch.full((nb * s * (s + pad) + pad,), float("nan"),
                     dtype=t.dtype)
    v = buf.as_strided(t.shape, (s * (s + pad), s + pad, 1), pad)
    return v.copy_(t), buf


@pytest.mark.parametrize("right", [True, False])
def test_trimm_views_out_and_sign(right):
    """Operands and output as strided views inside NaN-filled buffers, and
    sign -1, as the one-buffer inverse passes them: the result is minus
    the JAX product, written into the output view and nowhere else."""
    rng = np.random.default_rng(6)
    nb, s = 3, 128
    A = rng.standard_normal((nb, s, s))
    Lt = np.tril(rng.standard_normal((nb, s, s)))
    a, _ = _view(tt(A), 3)
    lt, _ = _view(tt(Lt + np.triu(np.full((s, s), np.nan), 1)), 5)
    out, buf = _view(torch.zeros((nb, s, s), dtype=torch.float64), 1)
    if right:
        got = cuda_trimm.matmul_tril_right(a, lt, out=out, sign=-1)
        ref = jright(jnp.asarray(A), jnp.asarray(Lt), tile=128,
                     precision="highest")
    else:
        got = cuda_trimm.matmul_tril_left(lt, a, out=out, sign=-1)
        ref = jleft(jnp.asarray(Lt), jnp.asarray(A), tile=128,
                    precision="highest")
    assert got is out
    np.testing.assert_allclose(npy(got), -np.asarray(ref), atol=1e-10)
    inside = torch.zeros(buf.shape, dtype=torch.bool)
    inside.as_strided(out.shape, out.stride(), 1).fill_(True)
    assert torch.isnan(buf[~inside]).all()


def test_trimm_rejects_bad_sign_and_out():
    A = torch.zeros((1, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="sign"):
        cuda_trimm.matmul_tril_right(A, A, sign=2)
    with pytest.raises(ValueError, match="out"):
        cuda_trimm.matmul_tril_left(A, A, out=torch.zeros((1, 8, 9)))


def test_trimm_rejects_ragged_sizes():
    """Operands of unequal or non-square shapes are refused; a size that
    is no multiple of the kernel's tile is a valid size (the kernel masks
    its ragged edge) and gives the dense product."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((1, 100, 100))
    Lt = np.tril(rng.standard_normal((1, 100, 100)))
    np.testing.assert_allclose(
        npy(cuda_trimm.matmul_tril_right(tt(A), tt(Lt))), A @ Lt, atol=1e-10)
    with pytest.raises(ValueError, match="equal"):
        cuda_trimm.matmul_tril_left(tt(A), torch.zeros((1, 128, 128)))
    with pytest.raises(ValueError, match="equal"):
        cuda_trimm.matmul_tril_right(tt(A[:, :64]), tt(A[:, :64]))


@pytest.mark.parametrize("n", [8, 100, 256, 515])
def test_tri_inv_blocked(n, monkeypatch):
    """Base blocks of 64, so n > 64 takes several combine levels."""
    monkeypatch.setattr(triangular, "BASE", 64)
    L = _tril_case(n, n)
    W = npy(tri_inv_blocked(tt(L)))
    np.testing.assert_allclose(W @ L, np.eye(n), atol=1e-10)
    assert np.all(np.triu(W, 1) == 0.0)
    W_j = np.asarray(jtri.tri_inv_blocked(jnp.asarray(L), base=64))
    np.testing.assert_allclose(W, W_j, atol=1e-10)


@pytest.mark.parametrize("n", [256, 515])
def test_tri_inv_blocked_trimm_path(n, monkeypatch):
    """Every combine product goes through the trimm wrappers (base 128:
    levels s = 128, 256, ...); held against JAX with its Pallas trimm
    (interpret)."""
    monkeypatch.setattr(triangular, "BASE", 128)
    calls = []
    right = cuda_trimm.matmul_tril_right

    def counted(*args):
        calls.append(1)
        return right(*args)

    monkeypatch.setattr(cuda_trimm, "matmul_tril_right", counted)
    L = _tril_case(n, n)
    W = npy(tri_inv_blocked(tt(L)))
    assert len(calls) == (1 if n == 256 else 3)  # levels 128 (256 512)
    np.testing.assert_allclose(W @ L, np.eye(n), atol=1e-10)
    W_j = np.asarray(jtri.tri_inv_blocked(
        jnp.asarray(L), base=128, precision="highest", trimm=True,
        trimm_tile=128))
    np.testing.assert_allclose(W, W_j, atol=1e-10)


@pytest.mark.parametrize("n", [515, 1100])
def test_tri_inv_blocked_one_buffer(n, monkeypatch):
    """Base 128 (levels 128 up to m / 2 of the padded size m = 1024 or
    2048): each level's products get strided views, B of the padded L, Wa
    and Wc of the result's own buffer, and the second writes -Wc (B Wa)
    straight into that buffer (sign -1).  Held against JAX with its Pallas
    trimm (interpret) at 1e-10."""
    monkeypatch.setattr(triangular, "BASE", 128)
    calls = []
    for name in ("matmul_tril_right", "matmul_tril_left"):
        def record(*args, fn=getattr(cuda_trimm, name), name=name, **kw):
            calls.append((name, args, kw))
            return fn(*args, **kw)
        monkeypatch.setattr(cuda_trimm, name, record)
    L = _tril_case(n, n)
    W = tri_inv_blocked(tt(L))
    m = 1 << (n - 1).bit_length()
    buf = W.untyped_storage().data_ptr()
    levels = (m // 128).bit_length() - 1  # s = 128, 256, ..., m / 2
    assert [c[0] for c in calls] == ["matmul_tril_right",
                                     "matmul_tril_left"] * levels
    for name, args, kw in calls:
        if name == "matmul_tril_right":
            B, Wa = args
            assert B.stride()[1:] == (m, 1) and Wa.stride()[1:] == (m, 1)
            assert Wa.untyped_storage().data_ptr() == buf
        else:
            Wc, _ = args
            assert kw["sign"] == -1
            for view in (Wc, kw["out"]):
                assert view.untyped_storage().data_ptr() == buf
    W = npy(W)
    assert np.all(np.triu(W, 1) == 0.0)
    np.testing.assert_allclose(W @ L, np.eye(n), atol=1e-10)
    W_j = np.asarray(jtri.tri_inv_blocked(
        jnp.asarray(L), base=128, precision="highest", trimm=True,
        trimm_tile=128))
    np.testing.assert_allclose(W, W_j, atol=1e-10)


def test_spd_inverse_from_chol(monkeypatch):
    """Base 32: the combine level s = 32 is no multiple of the trimm
    kernel's 64-wide tile and goes through the wrappers all the same."""
    monkeypatch.setattr(triangular, "BASE", 32)
    rng = np.random.default_rng(0)
    n = 96
    A = rng.standard_normal((n, n))
    Ky = A @ A.T + n * np.eye(n)
    L = np.linalg.cholesky(Ky)
    Kyinv = npy(spd_inverse_from_chol(tt(L)))
    np.testing.assert_allclose(Kyinv @ Ky, np.eye(n), atol=1e-9)
    Kyinv_j = np.asarray(jtri.spd_inverse_from_chol(jnp.asarray(L), base=32))
    np.testing.assert_allclose(Kyinv, Kyinv_j, atol=1e-10)


def test_spd_inverse_from_chol_default_base():
    """At the shipped base (512) a 515-point factor takes one combine
    level, held against JAX at its default base."""
    rng = np.random.default_rng(1)
    n = 515
    A = rng.standard_normal((n, n))
    Ky = A @ A.T + n * np.eye(n)
    L = np.linalg.cholesky(Ky)
    Kyinv = npy(spd_inverse_from_chol(tt(L)))
    np.testing.assert_allclose(Kyinv @ Ky, np.eye(n), atol=1e-9)
    Kyinv_j = np.asarray(jtri.spd_inverse_from_chol(jnp.asarray(L)))
    np.testing.assert_allclose(Kyinv, Kyinv_j, atol=1e-10)


def test_wrappers_refuse_other_devices():
    A = torch.zeros((1, 64, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_trimm.matmul_tril_right(A, A)
    with pytest.raises(ValueError, match="device"):
        cuda_syrk.syrk_lower(A[0])


@pytest.mark.parametrize("n", [1, 33, 300])
def test_matvec_plain_is_the_cholesky_solve(n):
    """alpha = S z from S = Ky^{-1} (the blocked inverse and the syrk)
    equals the two triangular solves with the factor, float64, on a
    well-conditioned SPD Ky."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    Ky = tt(A @ A.T + n * np.eye(n))
    z = tt(rng.standard_normal(n))
    L = torch.linalg.cholesky(Ky)
    before = cuda_matvec.LAUNCHES
    alpha = cuda_matvec.matvec(spd_inverse_from_chol(L), z)
    assert cuda_matvec.LAUNCHES == before  # CPU tensors: no kernel
    assert alpha.dtype == torch.float64 and alpha.shape == (n,)
    np.testing.assert_allclose(
        npy(alpha), npy(torch.cholesky_solve(z[:, None], L)[:, 0]),
        atol=1e-10)


def test_matvec_plain_sums_in_float64():
    """float32 in, float32 out, summed in float64: the float64 sum
    rounded once."""
    rng = np.random.default_rng(2)
    S = torch.tensor(rng.standard_normal((64, 64)), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal(64), dtype=torch.float32)
    y = cuda_matvec.matvec(S, x)
    assert y.dtype == torch.float32
    assert torch.equal(y, (S.double() @ x.double()).float())


def test_matvec_refuses_bad_operands():
    S = torch.zeros((8, 8), dtype=torch.float64)
    x = torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="square"):
        cuda_matvec.matvec(S[:, :4], x)
    with pytest.raises(ValueError, match="square"):
        cuda_matvec.matvec(S[:0, :0], x[:0])
    with pytest.raises(ValueError, match="shape"):
        cuda_matvec.matvec(S, x[:4])
    with pytest.raises(ValueError, match="float32"):
        cuda_matvec.matvec(S, x.float())
    with pytest.raises(ValueError, match="device"):
        cuda_matvec.matvec(S.to("meta"), x.to("meta"))
