"""Derivative-observation covariance build and the contraction of its
hyperparameter gradient (PyTorch port of ``sympgpr_tpu/ops/pallas_cov.py``).

Two hand-written CUDA kernels (``csrc/cov_blocks.cu``) replace the Pallas
kernels ``_cov_tile`` and ``_cov_bwd_tile``, each with two entries:

* ``build_K_blocks`` writes the (2N, 2N0) covariance straight into its block
  layout, one exp per pair (two for ``sum_per_se``); ``build_Ky`` runs it on
  X0 = X with a diagonal term (``|sig2n|`` in the fit), so that one launch
  returns Ky;
* ``cov_param_grads`` computes <Kbar, dK/dtheta> for theta = (lx, ly, sig,
  freq) without forming dK.  The Pallas kernel takes the derivatives with
  ``jax.grad`` inside the tile; here they are written out
  (``_pair_terms``), in the plain version and again in the kernel.
  ``cov_param_grads_sym`` is the fit's fused form: it takes S = Ky^{-1} and
  alpha, forms Kbar = (S - alpha alpha^T) / 2 on load and, X0 being X,
  visits half of the pairs (every pair term is even under i <-> j).

``BuildK`` ties the two general entries together as one autograd function.
Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors (or raises).
"""

from __future__ import annotations

import ctypes

import torch

from sympgpr_tpu_torch.kernels import KERNELS, SE_SE, SUM_PER_SE, Kernel
from sympgpr_tpu_torch.ops import _build
from sympgpr_tpu_torch.profiling import count

Tensor = torch.Tensor

TILE = 64  # pair tile of csrc/cov_blocks.cu
NLL_THRESHOLD = 512  # minimum N for the kernel build in the NLL


def nll_threshold() -> int:
    """Minimum number of training points for the kernel build in the NLL."""
    return NLL_THRESHOLD


def want_cuda_build(kernel: Kernel, X: Tensor) -> bool:
    """Dispatch of the NLL covariance build (``want_pallas_build``)."""
    return (kernel.code is not None and X.dtype == torch.float32
            and X.shape[0] >= nll_threshold())


# --- plain versions ----------------------------------------------------------


def _q_side(kind: int, dq: Tensor, lx, f):
    """s, s', s'' of the q-factor A = exp(-s(dq)), and sin/cos of f dq
    for the periodic kinds (None for se_se)."""
    i2 = 0.5 / (lx * lx)
    if kind == SE_SE.code:  # s = dq^2 / (2 lx^2)
        return (dq * dq * i2, 2.0 * dq * i2,
                torch.full_like(dq, 1.0) * (2.0 * i2), None, None)
    # periodic: s = sin^2(f dq) / (2 lx^2); per_se is f = 1/2
    sh = torch.sin(f * dq)
    ch = torch.cos(f * dq)
    sh2 = sh * sh
    return (sh2 * i2, (2.0 * f) * sh * ch * i2,
            (2.0 * f * f) * (1.0 - 2.0 * sh2) * i2, sh, ch)


def tile_blocks(kind: int, dq: Tensor, dP: Tensor, lx, ly, sig, f):
    """(kxx, kxy, kyy) derivative blocks from shared factors
    (``_tile_blocks`` of the JAX package)."""
    s, sp, spp, _, _ = _q_side(kind, dq, lx, f)
    ily2 = 1.0 / (ly * ly)
    t = dP * dP * (0.5 * ily2)
    if kind == SUM_PER_SE.code:  # separable: the mixed block vanishes
        A = sig * torch.exp(-s)
        B = sig * torch.exp(-t)
        return ((spp - sp * sp) * A, torch.zeros_like(dq),
                (ily2 - dP * dP * ily2 * ily2) * B)
    AB = sig * torch.exp(-(s + t))  # one exp for both factors
    return ((spp - sp * sp) * AB, -sp * dP * ily2 * AB,
            (ily2 - dP * dP * ily2 * ily2) * AB)


def _pair_terms(kind: int, dq: Tensor, dP: Tensor, lx, ly, f,
                gxx: Tensor, gxy: Tensor, gyy: Tensor):
    """Per-pair contraction terms without their common factors, as
    ``pair_terms`` in ``csrc/cov_blocks.cu`` (the derivation is there):
    o0 * sig * (-2/lx), o1 * sig * (-2/ly), o2 and o3 * sig are the terms
    of d/dlx, d/dly, d/dsig and d/df."""
    i2 = 0.5 / (lx * lx)
    v = 1.0 / (ly * ly)
    dP2 = dP * dP
    t = dP2 * (0.5 * v)
    h = v - dP2 * v * v
    s, sp, spp, sh, ch = _q_side(kind, dq, lx, f)
    if kind == SE_SE.code:
        ds = dsp = dspp = torch.zeros_like(dq)
    else:
        shch = sh * ch
        cos2 = 1.0 - 2.0 * sh * sh
        ds = 2.0 * i2 * shch * dq
        dsp = 2.0 * i2 * shch + 2.0 * f * i2 * cos2 * dq
        dspp = 4.0 * f * i2 * cos2 - 8.0 * f * f * i2 * shch * dq
    D = spp - sp * sp
    dD = dspp - 2.0 * sp * dsp
    if kind == SUM_PER_SE.code:
        A0 = torch.exp(-s)
        B0 = torch.exp(-t)
        kxx0 = D * A0
        kyy0 = h * B0
        return (gxx * A0 * (spp - 2.0 * sp * sp - s * D),
                gyy * B0 * (v - 2.0 * dP2 * v * v - t * h),
                gxx * kxx0 + gyy * kyy0,
                gxx * (dD * A0 - kxx0 * ds))
    E0 = torch.exp(-(s + t))
    kxx0 = D * E0
    kxy0 = -sp * dP * v * E0
    kyy0 = h * E0
    return (gxx * E0 * (spp - 2.0 * sp * sp - s * D)
            + gxy * kxy0 * (1.0 - s) - gyy * kyy0 * s,
            -gxx * kxx0 * t + gxy * kxy0 * (1.0 - t)
            + gyy * E0 * (v - 2.0 * dP2 * v * v - t * h),
            gxx * kxx0 + gxy * kxy0 + gyy * kyy0,
            gxx * (dD * E0 - kxx0 * ds) - gxy * dP * v * E0 * (dsp - sp * ds)
            - gyy * kyy0 * ds)


def _scal(name: str, params, sig, X: Tensor, jitter=0.0) -> Tensor:
    """(lx, ly, sig, f, jitter) in X's dtype on X's device; f = 1/2 unless
    the kernel learns its frequency.  Numbers are filled in on the device:
    a number copied from the host would wait for the card's queue."""
    params = torch.as_tensor(params, dtype=X.dtype, device=X.device)
    sig = torch.as_tensor(sig, dtype=X.dtype, device=X.device).reshape(())
    if isinstance(jitter, Tensor):
        jitter = jitter.to(dtype=X.dtype, device=X.device).reshape(())
    else:
        jitter = torch.full_like(sig, jitter)
    f = (params[2] if _kernel(name).learns_freq
         else torch.full_like(sig, 0.5))
    return torch.stack([params[0], params[1], sig, f, jitter])


def _pairs(X: Tensor, X0: Tensor) -> tuple[Tensor, Tensor]:
    return X[:, None, 0] - X0[None, :, 0], X[:, None, 1] - X0[None, :, 1]


def build_K_blocks_reference(name: str, X: Tensor, X0: Tensor, params,
                             sig) -> Tensor:
    """Plain version of the build kernel: (2N, 2N0) covariance."""
    lx, ly, s, f, _ = _scal(name, params, sig, X)
    dq, dP = _pairs(X, X0)
    kxx, kxy, kyy = tile_blocks(_kernel(name).code, dq, dP, lx, ly, s, f)
    return torch.cat([torch.cat([kxx, kxy], 1), torch.cat([kxy, kyy], 1)], 0)


def build_Ky_reference(name: str, X: Tensor, params, sig, jitter) -> Tensor:
    """Plain version of ``build_Ky``: K(X, X) + jitter I."""
    K = build_K_blocks_reference(name, X, X, params, sig)
    jitter = torch.as_tensor(jitter, dtype=K.dtype, device=K.device)
    return K + jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)


def _assemble(name: str, params: Tensor, sig: Tensor, g: Tensor):
    """(dparams, dsig) from g = (dlx, dly, dsig, df): three params where the
    kernel learns its frequency, else two; unused trailing ones get zeros."""
    dparams = (torch.cat([g[:2], g[3:]]) if _kernel(name).learns_freq
               else g[:2])
    if params.shape[0] > dparams.shape[0]:
        dparams = torch.cat(
            [dparams, g.new_zeros(params.shape[0] - dparams.shape[0])])
    return dparams.to(params.dtype), g[2].to(sig.dtype)


def cov_param_grads_reference(name: str, X: Tensor, X0: Tensor, params, sig,
                              Kbar: Tensor):
    """Plain version of the contraction: (dparams, dsig) =
    <Kbar, dK/dtheta> from the hand-written derivatives."""
    N, N0 = X.shape[0], X0.shape[0]
    lx, ly, s, f, _ = _scal(name, params, sig, X)
    dq, dP = _pairs(X, X0)
    o = _pair_terms(_kernel(name).code, dq, dP, lx, ly, f, Kbar[:N, :N0],
                    Kbar[:N, N0:] + Kbar[N:, :N0], Kbar[N:, N0:])
    o0, o1, o2, o3 = (t.sum() for t in o)
    g = torch.stack([o0 * s * (-2.0 / lx), o1 * s * (-2.0 / ly), o2, o3 * s])
    return _assemble(name, params, sig, g)


def cov_param_grads_sym_reference(name: str, X: Tensor, params, sig,
                                  S: Tensor, alpha: Tensor):
    """Plain version of the fused contraction: the contraction on
    Kbar = (S - alpha alpha^T) / 2 for X0 = X."""
    Kbar = 0.5 * S - 0.5 * torch.outer(alpha, alpha)
    return cov_param_grads_reference(name, X, X, params, sig, Kbar)


# --- kernels -----------------------------------------------------------------


def _validate(X: Tensor, X0: Tensor, *others: Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"covariance kernels take float32 or float64, not "
                        f"{X.dtype}")
    for t in (X, X0, *others):
        if t.device != X.device or t.dtype != X.dtype:
            raise ValueError(f"all inputs must be {X.dtype} on {X.device}; "
                             f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("covariance kernel inputs must be contiguous")
    if (X.ndim != 2 or X0.ndim != 2 or X.shape[1] != 2 or X0.shape[1] != 2
            or X.shape[0] == 0 or X0.shape[0] == 0):
        raise ValueError(f"X, X0 must be non-empty (N, 2); got "
                         f"{tuple(X.shape)}, {tuple(X0.shape)}")


def _device_of(X: Tensor, what: str) -> str:
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {X.device}")
    return X.device.type


def _kernel(name: str) -> Kernel:
    if name not in KERNELS:
        raise ValueError(f"no covariance kernel for {name!r}; "
                         f"kernels: {sorted(KERNELS)}")
    return KERNELS[name]


_FWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _tile_count(N: int, N0: int, sym: bool) -> int:
    """Blocks of the contraction's grid: every pair tile, or the tiles on
    and below the diagonal in the symmetric mode."""
    t, t0 = -(-N // TILE), -(-N0 // TILE)
    return t * (t + 1) // 2 if sym else t * t0


def _fwd(name: str, X: Tensor, X0: Tensor, scal: Tensor) -> Tensor:
    _validate(X, X0, scal)
    N, N0 = X.shape[0], X0.shape[0]
    K = torch.empty((2 * N, 2 * N0), dtype=X.dtype, device=X.device)
    symbol = "cov_fwd_f32" if X.dtype == torch.float32 else "cov_fwd_f64"
    fn = _build.function("cov_blocks", symbol, _FWD_ARGS)
    with torch.cuda.device(X.device):
        rc = fn(_build.ptr(scal), _build.ptr(X), _build.ptr(X0),
                _build.ptr(K), N, N0, _kernel(name).code,
                _build.stream(X.device))
    _build.check(rc, "covariance build")
    count("cov_fwd")
    return K


def build_K_blocks(name: str, X: Tensor, X0: Tensor, params, sig) -> Tensor:
    """(2N, 2N0) covariance; the kernel on CUDA, the plain version on CPU."""
    _kernel(name)
    if _device_of(X, "covariance build") == "cpu":
        return build_K_blocks_reference(name, X, X0, params, sig)
    return _fwd(name, X, X0, _scal(name, params, sig, X))


def build_Ky(name: str, X: Tensor, params, sig, jitter) -> Tensor:
    """(2N, 2N) K(X, X) + jitter I in one launch of the build kernel on
    CUDA (``jitter`` a number or a 0-d tensor, read on the device), the
    plain version on CPU."""
    _kernel(name)
    if _device_of(X, "covariance build") == "cpu":
        return build_Ky_reference(name, X, params, sig, jitter)
    return _fwd(name, X, X, _scal(name, params, sig, X, jitter))


def _bwd(name: str, X: Tensor, X0: Tensor, params, sig, G: Tensor,
         alpha: Tensor | None):
    scal = _scal(name, params, sig, X)
    sym = alpha is not None
    _validate(X, X0, scal, G, *((alpha,) if sym else ()))
    N, N0 = X.shape[0], X0.shape[0]
    if G.shape != (2 * N, 2 * N0):
        raise ValueError(f"{'S' if sym else 'Kbar'} must be "
                         f"{(2 * N, 2 * N0)}; got {tuple(G.shape)}")
    if sym and alpha.shape != (2 * N,):
        raise ValueError(f"alpha must be {(2 * N,)}; got "
                         f"{tuple(alpha.shape)}")
    f64 = dict(dtype=torch.float64, device=X.device)
    partial = torch.empty(4 * _tile_count(N, N0, sym), **f64)
    out = torch.empty(4, **f64)
    symbol = "cov_bwd_f32" if X.dtype == torch.float32 else "cov_bwd_f64"
    fn = _build.function("cov_blocks", symbol, _BWD_ARGS)
    with torch.cuda.device(X.device):
        rc = fn(_build.ptr(scal), _build.ptr(X), _build.ptr(X0),
                _build.ptr(G), _build.ptr(alpha) if sym else None,
                _build.ptr(partial), _build.ptr(out), N, N0,
                _kernel(name).code, int(sym), _build.stream(X.device))
    _build.check(rc, "covariance contraction")
    count("cov_bwd")
    return _assemble(name, params, sig, out.to(X.dtype))


def cov_param_grads(name: str, X: Tensor, X0: Tensor, params, sig,
                    Kbar: Tensor):
    """(dparams, dsig) = <Kbar, dK/dtheta> for the (2N, 2N0) build; the
    kernels on CUDA, the plain version on CPU."""
    _kernel(name)
    if _device_of(X, "covariance contraction") == "cpu":
        return cov_param_grads_reference(name, X, X0, params, sig, Kbar)
    return _bwd(name, X, X0, params, sig, Kbar, None)


def cov_param_grads_sym(name: str, X: Tensor, params, sig, S: Tensor,
                        alpha: Tensor):
    """(dparams, dsig) = <(S - alpha alpha^T) / 2, dK(X, X)/dtheta> for a
    symmetric S (2N, 2N) and alpha (2N,), without forming Kbar: the fused
    kernels on CUDA (half the pairs), the plain version on CPU."""
    _kernel(name)
    if _device_of(X, "covariance contraction") == "cpu":
        return cov_param_grads_sym_reference(name, X, params, sig, S, alpha)
    return _bwd(name, X, X, params, sig, S, alpha)


class BuildK(torch.autograd.Function):
    """The covariance build with the contraction as its backward; X and X0
    are data and get zero cotangents (``_build_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, name: str, X: Tensor, X0: Tensor, params: Tensor,
                sig: Tensor) -> Tensor:
        ctx.name = name
        ctx.save_for_backward(X, X0, params, sig)
        return build_K_blocks(name, X, X0, params, sig)

    @staticmethod
    def backward(ctx, Kbar: Tensor):
        X, X0, params, sig = ctx.saved_tensors
        dparams, dsig = cov_param_grads(ctx.name, X, X0, params, sig,
                                        Kbar.contiguous())
        return (None, torch.zeros_like(X), torch.zeros_like(X0), dparams,
                dsig.reshape(sig.shape))


def build_K_cuda(kernel: Kernel, X: Tensor, X0: Tensor, params: Tensor,
                 sig: Tensor) -> Tensor:
    """Derivative-observation covariance (2N, 2N0) through ``BuildK``
    (the counterpart of ``build_K_pallas``)."""
    return BuildK.apply(kernel.name, X, X0, params, sig)
