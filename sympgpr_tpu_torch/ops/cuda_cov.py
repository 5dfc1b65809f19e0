"""Derivative-observation covariance build and the contraction of its
hyperparameter gradient (PyTorch port of ``sympgpr_tpu/ops/pallas_cov.py``).

Two hand-written CUDA kernels (``csrc/cov_blocks.cu``) replace the Pallas
kernels ``_cov_tile`` and ``_cov_bwd_tile``:

* ``build_K_blocks`` writes the (2N, 2N0) covariance straight into its block
  layout, one sincos and one exp per pair (two exps for ``sum_per_se``);
* ``cov_param_grads`` computes <Kbar, dK/dtheta> for theta = (lx, ly, sig,
  freq) without forming dK.  The Pallas kernel takes the derivatives with
  ``jax.grad`` inside the tile; here they are written out
  (``_pair_terms``), in the plain version and again in the kernel.

``BuildK`` ties the two together as one autograd function.  Each wrapper
runs its plain PyTorch version on CPU tensors and launches its kernel on
CUDA tensors (or raises).  ``LAUNCHES_FWD`` and ``LAUNCHES_BWD`` count
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from sympgpr_tpu_torch.kernels.variants import Kernel
from sympgpr_tpu_torch.ops import _build

Tensor = torch.Tensor

KINDS = {"per_se": 0, "se_se": 1, "per_se_freq": 2, "sum_per_se": 3}
TILE = 32  # pair tile of csrc/cov_blocks.cu
NLL_THRESHOLD = 512  # minimum N for the kernel build in the NLL

LAUNCHES_FWD = 0  # launches of the build kernel in this process
LAUNCHES_BWD = 0  # launches of the contraction kernels in this process


def nll_threshold() -> int:
    """Minimum number of training points for the kernel build in the NLL."""
    return NLL_THRESHOLD


def want_cuda_build(kernel: Kernel, X: Tensor) -> bool:
    """Dispatch of the NLL covariance build (``want_pallas_build``)."""
    return (kernel.name in KINDS and X.dtype == torch.float32
            and X.shape[0] >= nll_threshold())


# --- plain versions ----------------------------------------------------------


def _q_side(kind: int, dq: Tensor, lx, f):
    """s, s', s'' of the q-factor A = exp(-s(dq)), and sin/cos of f dq
    for the periodic kinds (None for se_se)."""
    i2 = 0.5 / (lx * lx)
    if kind == KINDS["se_se"]:  # s = dq^2 / (2 lx^2)
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
    if kind == KINDS["sum_per_se"]:  # separable: the mixed block vanishes
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
    if kind == KINDS["se_se"]:
        ds = dsp = dspp = torch.zeros_like(dq)
    else:
        shch = sh * ch
        cos2 = 1.0 - 2.0 * sh * sh
        ds = 2.0 * i2 * shch * dq
        dsp = 2.0 * i2 * shch + 2.0 * f * i2 * cos2 * dq
        dspp = 4.0 * f * i2 * cos2 - 8.0 * f * f * i2 * shch * dq
    D = spp - sp * sp
    dD = dspp - 2.0 * sp * dsp
    if kind == KINDS["sum_per_se"]:
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


def _scal(name: str, params, sig, X: Tensor) -> Tensor:
    """(lx, ly, sig, f) in X's dtype on X's device; f = 1/2 unless the
    kernel learns its frequency."""
    params = torch.as_tensor(params, dtype=X.dtype, device=X.device)
    sig = torch.as_tensor(sig, dtype=X.dtype, device=X.device).reshape(())
    f = params[2] if name == "per_se_freq" else torch.full_like(sig, 0.5)
    return torch.stack([params[0], params[1], sig, f])


def _pairs(X: Tensor, X0: Tensor) -> tuple[Tensor, Tensor]:
    return X[:, None, 0] - X0[None, :, 0], X[:, None, 1] - X0[None, :, 1]


def build_K_blocks_reference(name: str, X: Tensor, X0: Tensor, params,
                             sig) -> Tensor:
    """Plain version of the build kernel: (2N, 2N0) covariance."""
    lx, ly, s, f = _scal(name, params, sig, X)
    dq, dP = _pairs(X, X0)
    kxx, kxy, kyy = tile_blocks(KINDS[name], dq, dP, lx, ly, s, f)
    return torch.cat([torch.cat([kxx, kxy], 1), torch.cat([kxy, kyy], 1)], 0)


def _assemble(name: str, params: Tensor, sig: Tensor, g: Tensor):
    """(dparams, dsig) from g = (dlx, dly, dsig, df): per_se_freq gets
    three params, the others two; unused trailing params get zeros."""
    dparams = torch.cat([g[:2], g[3:]]) if name == "per_se_freq" else g[:2]
    if params.shape[0] > dparams.shape[0]:
        dparams = torch.cat(
            [dparams, g.new_zeros(params.shape[0] - dparams.shape[0])])
    return dparams.to(params.dtype), g[2].to(sig.dtype)


def cov_param_grads_reference(name: str, X: Tensor, X0: Tensor, params, sig,
                              Kbar: Tensor):
    """Plain version of the contraction: (dparams, dsig) =
    <Kbar, dK/dtheta> from the hand-written derivatives."""
    N, N0 = X.shape[0], X0.shape[0]
    lx, ly, s, f = _scal(name, params, sig, X)
    dq, dP = _pairs(X, X0)
    o = _pair_terms(KINDS[name], dq, dP, lx, ly, f, Kbar[:N, :N0],
                    Kbar[:N, N0:] + Kbar[N:, :N0], Kbar[N:, N0:])
    o0, o1, o2, o3 = (t.sum() for t in o)
    g = torch.stack([o0 * s * (-2.0 / lx), o1 * s * (-2.0 / ly), o2, o3 * s])
    return _assemble(name, params, sig, g)


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


def _kind(name: str) -> int:
    if name not in KINDS:
        raise ValueError(f"no covariance kernel for {name!r}; "
                         f"kernels: {sorted(KINDS)}")
    return KINDS[name]


_FWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def build_K_blocks(name: str, X: Tensor, X0: Tensor, params, sig) -> Tensor:
    """(2N, 2N0) covariance; the kernel on CUDA, the plain version on CPU."""
    global LAUNCHES_FWD
    kind = _kind(name)
    if _device_of(X, "covariance build") == "cpu":
        return build_K_blocks_reference(name, X, X0, params, sig)
    scal = _scal(name, params, sig, X)
    _validate(X, X0, scal)
    N, N0 = X.shape[0], X0.shape[0]
    K = torch.empty((2 * N, 2 * N0), dtype=X.dtype, device=X.device)
    sym = "cov_fwd_f32" if X.dtype == torch.float32 else "cov_fwd_f64"
    fn = _build.function("cov_blocks", sym, _FWD_ARGS)
    with torch.cuda.device(X.device):
        rc = fn(_build.ptr(scal), _build.ptr(X), _build.ptr(X0),
                _build.ptr(K), N, N0, kind, _build.stream(X.device))
    _build.check(rc, "covariance build")
    LAUNCHES_FWD += 1
    return K


def cov_param_grads(name: str, X: Tensor, X0: Tensor, params, sig,
                    Kbar: Tensor):
    """(dparams, dsig) = <Kbar, dK/dtheta> for the (2N, 2N0) build; the
    kernels on CUDA, the plain version on CPU."""
    global LAUNCHES_BWD
    kind = _kind(name)
    if _device_of(X, "covariance contraction") == "cpu":
        return cov_param_grads_reference(name, X, X0, params, sig, Kbar)
    scal = _scal(name, params, sig, X)
    _validate(X, X0, scal, Kbar)
    N, N0 = X.shape[0], X0.shape[0]
    if Kbar.shape != (2 * N, 2 * N0):
        raise ValueError(f"Kbar must be {(2 * N, 2 * N0)}; got "
                         f"{tuple(Kbar.shape)}")
    nblocks = -(-N // TILE) * -(-N0 // TILE)
    f64 = dict(dtype=torch.float64, device=X.device)
    partial = torch.empty(4 * nblocks, **f64)
    out = torch.empty(4, **f64)
    sym = "cov_bwd_f32" if X.dtype == torch.float32 else "cov_bwd_f64"
    fn = _build.function("cov_blocks", sym, _BWD_ARGS)
    with torch.cuda.device(X.device):
        rc = fn(_build.ptr(scal), _build.ptr(X), _build.ptr(X0),
                _build.ptr(Kbar), _build.ptr(partial), _build.ptr(out), N,
                N0, kind, _build.stream(X.device))
    _build.check(rc, "covariance contraction")
    LAUNCHES_BWD += 1
    return _assemble(name, params, sig, out.to(X.dtype))


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
