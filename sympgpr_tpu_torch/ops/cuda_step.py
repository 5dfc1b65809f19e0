"""Fused rollout of the learned map: the whole nm-step iteration in one CUDA
launch (PyTorch port of ``sympgpr_tpu/ops/pallas_step.py``).

The kernel (``csrc/rollout_step.cu``) replaces the Pallas kernel
``_rollout_kernel`` for the modes the tokamak workload runs: implicit
product kernels (per_se, se_se, per_se_freq) with the aux-GP warm start and
fixed-iteration Newton, the tokamak loss check at the old q, the mod_q
wrap, single map, float32 or float64.  The modes not covered yet (explicit
and Algorithm-2 updates, mod_p with pdiff, the loss check at the new q,
Split cycling) raise ``NotImplementedError``; nothing falls back.

``rollout_in_kernel`` dispatches on the device of its inputs: CPU tensors
go to the plain PyTorch version ``rollout_reference`` (the fast path of
``maps/fast_apply.py`` with fixed Newton iterations), CUDA tensors launch
the kernel or raise.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from sympgpr_tpu_torch.gp.model import AuxGP, SympGP
from sympgpr_tpu_torch.kernels.variants import get_kernel
from sympgpr_tpu_torch.maps import fast_apply
from sympgpr_tpu_torch.maps.symplectic import MapConfig
from sympgpr_tpu_torch.ops import _build
from sympgpr_tpu_torch.systems.tokamak import compute_r

Tensor = torch.Tensor

LAUNCHES = 0  # kernel launches made by rollout_in_kernel in this process

_KIND = {"per_se": 0, "se_se": 1, "per_se_freq": 2, "sum_per_se": 3}
_KIND_NAME = {v: k for k, v in _KIND.items()}
NSCAL = 12  # lx, ly, alx, aly, delta, mod_q, freq, afreq, mod_p, 3x pad
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper


@dataclasses.dataclass(frozen=True)
class PackedModels:
    """Model columns for the rollout kernel.

    Columns are 1-D, zero-padded to a multiple of 8 (padding rows carry
    zero alpha, so they add nothing); ``a0``/``a1``/``auxa`` carry the sig
    factor.  ``scal`` is (1, NSCAL) in the columns' dtype (the JAX
    package's layout for one map).  The remaining fields are plain Python
    values known when packing.
    """

    uq: Tensor
    uP: Tensor
    a0: Tensor
    a1: Tensor
    auxq: Tensor
    auxp: Tensor
    auxa: Tensor
    scal: Tensor
    kind: int
    aux_kind: int
    ns: int
    nas: int
    delta: bool
    mod_q: float | None
    mod_p: float | None

    def tensors(self) -> tuple[Tensor, ...]:
        return (self.scal, self.uq, self.uP, self.a0, self.a1, self.auxq,
                self.auxp, self.auxa)


def _pad8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _col(v: Tensor, stride: int, dtype: torch.dtype) -> Tensor:
    """float64 values -> zero-padded column, rounded to ``dtype`` once."""
    out = torch.zeros(stride, dtype=torch.float64, device=v.device)
    out[: v.shape[0]] = v
    return out.to(dtype)


def _freq_of(model) -> Tensor | float:
    if model is not None and model.kernel.name == "per_se_freq":
        return model.params[2]
    return 0.0


def pack_models(sgp: SympGP, aux: AuxGP | None, mod_q: float | None,
                mod_p: float | None = None, *,
                dtype: torch.dtype = torch.float32) -> PackedModels:
    """Preprocess one fitted (sgp, aux) pair for the rollout kernel.

    Columns are formed in float64 from the models (on their device) and
    rounded to ``dtype`` once, as the JAX package's ``pack_models`` does
    for float32.
    """
    dev = sgp.device
    f64 = torch.float64
    n = sgp.n_train
    ns = _pad8(n)
    nas = _pad8(aux.X.shape[0]) if aux is not None else 8
    al = sgp.alpha.to(f64).reshape(2, n)
    sig = sgp.sig.to(f64)
    empty = torch.zeros(0, dtype=f64, device=dev)
    if aux is not None:
        auxq, auxp = aux.X[:, 0].to(f64), aux.X[:, 1].to(f64)
        auxa = aux.sig.to(f64) * aux.alpha.to(f64)
    else:
        auxq = auxp = auxa = empty

    def s(x) -> Tensor:
        return torch.as_tensor(x, dtype=f64, device=dev).reshape(())

    scal = torch.stack([
        s(sgp.params[0]), s(sgp.params[1]),
        s(aux.params[0] if aux is not None else 1.0),
        s(aux.params[1] if aux is not None else 1.0),
        s(1.0 if (aux is not None and aux.delta) else 0.0),
        s(mod_q if mod_q is not None else 0.0),
        s(_freq_of(sgp)), s(_freq_of(aux)),
        s(mod_p if mod_p is not None else 0.0),
        s(0.0), s(0.0), s(0.0),
    ])[None, :].to(dtype)
    return PackedModels(
        uq=_col(sgp.X[:, 0].to(f64), ns, dtype),
        uP=_col(sgp.X[:, 1].to(f64), ns, dtype),
        a0=_col(sig * al[0], ns, dtype), a1=_col(sig * al[1], ns, dtype),
        auxq=_col(auxq, nas, dtype), auxp=_col(auxp, nas, dtype),
        auxa=_col(auxa, nas, dtype), scal=scal,
        kind=_KIND[sgp.kernel.name],
        aux_kind=_KIND[aux.kernel.name] if aux is not None else 0,
        ns=ns, nas=nas,
        delta=bool(aux is not None and aux.delta), mod_q=mod_q, mod_p=mod_p,
    )


def _check_supported(pm: PackedModels, loss_at_new_q: bool, explicit: bool,
                     track_pdiff: bool) -> None:
    missing = []
    if pm.kind not in (0, 1, 2):
        missing.append(f"kernel {_KIND_NAME[pm.kind]!r} (Algorithm 2)")
    if pm.mod_p is not None or track_pdiff:
        missing.append("mod_p wrap and pdiff tracking")
    if loss_at_new_q:
        missing.append("the loss check at the new q")
    if explicit:
        missing.append("the explicit update")
    if missing:
        raise NotImplementedError(
            "rollout kernel does not cover yet: " + ", ".join(missing))


def _tokamak_lost(P: Tensor, q: Tensor) -> Tensor:
    """Loss boundary at the old q: r > 0.5 or P < 0 (single map, ph = 0)."""
    r = compute_r(P * 1e-2, q, 0.0, torch.full_like(P, 0.3))
    return (r > 0.5) | (P < 0.0)


def _models_of(pm: PackedModels) -> tuple[SympGP, AuxGP]:
    """Fast-path models over the packed columns (sig folded into alpha)."""
    sc = pm.scal[0]
    one = torch.ones((), dtype=sc.dtype, device=sc.device)
    none = torch.zeros(0, dtype=sc.dtype, device=sc.device)
    kname = _KIND_NAME[pm.kind]
    aname = _KIND_NAME[pm.aux_kind]
    sgp = SympGP(
        kernel=get_kernel(kname),
        params=sc[[0, 1, 6]] if kname == "per_se_freq" else sc[[0, 1]],
        sig=one, sig2n=one, X=torch.stack([pm.uq, pm.uP], 1), z=none,
        alpha=torch.cat([pm.a0, pm.a1]), L=none)
    aux = AuxGP(
        kernel=get_kernel(aname), delta=pm.delta,
        params=sc[[2, 3, 7]] if aname == "per_se_freq" else sc[[2, 3]],
        sig=one, sig2n=one, X=torch.stack([pm.auxq, pm.auxp], 1), z=none,
        alpha=pm.auxa, L=none)
    return sgp, aux


def rollout_reference(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int,
                      iters: int = 5, loss_check: bool = False):
    """Plain PyTorch version of the kernel, in the dtype of the inputs.

    ``maps.fast_apply.apply_map_fast`` with ``iters`` fixed Newton
    iterations over the packed columns, the tokamak loss check at the old
    q, and the mod_q wrap.  Returns (Q, P), each (nm, B).
    """
    _check_supported(pm, False, False, False)
    sgp, aux = _models_of(pm)
    cfg = MapConfig(mod_q=pm.scal[0, 5] if pm.mod_q is not None else None,
                    newton_maxiter=iters)
    loss = (lambda q, Q, P, i: _tokamak_lost(P, q)) if loss_check else None
    traj = fast_apply.apply_map_fast(sgp, aux, q0, p0, nm, cfg,
                                     loss_pre=loss, fixed_iters=True)
    return traj.q, traj.p


def _validate(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int,
              iters: int) -> None:
    """Raise on anything the kernel does not take."""
    dev, dtype = q0.device, q0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rollout kernel takes float32 or float64, not {dtype}")
    for t in (q0, p0, *pm.tensors()):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(
                f"all inputs must be {dtype} on {dev}; got {t.dtype} on "
                f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("rollout kernel inputs must be contiguous")
    if q0.ndim != 1 or p0.shape != q0.shape or q0.shape[0] == 0:
        raise ValueError(f"q0, p0 must be equal non-empty 1-D; got "
                         f"{tuple(q0.shape)}, {tuple(p0.shape)}")
    if q0.shape[0] >= 2**31:
        raise ValueError(f"batch {q0.shape[0]} too large")
    if nm < 1 or iters < 0:
        raise ValueError(f"need nm >= 1 and iters >= 0; got {nm}, {iters}")
    if shared_memory_bytes(pm) > SMEM_LIMIT:
        raise ValueError(
            f"training set ({pm.ns} + {pm.nas} aux points, {dtype}) needs "
            f"{shared_memory_bytes(pm)} bytes of shared memory; a block has "
            f"{SMEM_LIMIT}")


def shared_memory_bytes(pm: PackedModels) -> int:
    """Dynamic shared memory of one block: 6 training and 5 aux columns."""
    return (6 * pm.ns + 5 * pm.nas) * pm.uq.element_size()


_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _launch(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int, iters: int,
            loss_check: bool):
    global LAUNCHES
    _validate(pm, q0, p0, nm, iters)
    dev, dtype = q0.device, q0.dtype
    B = q0.shape[0]
    sym = "rollout_step_f32" if dtype == torch.float32 else "rollout_step_f64"
    fn = _build.function("rollout_step", sym, _ARGS)
    Q = torch.empty((nm, B), dtype=dtype, device=dev)
    P = torch.empty((nm, B), dtype=dtype, device=dev)
    ptr = _build.ptr
    with torch.cuda.device(dev):
        rc = fn(*(ptr(t) for t in pm.tensors()), ptr(q0), ptr(p0), ptr(Q),
                ptr(P), B, pm.ns, pm.nas, nm, iters, pm.kind, pm.aux_kind,
                int(loss_check), _build.stream(dev))
    _build.check(rc, "rollout kernel")
    LAUNCHES += 1
    return Q, P


def rollout_in_kernel(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int,
                      iters: int = 5, loss_check: bool = False,
                      loss_at_new_q: bool = False, explicit: bool = False,
                      track_pdiff: bool = False):
    """Full nm-step rollout; returns (Q, P), each (nm, B), row 0 = ICs.

    CPU tensors run ``rollout_reference``; CUDA tensors launch the kernel
    (and raise if it cannot).
    """
    _check_supported(pm, loss_at_new_q, explicit, track_pdiff)
    if q0.device.type == "cpu":
        return rollout_reference(pm, q0, p0, nm, iters, loss_check)
    if q0.device.type != "cuda":
        raise ValueError(f"no rollout for device {q0.device}")
    return _launch(pm, q0, p0, nm, iters, loss_check)


def rollout_model(sgp: SympGP, aux: AuxGP | None, q0: Tensor, p0: Tensor,
                  nm: int, *, mod_q: float | None = 2.0 * math.pi,
                  iters: int = 5, loss_check: bool = False,
                  deployment_jitter: float | None = 1e-3,
                  dtype: torch.dtype = torch.float32):
    """Model-level fused rollout (counterpart of ``rollout_pallas``).

    Re-solves alpha at the deployment jitter on the float64 models
    (``for_deployment``), packs them (each column rounded to ``dtype``
    once), and runs the rollout in ``dtype`` on the models' device.  The
    whole trajectory lives in device memory, so the time axis is not
    chunked.  Returns (Q, P), each (nm, B).
    """
    if isinstance(sgp, (list, tuple)):
        raise NotImplementedError(
            "rollout kernel does not cover yet: Split cycling over several "
            "sub-maps")
    if deployment_jitter is not None:
        sgp = sgp.for_deployment(deployment_jitter)
        aux = aux.for_deployment(deployment_jitter) if aux is not None \
            else None
    pm = pack_models(sgp, aux, mod_q=mod_q, dtype=dtype)
    if q0.device != sgp.device or p0.device != sgp.device:
        raise ValueError(f"initial conditions on {q0.device}, models on "
                         f"{sgp.device}")
    q0 = q0.to(dtype).contiguous()
    p0 = p0.to(dtype).contiguous()
    return rollout_in_kernel(pm, q0, p0, nm, iters=iters,
                             loss_check=loss_check)
