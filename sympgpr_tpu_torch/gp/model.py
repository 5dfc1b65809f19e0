"""Fitted-model containers and the model artifact format (PyTorch port of
``sympgpr_tpu/gp/model.py``).

A fitted model is a small frozen dataclass of tensors that all live on one
device.  The ``.npz`` artifact uses the same keys as the JAX package, so a
model fitted by either package loads in the other: ``models_from_arrays``
turns such a dict of numpy arrays into the port's models.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sympgpr_tpu_torch.gp.covariance import build_K, build_Kreg
from sympgpr_tpu_torch.gp.likelihood import chol_and_alpha
from sympgpr_tpu_torch.kernels.variants import Kernel, get_kernel

Tensor = torch.Tensor

_ARRAY_FIELDS = ("params", "sig", "sig2n", "X", "z", "alpha", "L")


def _like(x: Any, ref: Tensor) -> Tensor:
    """``x`` as a tensor of ``ref``'s dtype on ``ref``'s device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def _solve(K: Tensor, sig2n: Tensor, z: Tensor) -> tuple[Tensor, Tensor]:
    Ky = K + sig2n * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    return chol_and_alpha(Ky, z)


class _Fitted:
    """What the two model types share."""

    @property
    def device(self) -> torch.device:
        return self.X.device


@dataclasses.dataclass(frozen=True)
class SympGP(_Fitted):
    """Fitted symplectic (derivative-observation) GP over mixed variables.

    X: (N, 2) training points (q, P); z: (2N,) targets (p - P | Q - q);
    alpha = (K + sig2n I)^{-1} z; L: lower Cholesky factor of K + sig2n I.
    """

    kernel: Kernel
    params: Tensor
    sig: Tensor
    sig2n: Tensor
    X: Tensor
    z: Tensor
    alpha: Tensor
    L: Tensor

    @property
    def n_train(self) -> int:
        return self.X.shape[0]

    @classmethod
    def create(cls, kernel: Kernel, params, sig, sig2n, X: Tensor,
               z) -> "SympGP":
        """Solve alpha/L at the given hyperparameters; every array takes
        the dtype and device of ``X``."""
        params, sig, sig2n, z = (_like(v, X) for v in (params, sig, sig2n, z))
        K = build_K(kernel, X, X, params, sig)
        L, alpha = _solve(K, sig2n, z)
        return cls(kernel=kernel, params=params, sig=sig, sig2n=sig2n, X=X,
                   z=z, alpha=alpha, L=L)

    @classmethod
    def from_alpha(cls, kernel: Kernel, params, sig, sig2n, X: Tensor, z,
                   alpha, L: Tensor | None = None) -> "SympGP":
        """Model from an externally solved alpha (the large-N fit keeps no
        factor); L defaults to an empty (0, 0) placeholder.  Everything the
        map needs is present; the posterior variance needs ``create``."""
        params, sig, sig2n, z, alpha = (
            _like(v, X) for v in (params, sig, sig2n, z, alpha))
        if L is None:
            L = alpha.new_zeros((0, 0))
        return cls(kernel=kernel, params=params, sig=sig, sig2n=sig2n, X=X,
                   z=z, alpha=alpha, L=L)

    def training_error(self) -> Tensor:
        """MSE(z, K alpha)."""
        K = build_K(self.kernel, self.X, self.X, self.params, self.sig)
        return torch.mean((K @ self.alpha - self.z) ** 2)

    def for_deployment(self, rel_jitter: float = 1e-3) -> "SympGP":
        """Re-solve alpha/L at ``sig2n = rel_jitter * max(diag K)``.

        Keeps |alpha| ~ O(1) so that float32 posterior sums do not cancel
        catastrophically; hyperparameters are untouched.
        """
        K = build_K(self.kernel, self.X, self.X, self.params, self.sig)
        sig2n = rel_jitter * torch.max(torch.diagonal(K))
        L, alpha = _solve(K, sig2n, self.z)
        return dataclasses.replace(self, sig2n=sig2n, alpha=alpha, L=L)


@dataclasses.dataclass(frozen=True)
class AuxGP(_Fitted):
    """Auxiliary ordinary GP used for the Newton initial guess.

    X: (N, 2) points (q, p); z: (N,) targets.  ``delta``: the target is
    P - p and the guess is p + mean (else the guess is the mean).
    """

    kernel: Kernel
    delta: bool
    params: Tensor
    sig: Tensor
    sig2n: Tensor
    X: Tensor
    z: Tensor
    alpha: Tensor
    L: Tensor

    @classmethod
    def create(cls, kernel: Kernel, params, sig, sig2n, X: Tensor, z,
               delta: bool = True) -> "AuxGP":
        params, sig, sig2n, z = (_like(v, X) for v in (params, sig, sig2n, z))
        K = build_Kreg(kernel, X, X, params, sig)
        L, alpha = _solve(K, sig2n, z)
        return cls(kernel=kernel, delta=delta, params=params, sig=sig,
                   sig2n=sig2n, X=X, z=z, alpha=alpha, L=L)

    def for_deployment(self, rel_jitter: float = 1e-3) -> "AuxGP":
        """float32-friendly re-solve; see ``SympGP.for_deployment``."""
        K = build_Kreg(self.kernel, self.X, self.X, self.params, self.sig)
        sig2n = rel_jitter * torch.max(torch.diagonal(K))
        L, alpha = _solve(K, sig2n, self.z)
        return dataclasses.replace(self, sig2n=sig2n, alpha=alpha, L=L)


# ---------------------------------------------------------------------------
# Artifact format (keys shared with sympgpr_tpu/gp/model.py)


def _to_dict(model: SympGP | AuxGP, prefix: str) -> dict[str, np.ndarray]:
    out = {f"{prefix}kernel": np.asarray(model.kernel.name)}
    if isinstance(model, AuxGP):
        out[f"{prefix}delta"] = np.asarray(model.delta)
    for f in _ARRAY_FIELDS:
        out[f"{prefix}{f}"] = getattr(model, f).detach().cpu().numpy()
    return out


def models_to_arrays(sympgp: SympGP, aux: AuxGP | None = None,
                     **extra: Any) -> dict[str, np.ndarray]:
    """The artifact's dict of numpy arrays (copies to host memory)."""
    d = _to_dict(sympgp, "sympgp.")
    if aux is not None:
        d.update(_to_dict(aux, "aux."))
    for k, v in extra.items():
        d[f"extra.{k}"] = np.asarray(v)
    return d


def models_from_arrays(
    d: dict[str, np.ndarray], device: torch.device | str,
) -> tuple[SympGP, AuxGP | None, dict[str, np.ndarray]]:
    """Port models from the artifact's arrays, each keeping its dtype."""

    def fields(prefix):
        return {f: torch.from_numpy(np.array(d[f"{prefix}{f}"])).to(device)
                for f in _ARRAY_FIELDS}

    sympgp = SympGP(kernel=get_kernel(str(d["sympgp.kernel"])),
                    **fields("sympgp."))
    aux = None
    if "aux.kernel" in d:
        aux = AuxGP(kernel=get_kernel(str(d["aux.kernel"])),
                    delta=bool(d["aux.delta"]), **fields("aux."))
    extra = {k[len("extra."):]: d[k] for k in d if k.startswith("extra.")}
    return sympgp, aux, extra


def save_models(path: str, sympgp: SympGP, aux: AuxGP | None = None,
                **extra: Any) -> None:
    """Save fitted models (and optional extra arrays) to a single .npz."""
    np.savez(path, **models_to_arrays(sympgp, aux, **extra))


def load_models(path: str, device: torch.device | str):
    with np.load(path, allow_pickle=False) as f:
        d = dict(f)
    return models_from_arrays(d, device)
