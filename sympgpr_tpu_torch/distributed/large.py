"""Large-N training path: block-cyclic covariance, Cholesky and solves that
never hold a whole K on any rank (PyTorch port of
``sympgpr_tpu/distributed/large.py``).

* Each rank builds only its own block-cyclic rows of Ky (closed-form
  derivative blocks): block row ``l*D + d`` lives on rank d of the axis,
  so a rank holds exactly ``n_pad^2 / D`` entries.
* The factorization is right-looking and block-cyclic: per step one
  broadcast of the diagonal block from its owner, the panel rows solved
  where they live, one all-gather of the panel column and one matrix
  product for the trailing update (the active window is a Python slice).
* The triangular solves run over the same layout, one collective a step;
  the log-determinant is one all-reduce of local diagonal sums.

Layout: rows are point-major interleaved, row ``2i + a`` is component
``a`` (0 = q, 1 = P) of training point ``i``, unlike the reference's
component-major ``[z_p | z_q]``.  The NLL is invariant under this
symmetric permutation, and a block row of K is then a contiguous run of
points.  ``interleave_z`` / ``deinterleave_z`` convert targets.

Gradients: ``torch.func`` transforms do not pass through c10d collectives,
so ``sharded_nll_large_value_and_grad`` carries forward-mode tangents by
hand.  The build's tangent rows come from ``torch.func`` (the rank-local
build has no collective) as a ``(dim, nb_loc, block, n_pad)`` stack beside
the primal slab; the factorization, the forward solve and the
log-determinant advance that stack beside the primal step by step with the
block rules of the Cholesky tangent, and each collective carries primal
and tangents in one call.  The primal factorization runs once.

Every function is collective: every rank of the mesh calls it.  Results
marked "replicated" are the same on every rank; a slab is each rank's
own shard.
"""

from __future__ import annotations

import math
import time

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.func import jvp, vmap

from sympgpr_tpu_torch.distributed.init import (
    all_gather,
    axis_group,
    broadcast_from,
)
from sympgpr_tpu_torch.gp.covariance import hess_blocks
from sympgpr_tpu_torch.kernels.variants import Kernel
from sympgpr_tpu_torch.profiling import _sync

Tensor = torch.Tensor

_PRODUCT = ("per_se", "se_se", "per_se_freq")


# --------------------------------------------------------------------------
# layout helpers

def interleave_z(z: Tensor) -> Tensor:
    """Reference layout (z_p | z_q) -> point-major (z_p0, z_q0, z_p1, ...)."""
    n = z.shape[0] // 2
    return torch.stack([z[:n], z[n:]], dim=-1).reshape(2 * n)


def deinterleave_z(zi: Tensor) -> Tensor:
    """Point-major -> reference layout (z_p | z_q)."""
    z = zi.reshape(-1, 2)
    return torch.cat([z[:, 0], z[:, 1]])


def _row_blocks(kernel: Kernel, Xr: Tensor, Xc: Tensor, params: Tensor):
    """Hxx, Hxy, Hyy blocks (m, Nc) between row points and all points.

    Closed form (shared A/B factors) for the product family; autodiff
    Hessian blocks otherwise (``sum_per_se``, whose mixed block is zero).
    """
    if kernel.name in _PRODUCT:
        from sympgpr_tpu_torch.maps.fast_apply import _q_factors

        ly = params[1]
        dq = Xr[:, None, 0] - Xc[None, :, 0]
        dP = Xr[:, None, 1] - Xc[None, :, 1]
        A, sp, spp = _q_factors(kernel.name, dq, params)
        B = torch.exp(-(dP**2) / (2.0 * ly**2))
        ily2 = 1.0 / ly**2
        AB = A * B
        return ((spp - sp**2) * AB, -sp * dP * ily2 * AB,
                (ily2 - dP**2 * ily2**2) * AB)
    H = hess_blocks(kernel, Xr, Xc, params)
    return H[..., 0, 0], H[..., 0, 1], H[..., 1, 1]


# --------------------------------------------------------------------------
# block-cyclic geometry

def _geometry(N: int, D: int, block: int):
    """(n_pad, nb, nb_loc) for 2N rows padded to a multiple of block*D."""
    if block % 2:
        raise ValueError(f"block ({block}) must be even (2 rows per point)")
    n = 2 * N
    n_pad = -(-n // (block * D)) * (block * D)
    nb = n_pad // block
    return n_pad, nb, nb // D


def _first_below(k: int, d: int, D: int) -> int:
    """First local block row whose global index l*D + d exceeds k."""
    return max((k - d) // D + 1, 0)


def _diag_index(d: int, D: int, nb_loc: int, block: int, device):
    """(li, bi, rows) indexing each local row's own diagonal entry."""
    li = torch.arange(nb_loc, device=device)[:, None]
    bi = torch.arange(block, device=device)[None, :]
    return li, bi, (li * D + d) * block + bi


# --------------------------------------------------------------------------
# block-cyclic primitives (every rank of the group calls them)

def _solve_right_lt(Lkk: Tensor, B: Tensor) -> Tensor:
    """B Lkk^{-T} for lower-triangular Lkk, over any leading batch."""
    return torch.linalg.solve_triangular(Lkk.mT, B, upper=True, left=False)


def _factorize_cyclic(local: Tensor, dlocal: Tensor | None, d: int, group,
                      D: int, nb: int, nb_loc: int, block: int):
    """Right-looking block-cyclic Cholesky of the local slab, with the
    tangents ``dlocal`` carried beside it.

    local: (nb_loc, block, n) block rows owned cyclically (row l*D + d);
    dlocal: None or (T, nb_loc, block, n), T tangent directions of it.
    Returns (L, dL) as new tensors (dL None without tangents); the lower
    triangle of the gathered L is the factor, the rest is left over.

    Per step k: the owner broadcasts the diagonal block and its tangents;
    every rank factors it (a failed factor is NaN, as JAX's) and solves its
    rows below k; one all-gather of the panel column (primal and tangents
    in one call); one product updates the local rows below k at the
    columns past block k (and one batched product their tangents).  The
    tangent rules: dL_kk = L_kk Phi(L_kk^-1 dA_kk L_kk^-T), Phi the lower
    triangle with half the diagonal; dL_ik = (dA_ik - L_ik dL_kk^T)
    L_kk^-T; dA_ij -= dL_ik L_jk^T + L_ik dL_jk^T.
    """
    L = local.clone()
    dL = None if dlocal is None else dlocal.clone()
    T = 0 if dL is None else dL.shape[0]
    n = L.shape[-1]
    nan = torch.tensor(math.nan, dtype=L.dtype, device=L.device)
    diag = L.new_empty((1 + T, block, block))
    for k in range(nb):
        owner, lk = k % D, k // D
        c0, c1 = k * block, (k + 1) * block
        if d == owner:
            diag[0] = L[lk, :, c0:c1]
            if T:
                diag[1:] = dL[:, lk, :, c0:c1]
        broadcast_from(diag, owner, group)
        Lkk, info = torch.linalg.cholesky_ex(diag[0])
        Lkk = torch.where(info == 0, Lkk, nan)
        li0 = _first_below(k, d, D)
        Lik = _solve_right_lt(Lkk, L[li0:, :, c0:c1])
        if d == owner:
            L[lk, :, c0:c1] = Lkk
        L[li0:, :, c0:c1] = Lik
        if T:
            X = torch.linalg.solve_triangular(Lkk, diag[1:], upper=False)
            X = _solve_right_lt(Lkk, X)
            Phi = torch.tril(X) - 0.5 * torch.diag_embed(
                torch.diagonal(X, dim1=-2, dim2=-1))
            dLkk = Lkk @ Phi
            dLik = _solve_right_lt(
                Lkk, dL[:, li0:, :, c0:c1] - Lik @ dLkk[:, None].mT)
            if d == owner:
                dL[:, lk, :, c0:c1] = dLkk
            dL[:, li0:, :, c0:c1] = dLik
        if c1 == n:
            break
        panel = L[None, :, :, c0:c1]
        if T:
            panel = torch.cat([panel, dL[:, :, :, c0:c1]])
        panel = all_gather(panel, group)
        # (D, 1+T, nb_loc, b, b) -> global block-row order (1+T, nb*b, b)
        panel = panel.permute(1, 2, 0, 3, 4).reshape(1 + T, nb * block,
                                                     block)[:, c1:]
        m = Lik.shape[0]
        if m == 0:
            continue
        # the local rows below k at the columns past block k, as one
        # strided matrix (a batch of T for the tangents) updated in place
        r0 = li0 * block
        Lf = Lik.reshape(m * block, block)
        L.view(-1, n)[r0:, c1:].addmm_(Lf, panel[0].mT, alpha=-1.0)
        if T:
            lhs = torch.cat([dLik.reshape(T, m * block, block),
                             Lf.expand(T, -1, -1)], dim=-1)
            rhs = torch.cat([panel[0].expand(T, -1, -1), panel[1:]], dim=-1)
            dL.view(T, -1, n)[:, r0:, c1:].baddbmm_(lhs, rhs.mT, alpha=-1.0)
    return L, dL


def _factorize_robust(local: Tensor, dlocal: Tensor | None, n_data: int,
                      d: int, group, D: int, nb: int, nb_loc: int,
                      block: int, max_tries: int = 4):
    """Block-cyclic Cholesky with distributed jitter escalation.

    Hyperparameter searches visit regions where Ky is numerically
    semidefinite; a plain factorization then floods the collectives with
    NaN.  This re-factors with a diagonal jitter of 1e-12, 1e-9, 1e-6 of
    the global max diagonal until every rank sees a finite factor (the
    distributed counterpart of ``gp/likelihood.py::chol_and_alpha``); the
    NLL then describes the jittered surrogate.  Padded rows (>= n_data)
    keep their identity.  The jitter is a constant: it adds no tangent.

    One all-reduce (MAX of the max diagonal and of a failure flag) and one
    host read of the consensus a try; a healthy Ky takes one try, so one
    host sync a factorization.
    """
    li, bi, rows = _diag_index(d, D, nb_loc, block, local.device)
    live = rows < n_data
    diag = local[li, bi, rows]
    md = torch.max(torch.where(live, diag, -math.inf))
    jit = None
    for _ in range(max_tries):
        if jit is None:
            slab = local
        else:
            slab = local.clone()
            slab[li, bi, rows] += torch.where(live, jit, 0.0)
        L, dL = _factorize_cyclic(slab, dlocal, d, group, D, nb, nb_loc,
                                  block)
        flags = torch.stack([md, (~torch.isfinite(L.sum())).to(L.dtype)])
        torch.distributed.all_reduce(flags, torch.distributed.ReduceOp.MAX,
                                     group=group)
        if not bool(flags[1] > 0.5):
            break
        jit = (1e-12 * flags[0] if jit is None else jit * 1000.0)
    return L, dL


def _solve_lower_cyclic_mat(localL: Tensor, Z: Tensor, d: int, group,
                            D: int, nb: int, nb_loc: int, block: int,
                            dL: Tensor | None = None):
    """Forward substitution L Y = Z for a replicated (n_pad, R) right-hand
    side; returns the replicated Y, and with ``dL`` (T, nb_loc, block,
    n_pad) also the replicated tangents dY = L^-1 (-dL Y), (T, n_pad, R).

    One broadcast a step from the owner of block row k, carrying L_kk, the
    right-hand side's block and their tangents; the rows below k are
    updated where they live.
    """
    R = Z.shape[1]
    T = 0 if dL is None else dL.shape[0]
    rhs = Z.reshape(nb, block, R)[d::D].clone()
    y = Z.new_zeros((nb, block, R))
    if T:
        drhs = Z.new_zeros((T, nb_loc, block, R))
        dy = Z.new_zeros((T, nb, block, R))
    pay = Z.new_empty((1 + T, block, block + R))
    for k in range(nb):
        owner, lk = k % D, k // D
        cs = slice(k * block, (k + 1) * block)
        if d == owner:
            pay[0, :, :block] = localL[lk, :, cs]
            pay[0, :, block:] = rhs[lk]
            if T:
                pay[1:, :, :block] = dL[:, lk, :, cs]
                pay[1:, :, block:] = drhs[:, lk]
        broadcast_from(pay, owner, group)
        Lkk = pay[0, :, :block]
        yk = torch.linalg.solve_triangular(Lkk, pay[0, :, block:],
                                           upper=False)
        y[k] = yk
        li0 = _first_below(k, d, D)
        Lik = localL[li0:, :, cs]
        rhs[li0:] -= Lik @ yk
        if T:
            dyk = torch.linalg.solve_triangular(
                Lkk, pay[1:, :, block:] - pay[1:, :, :block] @ yk,
                upper=False)
            dy[:, k] = dyk
            drhs[:, li0:] -= dL[:, li0:, :, cs] @ yk + Lik @ dyk[:, None]
    if T:
        return y.reshape(nb * block, R), dy.reshape(T, nb * block, R)
    return y.reshape(nb * block, R)


def _solve_lower_cyclic(localL: Tensor, z: Tensor, d: int, group, D: int,
                        nb: int, nb_loc: int, block: int,
                        dL: Tensor | None = None):
    """Forward substitution L y = z; z and the returned y are replicated
    (with ``dL``, also dy (T, n_pad))."""
    out = _solve_lower_cyclic_mat(localL, z[:, None], d, group, D, nb,
                                  nb_loc, block, dL)
    if dL is None:
        return out[:, 0]
    return out[0][:, 0], out[1][..., 0]


def _solve_lower_t_cyclic(localL: Tensor, y: Tensor, d: int, group, D: int,
                          nb: int, nb_loc: int, block: int) -> Tensor:
    """Backward substitution L^T x = y; y and the returned x are
    replicated.  One all-reduce a step carries the local rows' column
    contributions and, from the owner, L_kk (zeros elsewhere)."""
    yc = y.reshape(nb, block)
    x = y.new_zeros((nb, block))
    pay = y.new_empty((block, block + 1))
    for j in range(nb):
        k = nb - 1 - j
        cs = slice(k * block, (k + 1) * block)
        li0 = _first_below(k, d, D)
        pay.zero_()
        if li0 < nb_loc:  # x of the local rows below k, solved already
            pay[:, block] = torch.einsum("lbc,lb->c", localL[li0:, :, cs],
                                         x[d::D][li0:])
        if d == k % D:
            pay[:, :block] = localL[k // D, :, cs]
        torch.distributed.all_reduce(pay, group=group)
        rhs = yc[k] - pay[:, block]
        x[k] = torch.linalg.solve_triangular(
            pay[:, :block].T, rhs[:, None], upper=True)[:, 0]
    return x.reshape(nb * block)


def _logdet_cyclic(localL: Tensor, d: int, group, D: int, nb_loc: int,
                   block: int, dL: Tensor | None = None):
    """sum(log diag L) over the distributed factor (one all-reduce); with
    ``dL`` also its tangents sum(diag dL / diag L), (T,), in the same
    call."""
    li, bi, rows = _diag_index(d, D, nb_loc, block, localL.device)
    dg = localL[li, bi, rows]
    parts = [torch.log(dg).sum()[None]]
    if dL is not None:
        parts.append((dL[:, li, bi, rows] / dg).sum((1, 2)))
    out = torch.cat(parts)
    torch.distributed.all_reduce(out, group=group)
    return out[0] if dL is None else (out[0], out[1:])


# --------------------------------------------------------------------------
# sharded slab build

def _local_rows(d: int, D: int, nb_loc: int, block: int, device) -> Tensor:
    """Global row indices of this rank's block rows, flattened."""
    g = torch.arange(nb_loc, device=device) * D + d
    return (g[:, None] * block
            + torch.arange(block, device=device)[None, :]).reshape(-1)


def _slab(kernel: Kernel, Xp: Tensor, params: Tensor, sig: Tensor,
          sig2n: Tensor, rows: Tensor, n: int) -> Tensor:
    """Rows ``rows`` of the padded Ky = sig*K + |sig2n| I, (len(rows),
    n_pad); no collective (``torch.func`` differentiates it)."""
    n_pad = 2 * Xp.shape[0]
    pi = rows // 2  # point index of each row
    a = (rows % 2 == 0)[:, None]  # component q (else P)
    Hxx, Hxy, Hyy = _row_blocks(kernel, Xp[pi], Xp, params)
    K0 = torch.where(a, Hxx, Hxy)
    K1 = torch.where(a, Hxy, Hyy)
    Krows = sig * torch.stack([K0, K1], dim=-1).reshape(-1, n_pad)
    cols = torch.arange(n_pad, device=Xp.device)
    eye = (rows[:, None] == cols[None, :]).to(Krows.dtype)
    pad = (rows[:, None] >= n) | (cols[None, :] >= n)
    return torch.where(pad, eye, Krows + torch.abs(sig2n) * eye)


def _setup(mesh: DeviceMesh, axis: str, X: Tensor, block: int):
    """(group, d, D, n_pad, nb, nb_loc, Xp, rows) of a call."""
    group, d, D = axis_group(mesh, axis)
    N = X.shape[0]
    n_pad, nb, nb_loc = _geometry(N, D, block)
    Xp = torch.nn.functional.pad(X, (0, 0, 0, n_pad // 2 - N))
    rows = _local_rows(d, D, nb_loc, block, X.device)
    return group, d, D, n_pad, nb, nb_loc, Xp, rows


def _as(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def build_K_cyclic(kernel: Kernel, mesh: DeviceMesh, params, sig, sig2n,
                   X: Tensor, *, block: int = 64,
                   axis: str = "kp") -> Tensor:
    """This rank's block-cyclic rows of Ky = sig*K + |sig2n| I.

    Returns the rank's shard (1, nb_loc, block, n_pad) of JAX's (D,
    nb_loc, block, n_pad) slab: rank d holds global block rows ``l*D + d``.
    Padded rows and columns (beyond 2N) are identity, so the factor is
    block-diag(L, I) and solves and log-determinants are unaffected.  No
    rank ever holds more than ``n_pad^2 / D`` entries.
    """
    group, d, D, n_pad, nb, nb_loc, Xp, rows = _setup(mesh, axis, X, block)
    slab = _slab(kernel, Xp, _as(params, X), _as(sig, X), _as(sig2n, X),
                 rows, 2 * X.shape[0])
    return slab.reshape(1, nb_loc, block, n_pad)


def _padded_z(z: Tensor, n_pad: int) -> Tensor:
    zi = interleave_z(z)
    return torch.nn.functional.pad(zi, (0, n_pad - zi.shape[0]))


# --------------------------------------------------------------------------
# public entry points

def sharded_nll_large(kernel: Kernel, mesh: DeviceMesh, params, sig, sig2n,
                      X: Tensor, z: Tensor, *, block: int = 64,
                      axis: str = "kp") -> Tensor:
    """NLL, replicated: sharded build -> distributed Cholesky ->
    distributed forward substitution and log-determinant.  K is never
    whole on a rank; the replicated O(N) objects are X, z and the solve
    vector.  Matches ``gp.likelihood.nll`` (the Cholesky branch)."""
    group, d, D, n_pad, nb, nb_loc, Xp, rows = _setup(mesh, axis, X, block)
    local = _slab(kernel, Xp, _as(params, X), _as(sig, X), _as(sig2n, X),
                  rows, 2 * X.shape[0]).reshape(nb_loc, block, n_pad)
    L, _ = _factorize_robust(local, None, 2 * X.shape[0], d, group, D, nb,
                             nb_loc, block)
    y = _solve_lower_cyclic(L, _padded_z(z, n_pad), d, group, D, nb,
                            nb_loc, block)
    return 0.5 * (y @ y) + _logdet_cyclic(L, d, group, D, nb_loc, block)


def sharded_alpha_large(kernel: Kernel, mesh: DeviceMesh, params, sig, sig2n,
                        X: Tensor, z: Tensor, *, block: int = 64,
                        axis: str = "kp") -> Tensor:
    """alpha = Ky^-1 z by both distributed substitutions, replicated, in
    the reference (z_p | z_q) layout."""
    group, d, D, n_pad, nb, nb_loc, Xp, rows = _setup(mesh, axis, X, block)
    local = _slab(kernel, Xp, _as(params, X), _as(sig, X), _as(sig2n, X),
                  rows, 2 * X.shape[0]).reshape(nb_loc, block, n_pad)
    L, _ = _factorize_robust(local, None, 2 * X.shape[0], d, group, D, nb,
                             nb_loc, block)
    y = _solve_lower_cyclic(L, _padded_z(z, n_pad), d, group, D, nb,
                            nb_loc, block)
    x = _solve_lower_t_cyclic(L, y, d, group, D, nb, nb_loc, block)
    return deinterleave_z(x[: 2 * X.shape[0]])


def sharded_nll_large_value_and_grad(kernel: Kernel, mesh: DeviceMesh,
                                     theta: Tensor, sig2n, X: Tensor,
                                     z: Tensor, *, block: int = 64,
                                     axis: str = "kp"):
    """(value, grad) of theta -> NLL(10^theta), both replicated, by
    forward-mode tangents carried beside the primal.

    theta are log10 hyperparameters (lengthscales..., sig).  The build's
    tangents d Ky/d theta_t come from ``torch.func.jvp`` of the rank-local
    row build (batched over the basis by ``vmap``); the factorization
    (``_factorize_cyclic``, once), the forward solve and the
    log-determinant advance them beside the primal; then
    d NLL = y . dy + d logdet.  Costs one factorization whose steps also
    advance the tangents (one batched product a step), and keeps no
    residuals of the step loop.
    """
    group, d, D, n_pad, nb, nb_loc, Xp, rows = _setup(mesh, axis, X, block)
    n = 2 * X.shape[0]
    s2n = _as(sig2n, X)

    def rows_of(t):
        hyp = 10.0 ** t
        return _slab(kernel, Xp, hyp[:-1], hyp[-1], s2n, rows, n)

    dim = theta.shape[0]
    basis = torch.eye(dim, dtype=theta.dtype, device=theta.device)
    local, dlocal = vmap(lambda s: jvp(rows_of, (theta,), (s,)),
                         out_dims=(None, 0))(basis)
    local = local.reshape(nb_loc, block, n_pad)
    dlocal = dlocal.reshape(dim, nb_loc, block, n_pad)
    L, dL = _factorize_robust(local, dlocal, n, d, group, D, nb, nb_loc,
                              block)
    del local, dlocal
    y, dy = _solve_lower_cyclic(L, _padded_z(z, n_pad), d, group, D, nb,
                                nb_loc, block, dL)
    logdet, dlogdet = _logdet_cyclic(L, d, group, D, nb_loc, block, dL)
    return 0.5 * (y @ y) + logdet, dy @ y + dlogdet


def fit_large(kernel: Kernel, mesh: DeviceMesh, X: Tensor, z: Tensor, sig2n,
              x0_theta, *, steps: int = 60, lr: float = 3e-2,
              block: int = 64, axis: str = "kp",
              deployment_jitter: float | None = None,
              timings: dict | None = None):
    """Distributed large-N training: Adam over
    ``sharded_nll_large_value_and_grad`` (K never whole on a rank), then
    the distributed ``sharded_alpha_large`` for the deployable alpha.

    Adam is ``gp/train.py::adam_update`` (optax's formula, a non-finite
    gradient entry taken as 0).  ``deployment_jitter`` (relative to max
    diag K) re-solves alpha at a larger noise floor for float32 rollouts,
    the distributed analog of ``SympGP.for_deployment``: max diag K is the
    closed form ``sig * max(d2k/dq2, d2k/dP2)(0)``.  ``timings`` receives
    ``train_s`` (the Adam loop) and ``train_warm_s`` (the same loop less
    its first step, which carries the process's one-off costs); the loop
    runs once.

    Returns ``(model, history)``: a deployable ``gp.model.SympGP`` without
    the dense factor L, the same on every rank, and the per-step NLL
    history (numpy).
    """
    from sympgpr_tpu_torch.gp.model import SympGP
    from sympgpr_tpu_torch.gp.train import adam_update

    theta = _as(x0_theta, X)
    s2n = _as(sig2n, X)
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    hist = []
    t0 = time.perf_counter()
    t1 = t0
    for i in range(steps):
        v, g = sharded_nll_large_value_and_grad(kernel, mesh, theta, s2n, X,
                                                z, block=block, axis=axis)
        theta, mu, nu = adam_update(theta, g, mu, nu, i, lr)
        hist.append(v)
        if i == 0:
            _sync(X.device)
            t1 = time.perf_counter()
    history = torch.stack(hist).cpu().numpy()  # device->host = sync
    if timings is not None:
        t2 = time.perf_counter()
        timings["train_s"] = t2 - t0
        timings["train_warm_s"] = t2 - t1

    hyp = 10.0 ** theta
    params, sig = hyp[:-1], hyp[-1]
    s2n_alpha = s2n
    if deployment_jitter is not None:
        H0 = kernel.hess_uv(X[0], X[0], params)
        s2n_alpha = deployment_jitter * sig * torch.maximum(H0[0, 0],
                                                            H0[1, 1])
    alpha = sharded_alpha_large(kernel, mesh, params, sig, s2n_alpha, X, z,
                                block=block, axis=axis)
    model = SympGP.from_alpha(kernel, params, sig, s2n_alpha, X, z, alpha)
    return model, history


class DistFactor:
    """Handle to a block-cyclic distributed Cholesky factor.

    Holds this rank's shard of the L slab (rank d owns global block rows
    ``l*D + d``) and the geometry it was made on: N, the block, the axis
    and the axis' size D.  Made by ``factorize_large``; taken by
    ``predict_df_large``, which refuses a factor of another geometry.
    """

    __slots__ = ("slabL", "N", "block", "axis", "D")

    def __init__(self, slabL: Tensor, N: int, block: int, axis: str,
                 D: int):
        self.slabL = slabL
        self.N = N
        self.block = block
        self.axis = axis
        self.D = D


def factorize_large(model, mesh: DeviceMesh, *, block: int = 64,
                    axis: str = "kp") -> DistFactor:
    """Distributed factorization of Ky for a ``fit_large`` model: the
    block-cyclic slab built and factored once (robustly), kept sharded.
    Pass it to ``predict_df_large(..., factor=...)`` to reuse it over many
    prediction batches."""
    X = model.X
    group, d, D, n_pad, nb, nb_loc, Xp, rows = _setup(mesh, axis, X, block)
    local = _slab(model.kernel, Xp, model.params, model.sig, model.sig2n,
                  rows, 2 * X.shape[0]).reshape(nb_loc, block, n_pad)
    L, _ = _factorize_robust(local, None, 2 * X.shape[0], d, group, D, nb,
                             nb_loc, block)
    return DistFactor(L[None], X.shape[0], block, axis, D)


def predict_df_large(model, mesh: DeviceMesh, V: Tensor, *, block: int = 64,
                     axis: str = "kp", with_var: bool = True,
                     factor: DistFactor | None = None):
    """Posterior mean and variance of (dF/dq, dF/dP) for a distributed
    fit, both replicated.

    Models from ``fit_large`` carry no dense factor, so
    ``gp.predict.predict_df`` cannot give their variance.  This path
    factorizes block-cyclically (or takes ``factor``, whose geometry (N,
    axis, D) must be the call's; its block is used) and runs one
    multi-right-hand-side distributed forward substitution against the
    (n, 2M) cross-covariance:

        var[m, b] = sig * d2k/dv_b dv_b(v_m, v_m) - || L^-1 k*_mb ||^2

    The mean comes from the stored alpha, as in ``gp.predict.predict_df``.
    Returns (mean (M, 2), var (M, 2) or None).
    """
    kernel, params, sig, X = model.kernel, model.params, model.sig, model.X
    N, M = X.shape[0], V.shape[0]
    group, d, D = axis_group(mesh, axis)
    if factor is not None:
        if (factor.N, factor.axis, factor.D) != (N, axis, D):
            raise ValueError(
                f"factor geometry (N={factor.N}, axis={factor.axis!r}, "
                f"D={factor.D}) does not match model/call (N={N}, "
                f"axis={axis!r}, D={D})")
        block = factor.block
    n_pad, nb, nb_loc = _geometry(N, D, block)

    # H[m, i, a, b] = d2k/du_a dv_b at (train_i, test_m)
    H = hess_blocks(kernel, X, V, params).transpose(0, 1)
    Ks_ref = sig * torch.cat([H[:, :, 0, :], H[:, :, 1, :]], dim=1)
    mean = torch.einsum("mnb,n->mb", Ks_ref, model.alpha)
    if not with_var:
        return mean, None

    # interleaved rows (2i+a), flattened test columns (2m+b), padded
    Ks = sig * H.permute(1, 2, 0, 3).reshape(2 * N, 2 * M)
    Ks = torch.nn.functional.pad(Ks, (0, 0, 0, n_pad - 2 * N))
    if factor is None:
        factor = factorize_large(model, mesh, block=block, axis=axis)
    W = _solve_lower_cyclic_mat(factor.slabL[0], Ks, d, group, D, nb, nb_loc,
                                block)
    qsum = torch.sum(W * W, dim=0).reshape(M, 2)
    prior = sig * vmap(
        lambda v: torch.diagonal(kernel.hess_uv(v, v, params)))(V)
    return mean, torch.clamp(prior - qsum, min=0.0)
