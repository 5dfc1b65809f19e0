"""Comparisons of rollouts: the rollout kernel's trajectories against its
plain version (``cuda_step.rollout_reference``) and against float64.

Angles are compared on their circles (Q on ``mod_q``, P on ``mod_p``);
an orbit lost in both trajectories counts as agreement, one lost in only
one of them as an infinite difference.  A float32 trajectory is held
against the float64 rollout of the same float32 columns: its error must
lie within ``NOISE_FACTOR`` times the plain float32 version's, since a
sum over thousands of training points carries float32 rounding well
above any fixed tolerance.  Shared by ``chip_smoke.py`` and
``workloads/large_n.py::sweep_check``.
"""

from __future__ import annotations

import dataclasses

import torch

from sympgpr_tpu_torch.ops import cuda_step

Tensor = torch.Tensor

# float32 at N=4096: a 4096-point sum carries float32 rounding above 1e-4
# (kernel vs plain version 8.9e-4 at steps 1-2 on an H100).  So both
# float32 versions are held against the float64 rollout of the same
# float32 columns: the kernel's L2 error at steps 1-2 within 3x the plain
# version's (H100: kernel 1.6e-3, plain 2.0e-3).  A rollout without one
# lane's points lies at 22.
NOISE_FACTOR = 3
# the packed columns a float64 copy of a float32 pack converts
COLUMNS = ("uq", "uP", "a0", "a1", "auxq", "auxp", "auxa", "scal")


def as_float64(pm: cuda_step.PackedModels) -> cuda_step.PackedModels:
    """The same packed models with float64 columns."""
    return dataclasses.replace(pm, **{f: getattr(pm, f).double()
                                      for f in COLUMNS})


def circle_diff(d: Tensor, period: float | None) -> Tensor:
    """A difference of two angles on their circle of ``period``: in
    [-period / 2, period / 2) (as it is where ``period`` is None)."""
    if period is None:
        return d
    return torch.remainder(d + period / 2, period) - period / 2


def max_abs_diff(a: Tensor, b: Tensor, period: float | None = None) -> float:
    """max |a - b| where positions NaN in both count 0 and NaN in one
    count inf (a lost orbit must be lost in both); on the circle of
    ``period`` where one is given."""
    d = circle_diff(a - b, period).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d)
    return float(d.nan_to_num(torch.inf).max())


def rotate(pm: cuda_step.PackedModels, r: int) -> cuda_step.PackedModels:
    """The same sub-maps cycled from sub-map ``r`` on: a rollout of the
    result runs sub-map ``(r + i) % n_maps`` in its step i."""
    M = pm.n_maps
    if r % M == 0:
        return pm

    def roll(t):
        return torch.roll(t.reshape(M, -1), -r, 0).reshape(t.shape)

    return dataclasses.replace(pm, **{f: roll(getattr(pm, f))
                                      for f in COLUMNS})


def one_step_from_rows(rollout, pm: cuda_step.PackedModels, traj: tuple,
                       kw: dict) -> list:
    """One step of ``rollout(pm, q, p, 2, **kw)`` from each of the
    trajectory's rows 0 .. nm - 2 (its orbits side by side, one call for
    each sub-map), each by the sub-map that made the row after it in the
    trajectory (row i + 1 by sub-map i mod n_maps): the (nm - 1, B) next
    rows of Q and P and, with pdiff, of the step's unwrapped increment."""
    nm, B = traj[0].shape
    out = [torch.empty_like(t[1:]) for t in traj]
    for r in range(min(pm.n_maps, nm - 1)):
        rows = slice(r, nm - 1, pm.n_maps)
        q, p = (t[rows].reshape(-1).contiguous() for t in traj[:2])
        got = rollout(rotate(pm, r), q, p, 2, **kw)
        n = q.numel() // B
        for o, g in zip(out[:2], got[:2]):
            o[rows] = g[1].reshape(n, B)
        if len(traj) == 3:
            out[2][rows] = (got[2][1] - got[2][0]).reshape(n, B)
    return out


def step_err(rollout, pm: cuda_step.PackedModels, traj: tuple,
             kw: dict) -> float:
    """The largest difference between ``one_step_from_rows`` of
    ``rollout`` and the trajectory's own next rows: Q and P on their
    circles and, with pdiff, the step's unwrapped increment."""
    got = one_step_from_rows(rollout, pm, traj, kw)
    errs = [max_abs_diff(g, t[1:], per)
            for g, t, per in zip(got[:2], traj[:2], periods(pm, 2))]
    if len(traj) == 3:
        errs.append(max_abs_diff(got[2], traj[2][1:] - traj[2][:-1]))
    return max(errs)


def periods(pm: cuda_step.PackedModels, n_out: int) -> list:
    """The circle of each rollout output: Q's mod_q, P's mod_p and none
    for pdiff's unwrapped D."""
    return [pm.mod_q, pm.mod_p, None][:n_out]


def _l2(pairs, pers) -> float:
    """The L2 norm of the differences of the (a, b) pairs, a difference of
    angles on its circle of ``pers``, NaN entries left out."""
    d = torch.cat([circle_diff(a.double() - b, per).reshape(-1)
                   for (a, b), per in zip(pairs, pers)])
    return float(d[~torch.isnan(d)].norm())


def residual(pm: cuda_step.PackedModels, traj: tuple, kw: dict) -> float:
    """The L2 residual of every row of ``traj`` after the first against
    one float64 step of the plain version (float64 copies of ``pm``'s
    columns, 8 Newton iterations) from the row before it, a Split model's
    rows each by the sub-map that made the next (``one_step_from_rows``);
    with pdiff, the step's unwrapped increment too.  NaN entries are left
    out, angles compared on their circles."""
    traj = tuple(t.double() for t in traj)
    step = one_step_from_rows(
        lambda *a, **k: cuda_step.rollout_reference(*a, iters=8, **k),
        as_float64(pm), traj, kw)
    pairs = [(t[1:], s) for t, s in zip(traj[:2], step)]
    if len(traj) == 3:  # pdiff's increment of each step
        pairs.append((traj[2][1:] - traj[2][:-1], step[2]))
    return _l2(pairs, periods(pm, len(traj)))


def f32_vs_f64(pm: cuda_step.PackedModels, q: Tensor, p: Tensor, kw: dict,
               got: tuple, ref: tuple) -> dict:
    """A float32 kernel trajectory ``got`` and the plain version's ``ref``
    from the same columns and ICs, each held against float64 on the same
    float32 columns: the L2 distance at steps 1-2 to the float64 rollout
    (``err_*``), and the L2 residual of every later row against one
    float64 step from the row before it in the same trajectory
    (``residual_*``, ``residual``: each trajectory's own, so the chaos of
    the free orbits does not enter).  NaN entries are left out, angles
    compared on their circles; ``max_abs_err_steps_1_2`` is the kernel
    against the plain version.  ``err`` is the L2 error function itself,
    for wrong trajectories a caller builds; pop it before printing."""
    pers = periods(pm, len(got))
    x = cuda_step.rollout_reference(as_float64(pm), q.double(), p.double(),
                                    3, iters=8, **kw)

    def err(out) -> float:
        return _l2([(o[1:3], e[1:3]) for o, e in zip(out, x)], pers)

    r = dict(
        max_abs_err_steps_1_2=max(
            max_abs_diff(g[1:3], t[1:3], per)
            for g, t, per in zip(got, ref, pers)),
        nan_pattern_equal=all(torch.equal(torch.isnan(g), torch.isnan(t))
                              for g, t in zip(got, ref)),
        err_kernel=err(got), err_plain=err(ref),
        residual_kernel=residual(pm, got, kw),
        residual_plain=residual(pm, ref, kw))
    r["err_bound"] = NOISE_FACTOR * r["err_plain"]
    r["residual_bound"] = NOISE_FACTOR * r["residual_plain"]
    r["err"] = err
    return r
