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

The kernel runs one orbit on a team of lanes; ``launch_geometry`` picks
the team size, the block and the kernel's instance for a batch and
training-set size, and the kernel takes that layout as given.
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

# The launch layout is decided here and only here; the kernel runs the
# instance it is given and refuses a layout it cannot hold.
# The kernel's instances (csrc/rollout_step.cu, launch()): the training
# points a lane holds, a block's threads and the blocks an SM runs at once
# (its __launch_bounds__, so its register budget).  Each dtype's list runs
# from the most resident to the least: more warps hide more of the exps'
# latency.  float64 lanes of more than 8 points take the one-block
# instance, too few warps to hide float64's exp and sin/cos chains (32768 x
# 1000 orbit-steps at N = 80 on an H100: 107 ms at 8 lanes of 10 points,
# 83 ms at 16 of 5), so the team is widened before that.
INSTANCES = {
    torch.float32: ((10, 288, 3), (16, 288, 2), (10, 512, 1), (16, 512, 1)),
    torch.float64: ((8, 288, 2), (16, 288, 1)),
}
P_MAX = 16           # training points a lane holds, in any instance
SOLVER_THREADS = 32  # a block's loss-solve warp, where the block has room
# a lane's row of shared memory: FIELDS values for each of its points,
# rounded up to whole groups of PAIRS points worked on together
FIELDS = 6
PAIRS = {torch.float32: 2, torch.float64: 1}
BLOCK_THREADS = 256  # compute threads of a block of narrow teams
SM_COUNT = 132       # H100 SXM
# the widest team the fill rule picks: float32's 512-lane team has no room
# for a solver warp, so its block solves the loss boundary on the step's
# chain; it runs only where 256 lanes cannot hold the slice
FILL_TEAM_MAX = 256


def max_threads(dtype: torch.dtype) -> int:
    """The widest block of the dtype's instances."""
    return max(t for _, t, _ in INSTANCES[dtype])


def team_max(dtype: torch.dtype) -> int:
    """The widest team: the largest power of two a block holds."""
    return 1 << (max_threads(dtype).bit_length() - 1)


def ns_max(dtype: torch.dtype) -> int:
    return team_max(dtype) * P_MAX


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one launch lays the batch out: ``team`` lanes per orbit (a
    power of two), each holding at most ``per_lane`` training points;
    ``teams_per_block`` orbits in a block of ``threads`` threads (the
    teams' lanes, and a solver warp where the block has room for one)
    with ``smem_bytes`` of dynamic shared memory, run by the kernel's
    ``instance`` (an entry of ``INSTANCES``)."""

    team: int
    per_lane: int
    teams_per_block: int
    threads: int
    smem_bytes: int
    instance: tuple[int, int, int]


def launch_geometry(B: int, ns: int, nas: int, dtype: torch.dtype,
                    sm_count: int = SM_COUNT,
                    team: int | None = None) -> Geometry:
    """Team, block and instance for a batch of ``B`` orbits over ``ns``
    training and ``nas`` aux points.

    The team is the smallest power of two whose lanes hold no more points
    than an instance that shares its SM with other blocks takes (or the
    widest team, whose lanes may hold up to ``P_MAX``), doubled
    while the batch's ``B * team`` threads fall short of one full wave
    (``sm_count`` SMs times the threads an SM holds of the dtype's most
    resident instance) and the team is below ``FILL_TEAM_MAX`` and below
    ``ns / PAIRS`` (wider, lanes would hold less than one group of
    points).  Then it is halved while a block would need more shared
    memory than ``SMEM_LIMIT`` and its lanes can still hold the slice.
    ``team`` forces the team size instead.  A block holds
    ``BLOCK_THREADS // team`` teams (at least one, and at least a warp's
    worth), fewer when the batch is small, so that it spreads over the
    SMs.  The instance is the first of ``INSTANCES[dtype]`` that holds the
    lane's points and the block's threads.
    Shared memory: the aux table (4 columns), two slots of per-warp partial
    sums, two of the loss-check staging (3 values per team), and a row per
    lane (``FIELDS`` values for each of its points, rounded up to whole
    ``PAIRS``, and one more).
    """
    widest = team_max(dtype)
    if ns > ns_max(dtype):
        raise ValueError(f"rollout kernel takes at most {ns_max(dtype)} "
                         f"training points in {dtype} ({widest} lanes x "
                         f"{P_MAX}); got {ns}")
    elt = torch.empty((), dtype=dtype).element_size()
    instances = INSTANCES[dtype]

    def layout(team: int) -> Geometry:
        warp_teams = max(1, 32 // team)  # teams that make up one warp
        tpb = min(max(1, BLOCK_THREADS // team), max(1, -(-B // sm_count)))
        tpb = -(-tpb // warp_teams) * warp_teams
        compute = team * tpb
        per_lane = -(-ns // team)
        pairs = PAIRS[dtype]
        row = FIELDS * (-(-per_lane // pairs) * pairs) + 1
        smem = (4 * nas + 4 * (compute // 32) + 6 * tpb
                + row * compute) * elt
        threads = compute + (SOLVER_THREADS if compute + SOLVER_THREADS
                             <= max_threads(dtype) else 0)
        inst = next(i for i in instances
                    if i[0] >= per_lane and i[1] >= threads)
        return Geometry(team, per_lane, tpb, threads, smem, inst)

    if team is not None:
        if (team < 1 or team > widest or team & (team - 1)
                or -(-ns // team) > P_MAX):
            raise ValueError(f"team {team}: need a power of two <= "
                             f"{widest} with ceil({ns} / team) <= {P_MAX}")
        return layout(team)
    shared = max(p for p, _, blocks in instances if blocks > 1)
    narrowest = 1
    while -(-ns // narrowest) > shared and narrowest < widest:
        narrowest *= 2
    cap = min(FILL_TEAM_MAX,
              1 << max(0, -(-ns // PAIRS[dtype]) - 1).bit_length())
    _, threads, blocks = instances[0]
    fill = sm_count * threads * blocks
    team = narrowest
    while team < cap and B * team < fill:
        team *= 2
    while team > narrowest and layout(team).smem_bytes > SMEM_LIMIT:
        team //= 2
    return layout(team)


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
              iters: int, team: int | None = None) -> Geometry:
    """Raise on anything the kernel does not take; else its geometry."""
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
    sm_count = (torch.cuda.get_device_properties(dev).multi_processor_count
                if dev.type == "cuda" else SM_COUNT)
    geo = launch_geometry(q0.shape[0], pm.ns, pm.nas, dtype, sm_count, team)
    if geo.smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"aux table ({pm.nas} points, {dtype}) needs {geo.smem_bytes} "
            f"bytes of shared memory; a block has {SMEM_LIMIT}")
    return geo


_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 15 + [ctypes.c_void_p]


def _launch(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int, iters: int,
            loss_check: bool, team: int | None = None):
    """Launch the kernel on CUDA tensors; ``team`` forces the lanes per
    orbit (``launch_geometry`` chooses by default)."""
    global LAUNCHES
    geo = _validate(pm, q0, p0, nm, iters, team)
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
                int(loss_check), geo.team, geo.teams_per_block, geo.threads,
                geo.smem_bytes, *geo.instance, _build.stream(dev))
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
