"""Fused rollout of the learned map: the whole nm-step iteration in one CUDA
launch (PyTorch port of ``sympgpr_tpu/ops/pallas_step.py``).

The kernel (``csrc/rollout_kernel.cuh``) replaces the Pallas kernel
``_rollout_kernel``: implicit product kernels (per_se, se_se, per_se_freq)
with the aux-GP warm start and fixed-iteration Newton, the explicit
product update, Algorithm 2 for the separable sum kernel sum_per_se, the
tokamak loss check at the old q or at the new q, the mod_q wrap, the mod_p
wrap with unwrapped-momentum (pdiff) tracking, one map or Split cycling
over ``n_maps`` sub-maps (step i uses sub-map ``(i - 1) % n_maps`` for row
i), in any combination, float32 or float64.  The Pallas kernel's TPU-only
modes (compensated sums, MXU reductions) have no argument here.  Two
libraries hold the kernel's instances (``_library``): ``rollout_step``
every one-map instance and the Split implicit one, ``rollout_split_modes``
the Split instances of the other modes.  Nothing falls back.

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
from sympgpr_tpu_torch.profiling import span
from sympgpr_tpu_torch.systems.tokamak import compute_r

Tensor = torch.Tensor

LAUNCHES = 0  # kernel launches made by rollout_in_kernel in this process

_KIND = {"per_se": 0, "se_se": 1, "per_se_freq": 2, "sum_per_se": 3}
_KIND_NAME = {v: k for k, v in _KIND.items()}
NSCAL = 12  # lx, ly, alx, aly, delta, mod_q, freq, afreq, mod_p, 3x pad
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper

# The launch layout is decided here and only here; the kernel runs the
# instance it is given and refuses a layout it cannot hold.
# The kernel's instances (csrc/rollout_kernel.cuh, launch_shapes()): the
# training points a lane holds, a block's threads and the blocks an SM runs
# at once (its __launch_bounds__, so its register budget).  Each dtype's
# list runs from the most resident to the least: more warps hide more of
# the exps' latency.  float64 lanes of more than 8 points take the one-block
# instance, too few warps to hide float64's exp and sin/cos chains (32768 x
# 1000 orbit-steps at N = 80 on an H100: 107 ms at 8 lanes of 10 points,
# 83 ms at 16 of 5), so the team is widened before that.
INSTANCES = {
    torch.float32: ((10, 288, 3), (16, 288, 2), (10, 512, 1), (16, 512, 1)),
    torch.float64: ((8, 288, 2), (16, 288, 1)),
}
P_MAX = 16           # training points a lane holds, in any instance
SOLVER_THREADS = 32  # a block's loss-solve warp, where the block has room
# a lane's row of shared memory: for each of its points (rounded up to
# whole groups of PAIRS points worked on together) FIELDS values with one
# map, and FIELDS_PER_MAP more for each further sub-map of a Split model
FIELDS = 6
FIELDS_PER_MAP = 4
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


def split_instance(n_maps: int, loss_at_new_q: bool) -> bool:
    """Whether the kernel's Split instance runs: sub-map cycling, or the
    loss check at the new q (with one map, as M = 1)."""
    return n_maps > 1 or loss_at_new_q


def launch_geometry(B: int, ns: int, nas: int, dtype: torch.dtype,
                    sm_count: int = SM_COUNT,
                    team: int | None = None, n_maps: int = 1,
                    loss_at_new_q: bool = False) -> Geometry:
    """Team, block and instance for a batch of ``B`` orbits over ``ns``
    training and ``nas`` aux points of each of ``n_maps`` sub-maps.

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
    Shared memory: the aux tables (4 columns of each sub-map), two slots
    of per-warp partial sums, two of the loss-check staging (3 values per
    team), a row per lane (``FIELDS`` values for each of its points, and
    ``FIELDS_PER_MAP`` more per further sub-map, the points rounded up to
    whole ``PAIRS``, and one value more) and, in the Split instance
    (``split_instance``), a table of ``NSCAL`` derived constants per
    sub-map.
    """
    widest = team_max(dtype)
    if ns > ns_max(dtype):
        raise ValueError(f"rollout kernel takes at most {ns_max(dtype)} "
                         f"training points in {dtype} ({widest} lanes x "
                         f"{P_MAX}); got {ns}")
    if n_maps < 1:
        raise ValueError(f"need n_maps >= 1; got {n_maps}")
    elt = torch.empty((), dtype=dtype).element_size()
    instances = INSTANCES[dtype]

    def layout(team: int) -> Geometry:
        warp_teams = max(1, 32 // team)  # teams that make up one warp
        tpb = min(max(1, BLOCK_THREADS // team), max(1, -(-B // sm_count)))
        tpb = -(-tpb // warp_teams) * warp_teams
        compute = team * tpb
        per_lane = -(-ns // team)
        pairs = PAIRS[dtype]
        fields = FIELDS + FIELDS_PER_MAP * (n_maps - 1)
        row = fields * (-(-per_lane // pairs) * pairs) + 1
        consts = NSCAL * n_maps if split_instance(n_maps,
                                                  loss_at_new_q) else 0
        smem = (4 * n_maps * nas + 4 * (compute // 32) + 6 * tpb
                + row * compute + consts) * elt
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
    """Model columns for the rollout kernel, ``n_maps`` sub-maps stacked.

    Columns are 1-D, (n_maps * ns,) and (n_maps * nas,): each sub-map's
    block zero-padded to the common stride ``ns`` / ``nas``, a multiple of
    8 (padding rows carry zero alpha, so they add nothing);
    ``a0``/``a1``/``auxa`` carry the sig factor.  ``scal`` is (n_maps,
    NSCAL) in the columns' dtype (the JAX package's layout).  The remaining
    fields are plain Python values known when packing; ``delta`` is every
    sub-map's.
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
    n_maps: int = 1

    def tensors(self) -> tuple[Tensor, ...]:
        return (self.scal, self.uq, self.uP, self.a0, self.a1, self.auxq,
                self.auxp, self.auxa)


def _pad8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def _col(vals: list[Tensor], stride: int, dtype: torch.dtype,
         device: torch.device) -> Tensor:
    """float64 values of each sub-map -> one zero-padded (M * stride,)
    column, rounded to ``dtype`` once."""
    out = torch.zeros(len(vals), stride, dtype=torch.float64, device=device)
    for m, v in enumerate(vals):
        out[m, : v.shape[0]] = v
    return out.reshape(-1).to(dtype)


def _freq_of(model) -> Tensor | float:
    if model is not None and model.kernel.name == "per_se_freq":
        return model.params[2]
    return 0.0


def pack_models(sgp: SympGP, aux: AuxGP | None, mod_q: float | None,
                mod_p: float | None = None, *,
                dtype: torch.dtype = torch.float32) -> PackedModels:
    """Preprocess one fitted (sgp, aux) pair for the rollout kernel."""
    return pack_models_split([sgp], [aux], mod_q=mod_q, mod_p=mod_p,
                             dtype=dtype)


def pack_models_split(sgps: list[SympGP], auxes: list[AuxGP | None],
                      mod_q: float | None, mod_p: float | None = None, *,
                      dtype: torch.dtype = torch.float32) -> PackedModels:
    """Stack ``M`` fitted sub-maps (Split tokamak) for the kernel's cycling.

    Every sub-map gets the same stride (the largest padded size), so the
    kernel finds sub-map m's block at ``m * ns``; all share one kernel
    kind.  Columns are formed in float64 from the models (on their device)
    and rounded to ``dtype`` once, as the JAX package's
    ``pack_models_split`` does for float32.
    """
    if len(sgps) != len(auxes) or not sgps:
        raise ValueError(f"need one aux model (or None) per sub-map; got "
                         f"{len(sgps)} and {len(auxes)}")
    kind = _KIND[sgps[0].kernel.name]
    if any(_KIND[s.kernel.name] != kind for s in sgps):
        raise ValueError("all sub-maps must share a kernel variant")
    aux0 = next((a for a in auxes if a is not None), None)
    aux_kind = _KIND[aux0.kernel.name] if aux0 is not None else 0
    deltas = {bool(a is not None and a.delta) for a in auxes}
    if len(deltas) > 1:
        raise ValueError("all sub-maps' aux models must share delta")
    dev = sgps[0].device
    f64 = torch.float64
    ns = max(_pad8(s.n_train) for s in sgps)
    nas = max(_pad8(a.X.shape[0]) if a is not None else 8 for a in auxes)
    empty = torch.zeros(0, dtype=f64, device=dev)

    def sc(x) -> Tensor:
        return torch.as_tensor(x, dtype=f64, device=dev).reshape(())

    cols = {k: [] for k in ("uq", "uP", "a0", "a1", "auxq", "auxp", "auxa")}
    scal = []
    for sgp, aux in zip(sgps, auxes):
        n = sgp.n_train
        al = sgp.alpha.to(f64).reshape(2, n)
        sig = sgp.sig.to(f64)
        cols["uq"].append(sgp.X[:, 0].to(f64))
        cols["uP"].append(sgp.X[:, 1].to(f64))
        cols["a0"].append(sig * al[0])
        cols["a1"].append(sig * al[1])
        if aux is not None:
            cols["auxq"].append(aux.X[:, 0].to(f64))
            cols["auxp"].append(aux.X[:, 1].to(f64))
            cols["auxa"].append(aux.sig.to(f64) * aux.alpha.to(f64))
        else:
            for k in ("auxq", "auxp", "auxa"):
                cols[k].append(empty)
        scal.append(torch.stack([
            sc(sgp.params[0]), sc(sgp.params[1]),
            sc(aux.params[0] if aux is not None else 1.0),
            sc(aux.params[1] if aux is not None else 1.0),
            sc(1.0 if (aux is not None and aux.delta) else 0.0),
            sc(mod_q if mod_q is not None else 0.0),
            sc(_freq_of(sgp)), sc(_freq_of(aux)),
            sc(mod_p if mod_p is not None else 0.0),
            sc(0.0), sc(0.0), sc(0.0),
        ]))
    packed = {k: _col(v, nas if k.startswith("aux") else ns, dtype, dev)
              for k, v in cols.items()}
    return PackedModels(
        **packed, scal=torch.stack(scal).to(dtype),
        kind=kind, aux_kind=aux_kind, ns=ns, nas=nas,
        delta=deltas.pop(), mod_q=mod_q, mod_p=mod_p, n_maps=len(sgps),
    )


def _tokamak_lost(P: Tensor, q: Tensor) -> Tensor:
    """Loss boundary at angle q: r > 0.5 or P < 0 (r does not depend on
    the toroidal angle)."""
    r = compute_r(P * 1e-2, q, 0.0, torch.full_like(P, 0.3))
    return (r > 0.5) | (P < 0.0)


def _models_of(pm: PackedModels, m: int = 0) -> tuple[SympGP, AuxGP]:
    """Fast-path models of sub-map ``m`` over the packed columns (sig
    folded into alpha)."""
    sc = pm.scal[m]
    t = slice(m * pm.ns, (m + 1) * pm.ns)
    a = slice(m * pm.nas, (m + 1) * pm.nas)
    one = torch.ones((), dtype=sc.dtype, device=sc.device)
    none = torch.zeros(0, dtype=sc.dtype, device=sc.device)
    kname = _KIND_NAME[pm.kind]
    aname = _KIND_NAME[pm.aux_kind]
    sgp = SympGP(
        kernel=get_kernel(kname),
        params=sc[[0, 1, 6]] if kname == "per_se_freq" else sc[[0, 1]],
        sig=one, sig2n=one, X=torch.stack([pm.uq[t], pm.uP[t]], 1), z=none,
        alpha=torch.cat([pm.a0[t], pm.a1[t]]), L=none)
    aux = AuxGP(
        kernel=get_kernel(aname), delta=pm.delta,
        params=sc[[2, 3, 7]] if aname == "per_se_freq" else sc[[2, 3]],
        sig=one, sig2n=one, X=torch.stack([pm.auxq[a], pm.auxp[a]], 1),
        z=none, alpha=pm.auxa[a], L=none)
    return sgp, aux


def rollout_reference(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int,
                      iters: int = 5, loss_check: bool = False,
                      loss_at_new_q: bool = False, explicit: bool = False,
                      track_pdiff: bool = False):
    """Plain PyTorch version of the kernel, in the dtype of the inputs.

    The fast path of ``maps.fast_apply`` over the packed columns
    (``apply_map_split_fast``: step i, making row i + 1, with sub-map ``i %
    n_maps``; with one map, ``apply_map_fast``); the implicit update
    with ``iters`` fixed Newton iterations and the aux warm start, or the
    explicit update (``explicit``; always for kind 3, Algorithm 2) without
    aux model; the tokamak loss check at the old q or, with
    ``loss_at_new_q``, at the new q (of the wrapped P); the mod_q wrap and,
    where the models were packed with ``mod_p``, the mod_p wrap.  pdiff
    sums P - p before the wrap and the check at the new q, so an orbit lost
    at the new q keeps a finite pdiff in that row and turns NaN in the
    next (at the old q, in the same row), as in the TPU kernel.  Returns
    (Q, P), or (Q, P, D) with ``track_pdiff`` (D the unwrapped momentum,
    row 0 = p0), each (nm, B).
    """
    cfg = MapConfig(explicit=explicit or pm.kind == 3,
                    mod_q=pm.scal[0, 5] if pm.mod_q is not None else None,
                    mod_p=pm.scal[0, 8] if pm.mod_p is not None else None,
                    track_pdiff=track_pdiff, newton_maxiter=iters)
    if not loss_check:
        loss_pre = loss_post = None
    elif loss_at_new_q:
        loss_pre, loss_post = None, lambda q, Q, P, i: _tokamak_lost(P, Q)
    else:
        loss_pre, loss_post = lambda q, Q, P, i: _tokamak_lost(P, q), None
    sgps, auxes = zip(*(_models_of(pm, m) for m in range(pm.n_maps)))
    traj = fast_apply.apply_map_split_fast(
        list(sgps), list(auxes), q0, p0, nm, cfg, loss_pre=loss_pre,
        loss_post=loss_post, fixed_iters=True)
    return (traj.q, traj.p, traj.pdiff) if track_pdiff else (traj.q, traj.p)


def _validate(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int,
              iters: int, team: int | None = None,
              loss_at_new_q: bool = False) -> Geometry:
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
    M = pm.n_maps
    if pm.scal.shape != (M, NSCAL):
        raise ValueError(f"scal of shape {tuple(pm.scal.shape)} for {M} "
                         f"sub-map(s)")
    sm_count = (torch.cuda.get_device_properties(dev).multi_processor_count
                if dev.type == "cuda" else SM_COUNT)
    geo = launch_geometry(q0.shape[0], pm.ns, pm.nas, dtype, sm_count, team,
                          M, loss_at_new_q)
    if geo.smem_bytes > SMEM_LIMIT:
        raise ValueError(
            f"aux tables ({M} x {pm.nas} points, {dtype}) need "
            f"{geo.smem_bytes} bytes of shared memory; a block has "
            f"{SMEM_LIMIT}")
    return geo


_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 20 + [ctypes.c_void_p]


def _library(pm: PackedModels, loss_at_new_q: bool, explicit: bool,
             track_pdiff: bool) -> str:
    """The library that holds the launch's instance: ``rollout_split_modes``
    for a Split instance (``split_instance``) of the explicit update,
    Algorithm 2 (kind 3) or the mod_p wrap with pdiff; ``rollout_step``
    for every other."""
    other_mode = (explicit or pm.kind == 3 or pm.mod_p is not None
                  or track_pdiff)
    return ("rollout_split_modes"
            if split_instance(pm.n_maps, loss_at_new_q) and other_mode
            else "rollout_step")


def _launch(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int, iters: int,
            loss_check: bool, team: int | None = None,
            loss_at_new_q: bool = False, explicit: bool = False,
            track_pdiff: bool = False):
    """Launch the kernel on CUDA tensors; ``team`` forces the lanes per
    orbit (``launch_geometry`` chooses by default).  Returns (Q, P), or
    (Q, P, D) with ``track_pdiff``."""
    global LAUNCHES
    dev, dtype = q0.device, q0.dtype
    with span("sympgpr::rollout.validate"):
        geo = _validate(pm, q0, p0, nm, iters, team, loss_at_new_q)
        lib = _library(pm, loss_at_new_q, explicit, track_pdiff)
    B = q0.shape[0]
    sym = f"{lib}_f32" if dtype == torch.float32 else f"{lib}_f64"
    with span("sympgpr::rollout.alloc"):
        fn = _build.function(lib, sym, _ARGS)
        Q = torch.empty((nm, B), dtype=dtype, device=dev)
        P = torch.empty((nm, B), dtype=dtype, device=dev)
        D = (torch.empty((nm, B), dtype=dtype, device=dev) if track_pdiff
             else None)
    ptr = _build.ptr
    with span("sympgpr::rollout.launch"), torch.cuda.device(dev):
        rc = fn(*(ptr(t) for t in pm.tensors()), ptr(q0), ptr(p0), ptr(Q),
                ptr(P), ptr(D) if track_pdiff else None, B, pm.ns, pm.nas,
                pm.n_maps, nm, iters, pm.kind, pm.aux_kind, int(loss_check),
                int(loss_at_new_q), int(explicit), int(pm.mod_p is not None),
                int(track_pdiff), geo.team, geo.teams_per_block, geo.threads,
                geo.smem_bytes, *geo.instance, _build.stream(dev))
        _build.check(rc, "rollout kernel")
    LAUNCHES += 1
    return (Q, P, D) if track_pdiff else (Q, P)


def rollout_in_kernel(pm: PackedModels, q0: Tensor, p0: Tensor, nm: int,
                      iters: int = 5, loss_check: bool = False,
                      loss_at_new_q: bool = False, explicit: bool = False,
                      track_pdiff: bool = False):
    """Full nm-step rollout; returns (Q, P), or (Q, P, D) with
    ``track_pdiff``, each (nm, B), row 0 = ICs.  ``explicit`` takes the
    explicit update (kind 3, Algorithm 2, always does).

    CPU tensors run ``rollout_reference``; CUDA tensors launch the kernel
    (and raise if it cannot).
    """
    with span("sympgpr::rollout"):
        if q0.device.type == "cpu":
            return rollout_reference(pm, q0, p0, nm, iters, loss_check,
                                     loss_at_new_q, explicit, track_pdiff)
        if q0.device.type != "cuda":
            raise ValueError(f"no rollout for device {q0.device}")
        return _launch(pm, q0, p0, nm, iters, loss_check,
                       loss_at_new_q=loss_at_new_q, explicit=explicit,
                       track_pdiff=track_pdiff)


def rollout_model(sgp: SympGP | list[SympGP],
                  aux: AuxGP | list[AuxGP | None] | None, q0: Tensor,
                  p0: Tensor, nm: int, *,
                  mod_q: float | None = 2.0 * math.pi,
                  mod_p: float | None = None, iters: int = 5,
                  explicit: bool = False, track_pdiff: bool = False,
                  loss_check: bool = False, loss_at_new_q: bool = False,
                  deployment_jitter: float | None = 1e-3,
                  dtype: torch.dtype = torch.float32):
    """Model-level fused rollout (counterpart of ``rollout_pallas``), one
    map or a list of Split sub-maps (with a list of aux models, or one
    for all).

    Re-solves alpha at the deployment jitter on the float64 models
    (``for_deployment``), packs them (each column rounded to ``dtype``
    once), and runs the rollout in ``dtype`` on the models' device.  The
    whole trajectory lives in device memory, so the time axis is not
    chunked.  Returns (Q, P), or (Q, P, D) with ``track_pdiff``, each
    (nm, B).
    """
    sgps = list(sgp) if isinstance(sgp, (list, tuple)) else [sgp]
    auxes = (list(aux) if isinstance(aux, (list, tuple))
             else [aux] * len(sgps))
    if deployment_jitter is not None:
        sgps = [s.for_deployment(deployment_jitter) for s in sgps]
        auxes = [a.for_deployment(deployment_jitter) if a is not None
                 else None for a in auxes]
    pm = pack_models_split(sgps, auxes, mod_q=mod_q, mod_p=mod_p,
                           dtype=dtype)
    dev = sgps[0].device
    if q0.device != dev or p0.device != dev:
        raise ValueError(f"initial conditions on {q0.device}, models on "
                         f"{dev}")
    q0 = q0.to(dtype).contiguous()
    p0 = p0.to(dtype).contiguous()
    return rollout_in_kernel(pm, q0, p0, nm, iters=iters,
                             loss_check=loss_check,
                             loss_at_new_q=loss_at_new_q, explicit=explicit,
                             track_pdiff=track_pdiff)
