"""Helpers of the distributed tests of the PyTorch port
(``tests/test_torch_distributed_*.py``).

``launch`` starts a world of CPU ranks over gloo, one spawned process
each, meeting through a ``file://`` rendezvous under the test's temporary
directory (never a TCP port: the suite runs under pytest-xdist).  Each
rank runs one case function of this module by name, since spawn pickles
functions by their module, and saves what it computed for the parent,
which holds it against the JAX package.  Ranks import no JAX and run one
intra-op thread.  Inputs are made with numpy from seeds, the same in the
parent and in every rank.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# the hyperparameters of the JAX package's tests/test_large.py
P2, SIG, S2N = (0.9, 1.3), 2.0, 1e-6
THETA = (0.1, -0.2, 0.3)
# the worlds and their meshes: config -> (world size, axis size D of the
# large-N functions); "2x2" is make_mesh's (dp, kp) mesh of four ranks,
# whose kp axis has D = 2
CONFIGS = {"kp2": (2, 2), "kp4": (4, 4), "2x2": (4, 2)}


def data(N: int, seed: int):
    """(X (N, 2), z (2N,)) float64 numpy, as tests/test_large.py::_data."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(0, 2 * np.pi, N), rng.uniform(-1.0, 1.0, N)],
                 1)
    return X, rng.normal(size=2 * N) * 0.1


def spd(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def t64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float64))


# --------------------------------------------------------------------------
# spawning

class World:
    """A started world of ranks; ``results`` waits for them."""

    def __init__(self, procs, out: Path):
        self.procs, self.out = procs, out
        self._res = None

    def results(self, timeout: float = 900.0) -> list:
        """Each rank's saved result, in rank order; raises with the ranks'
        tracebacks if one failed, and stops them all if they overrun."""
        if self._res is not None:
            return self._res
        end = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        errs = "".join(f.read_text() for f in sorted(self.out.glob("*.err")))
        if hung or any(p.exitcode != 0 for p in self.procs):
            raise RuntimeError(
                f"ranks failed (exit codes {[p.exitcode for p in self.procs]}"
                f"{', timed out' if hung else ''}):\n{errs}")
        self._res = [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                     for r in range(len(self.procs))]
        return self._res


def launch(world: int, case: str, out_dir, *args) -> World:
    """Start ``world`` ranks running ``case(rank, world, *args)``."""
    out = Path(out_dir) / f"world{world}"
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, str(out), case, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return World(procs, out)


def _rank(rank: int, world: int, out: str, case: str, args) -> None:
    for m in ("jax", "jaxlib", "optax", "sympgpr_tpu"):
        sys.modules[m] = None  # a rank imports no JAX
    torch.set_num_threads(1)
    from sympgpr_tpu_torch.distributed import init as dinit

    try:
        dinit.initialize("cpu", init_method=f"file://{out}/rendezvous",
                         world_size=world, rank=rank)
        res = globals()[case](rank, world, *args)
        torch.save(res, f"{out}/rank{rank}.pt")
    except BaseException:
        Path(f"{out}/rank{rank}.err").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dinit.shutdown()


def meshes(world: int) -> dict:
    """config -> mesh of this world (every rank builds every mesh)."""
    from torch.distributed.device_mesh import init_device_mesh

    from sympgpr_tpu_torch.distributed.sharded import make_mesh

    if world == 2:
        return {"kp2": init_device_mesh("cpu", (2,), mesh_dim_names=("kp",))}
    return {"kp4": init_device_mesh("cpu", (4,), mesh_dim_names=("kp",)),
            "2x2": make_mesh("cpu")}


def _counting(monkey_module, name: str, counter: list):
    """Wrap ``monkey_module.name`` so each call appends to ``counter``;
    returns the original."""
    real = getattr(monkey_module, name)

    def counting(*a, **k):
        counter.append(1)
        return real(*a, **k)

    setattr(monkey_module, name, counting)
    return real


# --------------------------------------------------------------------------
# the cases each rank runs

def linalg_cases(rank: int, world: int) -> dict:
    """distributed_cholesky, the slab, the NLL (two kernels) and alpha."""
    from sympgpr_tpu_torch.distributed import large
    from sympgpr_tpu_torch.kernels import PER_SE, SUM_PER_SE
    from sympgpr_tpu_torch.linalg.cholesky import distributed_cholesky

    out = {}
    for name, mesh in meshes(world).items():
        r = {"chol256": distributed_cholesky(t64(spd(256, 2)), mesh,
                                             block=32),
             "chol200": distributed_cholesky(t64(spd(200, 5)), mesh,
                                             block=16)}
        X, z = map(t64, data(40, 0))
        r["nll"] = large.sharded_nll_large(PER_SE, mesh, P2, SIG, S2N, X, z,
                                           block=8)
        X, z = map(t64, data(24, 1))
        r["nll_sum"] = large.sharded_nll_large(SUM_PER_SE, mesh, P2, SIG,
                                               S2N, X, z, block=8)
        X, z = map(t64, data(36, 2))
        r["alpha"] = large.sharded_alpha_large(PER_SE, mesh, P2, SIG, S2N, X,
                                               z, block=8)
        X, _ = data(32, 3)
        r["slab"] = large.build_K_cyclic(PER_SE, mesh, P2, SIG, S2N, t64(X),
                                         block=8)
        out[name] = r
    return out


def grad_cases(rank: int, world: int) -> dict:
    """Value and gradient with the factorizations counted, an indefinite
    Ky, fit_large (plain and with a deployment jitter) and the workload's
    run_distributed."""
    from sympgpr_tpu_torch.distributed import large
    from sympgpr_tpu_torch.kernels import PER_SE
    from sympgpr_tpu_torch.workloads import large_n

    out = {}
    for name, mesh in meshes(world).items():
        r = {}
        X, z = map(t64, data(40, 4))
        calls: list = []
        real = _counting(large, "_factorize_cyclic", calls)
        try:
            r["vg"] = large.sharded_nll_large_value_and_grad(
                PER_SE, mesh, t64(THETA), S2N, X, z, block=8)
            r["vg_factorizations"] = len(calls)
            hyp = 10.0 ** t64(THETA)
            large.sharded_nll_large(PER_SE, mesh, hyp[:-1], hyp[-1], S2N, X,
                                    z, block=8)
            r["nll_factorizations"] = len(calls) - r["vg_factorizations"]
            # duplicated points make K exactly singular: the escalation
            # must re-factor and still give finite values
            X0, z = data(48, 9)
            X = t64(np.concatenate([X0[:24], X0[:24]]))
            calls.clear()
            r["indefinite_nll"] = large.sharded_nll_large(
                PER_SE, mesh, P2, 1.0, 1e-18, X, t64(z), block=8)
            r["indefinite_factorizations"] = len(calls)
            r["indefinite_vg"] = large.sharded_nll_large_value_and_grad(
                PER_SE, mesh, t64([0.0, 0.1, 0.0]), 1e-18, X, t64(z),
                block=8)
        finally:
            large._factorize_cyclic = real
        X, z = map(t64, data(48, 6))
        model, hist = large.fit_large(PER_SE, mesh, X, z, 1e-6,
                                      [0.0, 0.0, 0.3], steps=8, lr=3e-2,
                                      block=8)
        r["fit"] = dict(params=model.params, sig=model.sig, alpha=model.alpha,
                        sig2n=model.sig2n, hist=hist)
        X, z = map(t64, data(32, 8))
        model, _ = large.fit_large(PER_SE, mesh, X, z, 1e-10,
                                   [0.0, 0.0, 0.3], steps=2, block=8,
                                   deployment_jitter=1e-3)
        r["jitter"] = dict(params=model.params, sig=model.sig,
                           alpha=model.alpha, sig2n=model.sig2n)
        out[name] = r
    out["run_distributed"] = large_n.run_distributed(
        N=24, steps=3, block=8, device="cpu")
    return out


def predict_cases(rank: int, world: int, alpha_path: str) -> dict:
    """predict_df_large fresh and with a reused factor (factorizations
    counted), and the refusal of factors of another geometry."""
    from sympgpr_tpu_torch.distributed import large
    from sympgpr_tpu_torch.gp.model import SympGP
    from sympgpr_tpu_torch.kernels import PER_SE

    X, z = map(t64, data(40, 9))
    model = SympGP.from_alpha(PER_SE, P2, SIG, S2N, X, z,
                              t64(np.load(alpha_path)))
    V, V2 = t64(data(6, 10)[0]), t64(data(7, 13)[0])
    out = {}
    factors = {}
    ms = meshes(world)
    for name, mesh in ms.items():
        r = {"fresh": large.predict_df_large(model, mesh, V, block=8)}
        calls: list = []
        real = _counting(large, "_factorize_robust", calls)
        try:
            factor = large.factorize_large(model, mesh, block=8)
            r["factorizations_factor"] = len(calls)
            r["reused"] = large.predict_df_large(model, mesh, V,
                                                 factor=factor)
            r["reused2"] = large.predict_df_large(model, mesh, V2,
                                                  factor=factor)
            r["factorizations_after"] = len(calls)
        finally:
            large._factorize_robust = real
        refused = []
        for bad in (large.DistFactor(factor.slabL, 41, 8, "kp", factor.D),
                    large.DistFactor(factor.slabL, 40, 8, "dp", factor.D),
                    large.DistFactor(factor.slabL, 40, 8, "kp",
                                     2 * factor.D)):
            try:
                large.predict_df_large(model, mesh, V, factor=bad)
            except ValueError as e:
                refused.append(str(e))
        r["refused"] = refused
        factors[name] = factor
        out[name] = r
    if world == 4:  # a factor of the 2x2 mesh's kp axis (D=2) on D=4
        try:
            large.predict_df_large(model, ms["kp4"], V,
                                   factor=factors["2x2"])
            out["cross_mesh_refused"] = None
        except ValueError as e:
            out["cross_mesh_refused"] = str(e)
    return out


# the sharded cases' sizes: the map step and apply_map's batch, the
# rollouts' batch (JAX's rollout takes whole 128-lane tiles a device) and
# steps, the restarts' Adam steps, the samplers' chains and transitions
B_MAP, NM_MAP = 16, 8
B_ROLL, NM_ROLL = 256, 4
RESTART_STEPS = 50
X0S = [[0.0, 0.0, 0.3], [0.5, -0.5, 0.0], [-0.5, 0.5, 0.5],
       [0.2, 0.2, 0.2]] * 2  # tests/test_distributed.py
CHAINS, SAMPLES, WARMUP, SAMPLER_SEED = 4, 4, 4, 3


def map_cfg_kw() -> dict:
    return dict(newton_tol=1e-12, newton_maxiter=30)


def small_data(n: int = 8, seed: int = 0):
    """tests/test_distributed.py::_data: (X, z) numpy."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, 2)), rng.normal(size=2 * n)


def orbit_ics(B: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2 * np.pi, B), rng.uniform(-0.5, 0.5, B)


def port_logprob():
    """The samplers' target: the N=8 GP posterior of ``small_data`` at
    sig2n 1e-2, where HMC's fixed step of 0.05 is accepted (at 1e-8 every
    proposal is rejected and every chain stays at its start)."""
    from sympgpr_tpu_torch.gp import hmc
    from sympgpr_tpu_torch.kernels import PER_SE

    X, z = map(t64, small_data())
    return hmc.nll_logprob(PER_SE, X, z, 1e-2)


def sampler_x0s() -> torch.Tensor:
    """Every chain starts at the same point: shards differ by their
    seeds alone."""
    return t64(np.tile([0.0, 0.0, 0.3], (CHAINS, 1)))


def sampler_kw(kind: str) -> dict:
    kw = dict(n_warmup=WARMUP, seed=SAMPLER_SEED)
    return {**kw, "n_leapfrog": 4} if kind == "hmc" else {**kw,
                                                         "max_depth": 4}


def restart_objective():
    from sympgpr_tpu_torch.gp.likelihood import nll
    from sympgpr_tpu_torch.kernels import PER_SE

    X, z = map(t64, small_data())

    def objective(theta):
        hyp = 10.0 ** theta
        return nll(PER_SE, hyp[:2], hyp[2], t64(1e-8), X, z)

    return objective


def sharded_cases(rank: int, world: int, models_path: str) -> dict:
    """make_mesh, the map step and apply_map over dp, the rollout over dp
    (float64 and float32 columns), the batch check, the restarts and the
    two samplers."""
    from sympgpr_tpu_torch.distributed import sharded
    from sympgpr_tpu_torch.gp.hmc import sample_hmc_sharded
    from sympgpr_tpu_torch.gp.model import load_models
    from sympgpr_tpu_torch.gp.nuts import sample_nuts_sharded
    from sympgpr_tpu_torch.maps.symplectic import MapConfig
    from sympgpr_tpu_torch.ops import cuda_step as cs

    from sympgpr_tpu_torch.distributed.init import hybrid_mesh

    mesh = sharded.make_mesh("cpu")
    hybrid = hybrid_mesh(device="cpu")
    r = {"mesh": (tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names)),
         "hybrid": (tuple(hybrid.mesh.shape),
                    tuple(hybrid.mesh_dim_names))}
    sgp, aux, _ = load_models(models_path, "cpu")
    cfg = MapConfig(**map_cfg_kw())
    q0, p0 = map(t64, orbit_ics(B_MAP, 1))
    qs, ps = sharded.shard_orbits(mesh, q0, p0)
    r["map_step"] = sharded.make_sharded_map_step(cfg, mesh)(sgp, aux, qs, ps)
    r["apply_map"] = sharded.apply_map_sharded(mesh, sgp, aux, q0, p0,
                                               NM_MAP, cfg)
    q0, p0 = map(t64, orbit_ics(B_ROLL, 2))
    for dtype in (torch.float64, torch.float32):
        pm = cs.pack_models(sgp, aux, mod_q=2 * math.pi, dtype=dtype)
        r[f"rollout_{dtype}"] = sharded.rollout_in_kernel_sharded(
            mesh, pm, q0.to(dtype), p0.to(dtype), NM_ROLL)
    try:
        sharded.rollout_in_kernel_sharded(mesh, pm, q0[:-1].float(),
                                          p0[:-1].float(), NM_ROLL)
        r["odd_batch"] = None
    except ValueError as e:
        r["odd_batch"] = str(e)
    r["restarts"] = sharded.fit_restarts_sharded(
        restart_objective(), X0S, mesh, steps=RESTART_STEPS, device="cpu")
    r["hmc"] = sample_hmc_sharded(port_logprob(), sampler_x0s(), mesh,
                                  SAMPLES, **sampler_kw("hmc"))
    r["nuts"] = sample_nuts_sharded(port_logprob(), sampler_x0s(), mesh,
                                    SAMPLES, **sampler_kw("nuts"))
    return r
