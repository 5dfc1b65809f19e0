"""sympgpr_tpu_torch — symplectic Gaussian-process regression in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch and CUDA port of the JAX package ``sympgpr_tpu``, which stays
the reference.  This package imports no JAX: it shares only the ``.npz``
model-artifact format with it.  Learn the generating function of a
symplectic map from derivative observations with a GP, then iterate the
learned map for long-time Hamiltonian dynamics (the tokamak field lines,
one map or Split, and at large N; the pendulum, the perturbed pendulum,
the standard map and Henon-Heiles); sample the hyperparameter posterior
with HMC or NUTS and compute Sobol indices of the tokamak's chaos; fit at
large N block-cyclically over ``torch.distributed`` ranks.
"""

from sympgpr_tpu_torch.kernels import (
    PER_SE,
    PER_SE_FREQ,
    SE_SE,
    SUM_PER_SE,
    Kernel,
    get_kernel,
)
from sympgpr_tpu_torch.gp.covariance import build_K, build_Kreg, pack_points
from sympgpr_tpu_torch.gp.likelihood import nll, nll_batched, nll_reg
from sympgpr_tpu_torch.gp.model import (
    AuxGP,
    SympGP,
    load_models,
    models_from_arrays,
    save_models,
)
from sympgpr_tpu_torch.gp.train import (
    fit_auxgp,
    fit_batch_adam,
    fit_sympgp,
    fit_sympgp_ondevice,
    fit_sympgp_separable,
    minimize_adam,
    minimize_cmaes,
    minimize_lbfgs,
)
from sympgpr_tpu_torch.gp.hmc import sample_hmc, sample_hmc_sharded
from sympgpr_tpu_torch.gp.nuts import sample_nuts, sample_nuts_sharded
from sympgpr_tpu_torch.maps.symplectic import (
    MapConfig,
    Trajectory,
    apply_map,
    apply_map_split,
    calc_P,
    calc_Q,
    stack_models,
)
from sympgpr_tpu_torch.maps.fast_apply import apply_map_fast
from sympgpr_tpu_torch.gp.predict import predict_aux, predict_df

__version__ = "0.1.0"
