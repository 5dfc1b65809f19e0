"""sympgpr_tpu_torch — symplectic Gaussian-process regression in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch and CUDA port of the JAX package ``sympgpr_tpu``, which stays
the reference.  This package imports no JAX: it shares only the ``.npz``
model-artifact format with it.  Learn the generating function of a
symplectic map from derivative observations with a GP, then iterate the
learned map for long-time Hamiltonian dynamics (so far: the tokamak
field-line workload, single map).
"""

from sympgpr_tpu_torch.kernels import (
    PER_SE,
    PER_SE_FREQ,
    SE_SE,
    SUM_PER_SE,
    Kernel,
    get_kernel,
)
from sympgpr_tpu_torch.gp.covariance import build_K, build_Kreg
from sympgpr_tpu_torch.gp.likelihood import nll, nll_reg
from sympgpr_tpu_torch.gp.model import (
    AuxGP,
    SympGP,
    load_models,
    models_from_arrays,
    save_models,
)
from sympgpr_tpu_torch.gp.train import fit_auxgp, fit_sympgp, minimize_lbfgs
from sympgpr_tpu_torch.maps.symplectic import MapConfig, Trajectory, apply_map
from sympgpr_tpu_torch.maps.fast_apply import apply_map_fast

__version__ = "0.1.0"
