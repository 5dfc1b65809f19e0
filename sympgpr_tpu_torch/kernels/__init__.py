from sympgpr_tpu_torch.kernels.variants import (
    KERNELS,
    PER_SE,
    PER_SE_FREQ,
    SE_SE,
    SUM_PER_SE,
    Kernel,
    get_kernel,
)

__all__ = [
    "KERNELS",
    "PER_SE",
    "PER_SE_FREQ",
    "SE_SE",
    "SUM_PER_SE",
    "Kernel",
    "get_kernel",
]
