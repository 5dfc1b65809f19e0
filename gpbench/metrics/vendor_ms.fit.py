"""Device ms an Adam step in operations that are not the program's
hand-written kernels (cuSOLVER's Cholesky, cuBLAS's solves, PyTorch's
elementwise kernels and copies), over the traced window's Adam steps (one
syrk launch each)."""
from gpbench.readers import vendor_ms_per_step as read  # noqa: F401
