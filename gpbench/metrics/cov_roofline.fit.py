"""The covariance kernels' share of their roofline: the build launches'
bytes (Ky written) and the fused contraction launches' bytes (half of S
read), each at 3.35 TB/s, over the device time of cov_fwd_kernel,
cov_bwd_kernel and cov_reduce_kernel."""
from gpbench import rooflines
from gpbench.readers import elt, roofline_pct


def read(ctx):
    cfg = ctx.driver.config
    N, e = cfg["N"], elt(cfg)
    fwd = 1e3 * rooflines.cov_build_bytes(N, e) / rooflines.HBM_BYTES_PER_S
    bwd = 1e3 * rooflines.cov_contraction_bytes(N, e) / \
        rooflines.HBM_BYTES_PER_S
    return roofline_pct(
        ctx, ("cov_fwd_kernel", "cov_bwd_kernel", "cov_reduce_kernel"),
        lambda n: n["cov_fwd_kernel"] * fwd + n["cov_bwd_kernel"] * bwd)
