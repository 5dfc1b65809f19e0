"""The triangular matmul's share of its roofline: each blocked inverse's
products (``rooflines.tri_inv_flops``) at 67 TFLOP/s, times the inverses
the trace holds (its trimm launches over the launches of one inverse:
two a doubling level), over the trimm launches' device time."""
from gpbench import rooflines
from gpbench.readers import roofline_pct


def read(ctx):
    n = 2 * ctx.driver.config["N"]
    base, m, levels = 512, 512, 0
    while m < n:
        m, levels = 2 * m, levels + 1
    per_inv = 1e3 * rooflines.tri_inv_flops(n, base) / \
        rooflines.FP32_FLOP_PER_S
    return roofline_pct(ctx, ("trimm_kernel",),
                        lambda c: c["trimm_kernel"] / (2 * levels) * per_inv)
