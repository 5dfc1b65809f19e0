"""The syrk's share of its roofline: n^3/3 operations a launch on the
float64 tensor cores at 67 TFLOP/s, over the syrk launches' device time."""
from gpbench import rooflines
from gpbench.readers import roofline_pct


def read(ctx):
    n = 2 * ctx.driver.config["N"]
    b = 1e3 * rooflines.syrk_flops(n) / rooflines.DMMA_FLOP_PER_S
    return roofline_pct(ctx, ("syrk_kernel",),
                        lambda c: c["syrk_kernel"] * b)
