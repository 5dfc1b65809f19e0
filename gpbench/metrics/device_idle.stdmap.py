"""Share of the traced window in which no operation ran on the device
(kernels, copies, memsets): 1 - (union of their intervals) / window."""
from gpbench.readers import idle_pct as read  # noqa: F401
