"""``k1_roofline``: kernel K1's (``sghmc_update``) share of its roofline: its
byte bound (each parameter of each chain reads p, v, g and writes p, v:
20 bytes, at the card's HBM rate) over its device time a launch, the mean
of the traced ``sghmc_update`` kernels. None where the trace holds none."""

from portbench.reference.layers import parameter_leaves


def read(run):
    if run.trace is None or "chains" not in run.window:
        return None
    count, seconds = run.trace.kernels("sghmc_update")
    if not count:
        return None
    params = sum(leaf.numel for leaf in parameter_leaves(run.cell.model().leaves))
    bound = 20.0 * params * run.window["chains"] / run.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / (seconds / count)
