"""``epoch_excess_pct``: what a slow phase cost the window, from the
program's ``sampler.epoch`` counter: 100 x (the mean of the window's epoch
device ms over the median of its second half, less 1). A window whose
epochs all run at one pace reads about 0; slow epochs at its start read
their share of the window's time above that pace."""

import statistics

from portbench.counters import window_epochs


def read(run):
    ms = window_epochs(run)
    if ms is None:
        return None
    return 100.0 * (statistics.fmean(ms) / statistics.median(ms[len(ms) // 2:]) - 1.0)
