"""``epoch_device_ms``: the median over the window's epochs of the
milliseconds each took on the card, from the program's ``sampler.epoch``
counter (CUDA events on the current stream, one before an epoch's draws and
one after its program returns)."""

import statistics

from portbench.counters import window_epochs


def read(run):
    ms = window_epochs(run)
    return None if ms is None else statistics.median(ms)
