"""``device_idle_pct.sampler``: the share of the traced stretch (one epoch of
the sampler) in which nothing ran on the card: 100 less the union of its
activities' intervals over the stretch."""

from portbench.trace import idle_pct


def read(run):
    if run.trace is None or "epochs" not in run.window:
        return None
    return idle_pct(run.trace)
