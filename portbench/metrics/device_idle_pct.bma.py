"""``device_idle_pct.bma``: the share of the traced stretch (a BMA pass, or a
run of requests) in which nothing ran on the card: 100 less the union of
its activities' intervals over the stretch."""

from portbench.trace import idle_pct


def read(run):
    if run.trace is None or "members" not in run.window:
        return None
    return idle_pct(run.trace)
