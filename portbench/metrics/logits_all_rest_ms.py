"""``logits_all_rest_ms``: the median over the window's requests of the host
milliseconds ``Ensemble.logits_all`` spent outside the members' forwards
(selecting each member's state, the layout rule, the dropout probe, the
stack), from the program's ``ensemble.logits_all`` counter."""

import statistics

from portbench.counters import window_requests


def read(run):
    calls = window_requests(run)
    return None if calls is None else statistics.median(t - m for t, m in calls) * 1e-6
