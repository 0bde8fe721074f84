"""``members_enqueue_ms``: the median over the window's requests of the host
milliseconds ``Ensemble.logits_all`` spent inside the members' forwards
(each member's ``functional_call``, or the one ``vmap``), from the
program's ``ensemble.logits_all`` counter."""

import statistics

from portbench.counters import window_requests


def read(run):
    calls = window_requests(run)
    return None if calls is None else statistics.median(m for _, m in calls) * 1e-6
