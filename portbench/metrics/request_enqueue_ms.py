"""``request_enqueue_ms``: the median over the window's requests of the
seconds from a request's issue until ``Ensemble.logits_all`` returns, before
the copy to the host waits on the card, in milliseconds: the host's side of
a request."""

import statistics


def read(run):
    enq = run.window.get("enqueue")
    if not enq:
        return None
    return statistics.median(enq) * 1e3
