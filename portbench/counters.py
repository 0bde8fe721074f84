"""The program's own counters (``ursabench_tpu_torch.tracing``), as the
per-layer metrics read them: the calls of the window, found at the tail of
a counter. Every counter is taken at a call's edges and is always on, so a
run reads the same with or without them; a program without them reads
nothing (None)."""

from __future__ import annotations

from typing import Optional


def program_counters() -> Optional[dict]:
    """``tracing.counters()`` of the program, or None where it has none."""
    try:
        from ursabench_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.counters()


def _window(calls: list, window: int, traced: int) -> Optional[list]:
    """The ``window`` calls before the last ``traced``, or None where the
    counter holds fewer."""
    if window <= 0 or len(calls) < window + traced:
        return None
    return calls[len(calls) - traced - window: len(calls) - traced]


def window_epochs(run) -> Optional[list]:
    """The device ms of each of a sampler window's epochs (``sampler.epoch``):
    the ``window["epochs"]`` before the one epoch a traced run adds."""
    counters = program_counters()
    if counters is None or "epochs" not in run.window:
        return None
    return _window(counters["sampler.epoch"], int(run.window["epochs"]),
                   0 if run.trace is None else 1)


def window_requests(run) -> Optional[list]:
    """(host ns of ``logits_all``, host ns inside the members' forwards) of
    each request of a requests window (``ensemble.logits_all``): the
    ``window["requests"]`` before the ``traced_requests`` of a traced run."""
    counters = program_counters()
    if counters is None or "requests" not in run.window:
        return None
    traced = 0 if run.trace is None else int(run.cell.traffic["traced_requests"])
    return _window(counters["ensemble.logits_all"], int(run.window["requests"]), traced)

