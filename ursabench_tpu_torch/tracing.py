"""The port's counters and spans, taken at the boundaries of its layers.

**Counters** are always on and are taken only where a call begins or ends:

- ``sampler.epoch``: each epoch of an epoch sampler (``_run_epoch``), its
  milliseconds on the device between two CUDA events on the current
  stream, one before the epoch's draws and one after its program returns
  (on the CPU, on the host's clock). The events come from a pool and are
  read only once they have run: an epoch never waits for the card, and
  ``counters()`` waits for the epochs still running;
- ``ensemble.logits_all``: each call of ``Ensemble.logits_all``, a pair
  (host ns of the whole call, host ns inside the members' forwards: the
  ``functional_call`` of each member, or the one ``vmap``);
- ``program.capture``: each capture of a captured program (``_Captured``),
  (its class's name, the capture's ms on the host, the warm-up steps run
  before it);
- ``bma.pass``: the BMA passes (``accumulate_split``): their seconds (to
  the host copy of the sums), their images and their count by program path
  (``"graph"`` or ``"eager"``);
- ``conv.layout``: each forward call of a ``models.common.Conv2d``, by
  the memory format it ran in: ``"channels_last"`` (a 16-bit conv on a
  CUDA device) or ``"nchw"`` (float32, the CPU, under a ``torch.func``
  transform, or a 16-bit 1x1 conv that narrows its channels). It counts when the forward is called: a captured program's
  calls count once, at its capture, and not at its replays;
- a hand-written kernel wrapper's ``.launches``: it counts a launch
  through ``count``; a launch made while the current stream is being
  captured runs nothing then and counts once at each replay of the graph
  (``record`` collects it, ``replayed`` counts it).

The per-call counters keep the last ``CALLS`` calls, oldest first, and
count what they drop (``counters()["dropped"]``).

**Spans** are off unless ``enable()`` turns them on. Off, ``span(name)``
checks one flag and returns a shared context that does nothing. On, each
span keeps (id, parent id, request id, name, start ns, end ns) in memory,
the last ``SPANS`` of them (``spans()``; ``spans_dropped()`` counts the
rest), stamped on the clock the profiler stamps its host events with (Unix
ns, ``time.time_ns``). While the profiler records, a span also opens
``torch.profiler.record_function(name)``, so its range lies among the
profile's kernels on the same clock. A span takes its parent from the spans
open around it and, without a ``request`` of its own, its parent's request.
Spans nest in one thread. Their names:

- ``sampler.epoch`` (child ``sampler.draws``);
- ``program.warmup``, ``program.capture``, ``program.replay``;
- ``bma.pass``;
- ``ensemble.logits_all`` (children ``ensemble.member_state``,
  ``ensemble.member_forward``, ``ensemble.stack``);
- ``prediction.request``, a timed batch of the latency mode, its request
  the batch's index;
- ``experiment.<stage>``, a stage of the runner.

An operator's use: ``tracing.enable()`` under ``torch.profiler`` (its
Chrome trace then shows the spans), or ``tracing.spans()`` after a run.
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque
from typing import Callable, Dict, List

import torch

CALLS = 4096  # per-call values a counter keeps
SPANS = 65536  # spans kept while spans are on


class Calls:
    """The values of the last ``maxlen`` calls, oldest first, and the count
    of the calls dropped to keep them."""

    def __init__(self, maxlen: int = CALLS):
        self.values: deque = deque(maxlen=maxlen)
        self.dropped = 0

    def append(self, value) -> None:
        if len(self.values) == self.values.maxlen:
            self.dropped += 1
        self.values.append(value)

    def clear(self) -> None:
        self.values.clear()
        self.dropped = 0


class _Epoch:
    """One epoch's device ms, or the two events that will give it."""

    __slots__ = ("ms", "device", "start", "end")

    def __init__(self, ms=None, device=None, start=None, end=None):
        self.ms, self.device, self.start, self.end = ms, device, start, end


_epochs = Calls()
_pending: deque = deque()  # the epochs whose events have not been read, in order
_events: Dict[int, List[torch.cuda.Event]] = {}  # the free timing events, by device
_logits_all = Calls()
_captures = Calls()
_bma = {"seconds": 0.0, "images": 0, "passes": {"graph": 0, "eager": 0}}
_conv_layout = {"channels_last": 0, "nchw": 0}
_recording: List[List[Callable]] = []


# -- counters ------------------------------------------------------------------------


def _event(device: torch.device) -> torch.cuda.Event:
    free = _events.setdefault(device.index, [])
    return free.pop() if free else torch.cuda.Event(enable_timing=True)


def _read_epochs(wait: bool) -> None:
    """Reads the events of the epochs that have run (with ``wait``, of every
    epoch, waiting for those still running) and returns them to the pool."""
    while _pending:
        e = _pending[0]
        if not wait and not e.end.query():
            return
        e.end.synchronize()
        e.ms = e.start.elapsed_time(e.end)
        _events[e.device.index] += (e.start, e.end)
        e.start = e.end = None
        _pending.popleft()


def epoch_start(device: torch.device):
    """The start of an epoch on ``device``: an event recorded on its current
    stream (on the CPU, the host's clock). Pass what it returns to
    ``epoch_end``."""
    if device.type != "cuda":
        return time.perf_counter_ns()
    _read_epochs(wait=False)
    start = _event(device)
    start.record(torch.cuda.current_stream(device))
    return device, start


def epoch_end(start) -> None:
    """The end of the epoch ``epoch_start`` began, counted in
    ``sampler.epoch``."""
    if isinstance(start, int):
        _epochs.append(_Epoch(ms=(time.perf_counter_ns() - start) * 1e-6))
        return
    device, start = start
    end = _event(device)
    end.record(torch.cuda.current_stream(device))
    epoch = _Epoch(device=device, start=start, end=end)
    _epochs.append(epoch)
    _pending.append(epoch)


def logits_all(total_ns: int, members_ns: int) -> None:
    """One call of ``Ensemble.logits_all``: its host ns, and those inside
    the members' forwards."""
    _logits_all.append((total_ns, members_ns))


def captured(program: str, ms: float, warmup: int) -> None:
    """One capture of a program of class ``program``: its host ms, and the
    warm-up steps before it."""
    _captures.append((program, ms, warmup))


def bma_pass(seconds: float, images: int, path: str) -> None:
    """One BMA pass over ``images`` images on program path ``path``."""
    _bma["seconds"] += seconds
    _bma["images"] += images
    _bma["passes"][path] += 1


def conv_layout(layout: str) -> None:
    """One forward call of a conv in ``layout``, ``"channels_last"`` or
    ``"nchw"``."""
    _conv_layout[layout] += 1


def count(wrapper: Callable) -> None:
    """One launch of ``wrapper``'s kernel (its ``.launches``); under a
    capture, noted for ``record`` instead."""
    if torch.cuda.is_current_stream_capturing():
        if _recording:
            _recording[-1].append(wrapper)
        return
    wrapper.launches += 1


@contextlib.contextmanager
def record():
    """The launches captured inside the block, as a list for ``replayed``."""
    captured_launches: List[Callable] = []
    _recording.append(captured_launches)
    try:
        yield captured_launches
    finally:
        _recording.pop()


def replayed(captured_launches: List[Callable]) -> None:
    """Counts the launches of one replay of a graph that captured
    ``captured_launches``."""
    for wrapper in captured_launches:
        wrapper.launches += 1


def counters() -> dict:
    """A snapshot of every counter: ``sampler.epoch`` (ms an epoch),
    ``ensemble.logits_all`` ((total ns, members ns) a call),
    ``program.capture`` ((program, ms, warm-up steps) a capture) as lists,
    oldest first; ``bma.pass`` ({"seconds", "images", "passes": {path: n}});
    ``conv.layout`` ({layout: calls});
    ``dropped`` ({counter: calls dropped}). Waits for the epochs still
    running on a card."""
    _read_epochs(wait=True)
    return {
        "sampler.epoch": [e.ms for e in _epochs.values],
        "ensemble.logits_all": list(_logits_all.values),
        "program.capture": list(_captures.values),
        "bma.pass": {**_bma, "passes": dict(_bma["passes"])},
        "conv.layout": dict(_conv_layout),
        "dropped": {"sampler.epoch": _epochs.dropped,
                    "ensemble.logits_all": _logits_all.dropped,
                    "program.capture": _captures.dropped},
    }


def reset() -> None:
    """Empties every counter (not the wrappers' ``.launches``) and the spans
    kept."""
    _read_epochs(wait=True)
    for calls in (_epochs, _logits_all, _captures, _spans):
        calls.clear()
    _bma.update(seconds=0.0, images=0, passes={"graph": 0, "eager": 0})
    _conv_layout.update(channels_last=0, nchw=0)


# -- spans ---------------------------------------------------------------------------


_on = False
_spans = Calls(SPANS)
_ids = itertools.count(1)
_open: List["_Span"] = []  # the spans open now, innermost last


class _Off:
    """The span of ``span`` while spans are off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("id", "parent", "request", "name", "start", "annotation")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        parent = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = parent.id if parent else None
        if self.request is None and parent is not None:
            self.request = parent.request
        _open.append(self)
        self.start = time.time_ns()
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end = time.time_ns()
        _open.pop()
        _spans.append((self.id, self.parent, self.request, self.name, self.start, end))
        return False


def span(name: str, request=None):
    """A span named ``name`` around a ``with`` block, of request
    ``request`` (its parent's where None); does nothing while spans are
    off."""
    if not _on:
        return _OFF
    return _Span(name, request)


def enable() -> None:
    """Spans on."""
    global _on
    _on = True


def disable() -> None:
    """Spans off; the spans kept stay."""
    global _on
    _on = False


def spans() -> List[tuple]:
    """The spans kept, (id, parent id, request id, name, start ns, end ns),
    in the order they ended; stamps in Unix ns, the profiler's host clock."""
    return list(_spans.values)


def spans_dropped() -> int:
    """The spans dropped to keep the last ``SPANS``."""
    return _spans.dropped
