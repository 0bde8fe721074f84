"""Launch counts of the hand-written kernels' wrappers.

A wrapper adds one to its ``.launches`` where it launches its kernel
(``count``). A launch made while the current stream is being captured into
a CUDA graph runs nothing then: it is not counted, and runs (and is
counted) each time the graph is replayed. ``record()`` collects the
wrappers whose launches were captured under it; ``replayed(captured)``
counts them once for a replay of that graph.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

import torch

_recording: List[List[Callable]] = []


def count(wrapper: Callable) -> None:
    """One launch of ``wrapper``'s kernel; under a capture, noted for
    ``record``."""
    if torch.cuda.is_current_stream_capturing():
        if _recording:
            _recording[-1].append(wrapper)
        return
    wrapper.launches += 1


@contextlib.contextmanager
def record():
    """The launches captured inside the block, as a list for ``replayed``."""
    captured: List[Callable] = []
    _recording.append(captured)
    try:
        yield captured
    finally:
        _recording.pop()


def replayed(captured: List[Callable]) -> None:
    """Counts the launches of one replay of a graph that captured
    ``captured``."""
    for wrapper in captured:
        wrapper.launches += 1
