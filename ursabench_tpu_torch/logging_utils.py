"""Structured metric logging.

Counterpart of ``ursabench_tpu/logging_utils.py``: ``MetricLogger`` writes
one JSON line per ``log`` call and, when the ``wandb`` package is installed
and a run is active, logs the same metrics there; ``silent`` suppresses a
function's stdout (timing without printing).
"""

from __future__ import annotations

import contextlib
import io
import json
import time
from typing import Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path else None
        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore
            except ImportError:
                wandb = None
            if wandb is not None and wandb.run is not None:
                self._wandb = wandb

    def log(self, metrics: dict, step: Optional[int] = None):
        record = {"ts": time.time(), **({"step": step} if step is not None else {}),
                  **metrics}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self.echo:
            print(record)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def silent(fn):
    """Decorator: ``fn`` runs with its stdout discarded."""

    def wrapper(*args, **kwargs):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(*args, **kwargs)

    return wrapper
