"""Serialized inference engines: the counterpart of TensorRT engine files.

Counterpart of ``ursabench_tpu/profiling/export.py``, with ``torch.export``
in place of ``jax.export``. ``export_bma_engine`` traces the fixed-shape BMA
forward (an NCHW float32 batch -> the members' mean probabilities) of a
stacked ensemble, its weights held in the program as constants, in fp32 or
bf16: every float weight and the input cast to the compute dtype, the
logits to float32 before the softmax, as ``latency._prep_forward`` builds
the engines the latency sweep times. ``save_engine`` writes the program and
``load_engine`` gives a callable that runs it without the model's Python
code.

The members run one after another inside the traced graph (the latency
engines' ``"scan"`` strategy): a ``torch.func.vmap`` over them traces, but
the program it gives does not serialize in every torch release
(``torch.export.save`` refuses its ``lazy_load_decompositions`` node in
torch 2.11).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .latency import _example_input, _prep_forward


class _Engine(nn.Module):
    """``fn(stored, x)`` with ``stored``'s tensors as the module's buffers,
    so that export holds them as constants of the program."""

    def __init__(self, fn: Callable, stored: dict):
        super().__init__()
        self.fn, self.keys = fn, list(stored)
        for i, k in enumerate(self.keys):
            self.register_buffer(f"w{i}", stored[k])

    def forward(self, x):
        stored = {k: getattr(self, f"w{i}") for i, k in enumerate(self.keys)}
        return self.fn(stored, x)


def export_bma_engine(module: nn.Module, state, batch_size: int, input_shape,
                      precision: str = "fp32") -> torch.export.ExportedProgram:
    """The exported BMA forward of the stacked ensemble ``state`` (every
    entry (S, ...), on the device the engine runs on) at a fixed batch of
    ``input_shape`` (C, H, W) float32 images. ``precision`` is "fp32" or
    "bf16"."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"export covers fp32 and bf16, got {precision!r}")
    device = next(iter(state.values())).device
    module.to(device)
    fn, stored = _prep_forward(module, state, precision, "scan")
    x = _example_input(batch_size, input_shape, device)
    with torch.no_grad():
        return torch.export.export(_Engine(fn, stored).eval(), (x,))


def save_engine(path: str, exported: torch.export.ExportedProgram) -> None:
    torch.export.save(exported, path)


def load_engine(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an engine file; returns a callable(x) -> probabilities."""
    return torch.export.load(path).module()
