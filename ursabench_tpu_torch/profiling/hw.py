"""Hardware peaks and FLOP counts for fraction-of-peak reporting.

Counterpart of ``ursabench_tpu/profiling/hw.py``. The peak table is keyed by
a substring of ``torch.cuda.get_device_name``; the FLOP count of a forward
comes from ``torch.utils.flop_counter.FlopCounterMode`` (convolutions and
matrix products, 2 FLOPs per multiply-add), where the JAX package asks XLA's
cost model. ``card_line`` reads the card's name and power limit from
``nvidia-smi``, to stand beside every number measured on it; ``event_ms``
times a device function with CUDA events.
"""

from __future__ import annotations

import copy
import subprocess
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

# lower-cased device-name substring -> (bf16 dense peak FLOP/s, HBM bytes/s),
# from NVIDIA's H100 and H200 data sheets (dense, without sparsity), checked
# in this order
_PEAKS = (
    ("h100 pcie", (756e12, 2.0e12)),
    ("h100 80gb hbm3", (989e12, 3.35e12)),  # the SXM part's device name
    ("h100 sxm", (989e12, 3.35e12)),
    ("h200", (989e12, 4.8e12)),
)


def device_name(device: Union[str, torch.device, None] = None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device (default: the current
    one), or the device's type, e.g. "cpu"."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def device_peaks(device: Union[str, torch.device, None] = None
                 ) -> Tuple[Optional[float], Optional[float]]:
    """(bf16 peak FLOP/s, HBM bytes/s) of ``device``, which is a device name
    (as ``torch.cuda.get_device_name`` gives it), a ``torch.device`` or None
    for the current device; ``(None, None)`` for a device not in the
    table."""
    if isinstance(device, str) and device.split(":")[0] not in ("cuda", "cpu"):
        name = device
    else:
        name = device_name(device)
    name = name.lower()
    for key, peaks in _PEAKS:
        if key in name:
            return peaks
    return None, None


@torch.no_grad()
def forward_flops(module: torch.nn.Module, x: torch.Tensor) -> int:
    """FLOPs of one eval-mode forward of ``module`` on ``x``."""
    was_training = module.training
    module.eval()
    try:
        with FlopCounterMode(display=False) as counter:
            module(x)
    finally:
        module.train(was_training)
    return int(counter.get_total_flops())


def train_step_flops(module: torch.nn.Module, batch_size: int, input_shape) -> int:
    """FLOPs of one training step of ``module`` (train-mode forward, mean
    cross entropy, backward) on a ``(batch_size, *input_shape)`` batch,
    counted on a copy on the meta device: from the shapes, without
    computing anything."""
    meta = copy.deepcopy(module).to("meta").train()
    x = torch.empty((batch_size,) + tuple(input_shape), device="meta")
    with FlopCounterMode(display=False) as counter:
        logits = meta(x)
        labels = torch.zeros(batch_size, dtype=torch.long, device="meta")
        F.cross_entropy(logits, labels).backward()
    return int(counter.get_total_flops())


def event_ms(fn, reps: int, warm_up: int = 0) -> float:
    """Device milliseconds per call of ``fn``, from two CUDA events around
    ``reps`` back-to-back calls, after ``warm_up`` untimed calls."""
    for _ in range(warm_up):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card. Raises if nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]
