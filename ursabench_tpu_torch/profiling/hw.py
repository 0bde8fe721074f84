"""Hardware peaks and FLOP counts for fraction-of-peak reporting.

Counterpart of ``ursabench_tpu/profiling/hw.py``. The peak table is keyed by
a substring of ``torch.cuda.get_device_name``; the FLOP count of a forward
comes from ``torch.utils.flop_counter.FlopCounterMode`` (convolutions and
matrix products, 2 FLOPs per multiply-add), where the JAX package asks XLA's
cost model.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
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
