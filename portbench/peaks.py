"""Published peaks of the cards the benchmark runs on, by precision.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the card's
full power limit of 700 W: float32 outside the tensor cores (TF32 off)
67 TFLOP/s, TF32 495 TFLOP/s, bf16 989 TFLOP/s, HBM3 3.35 TB/s. The table
is keyed by the name ``torch.cuda.get_device_name`` gives; a card that is
not in it fails the run, with no fallback to another card's peaks. A card
set below 700 W runs slower under load: read its power limit with
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` beside
the numbers.
"""

from __future__ import annotations

from typing import Dict

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "fp32": 67e12,
        "tf32": 495e12,
        "bf16": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(card: str) -> Dict[str, float]:
    """The peaks of ``card``; raises for a card not in the table."""
    if card not in PEAKS:
        raise KeyError(f"no peaks for card {card!r}: the table holds {sorted(PEAKS)}")
    return PEAKS[card]

