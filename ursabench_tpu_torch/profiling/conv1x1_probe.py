"""The 1x1-conv probe: K3a and K3b against cuBLAS at ResNet-50's widest
1x1 conv.

    python -m ursabench_tpu_torch.profiling.conv1x1_probe [--out FILE]

Counterpart of ``benchmarks/rn50_conv1x1_pallas_probe.py``, the entry point
of the TPU kernels ``pallas_mm`` and ``pallas_wgrad``. The shape is the
256 -> 64 1x1 conv that opens layer1's bottlenecks in torchvision's
ResNet-50 at 224x224 and batch 128: x (401408, 256) bf16 (205.5 MB), the
output or the gradient (401408, 64) bf16 (51.4 MB), w (256, 64) bf16. Rows,
each a device time from CUDA events over ``REPS`` calls after a warm-up
(every call reads at least 205 MB, beyond the 50 MB L2):

- ``read_ceiling_sum``: a float32 sum of x, the read ceiling;
- ``matmul`` (``torch.matmul``, cuBLAS: the JAX probe's ``xla_dot``),
  ``matmul_outT`` (the output transposed, (64, M)), ``matmul_f32out`` (a
  float32 output, ``torch.mm(..., out_dtype=torch.float32)``);
- ``conv1x1_mm`` (K3a) and ``conv1x1_mm_plain`` (its plain version);
- ``wgrad_matmul`` (cuBLAS ``x^T g``), ``conv1x1_wgrad`` (K3b) and
  ``conv1x1_wgrad_plain``;
- ``matmul_write_big``: ``g @ w^T``, which writes the big tensor.

Each row gives ``us``, ``gb_per_sec`` (the bytes the operation must move,
from its shapes, over its time), ``pct_of_hbm_peak`` and
``pct_of_bf16_peak`` (``hw.device_peaks``). Before timing, the JAX probe's
correctness gates (``:127-138``) must pass: K3a and K3b on the first 8,192
rows against cuBLAS. Prints one JSON object, headed by the card's
``nvidia-smi`` name and power limit; writes it to ``--out`` when asked.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..kernels.conv1x1 import (conv1x1_mm, conv1x1_mm_reference, conv1x1_wgrad,
                               conv1x1_wgrad_reference)
from .hw import card_line, device_name, device_peaks, event_ms

BATCH = 128
M, K, N = BATCH * 56 * 56, 256, 64  # 401408 rows
TM = 4096  # the JAX probe's M tile: its gates use 2 tiles
REPS = 30
WARM_UP = 3


def gates(big: torch.Tensor, small: torch.Tensor, w: torch.Tensor) -> None:
    """The JAX probe's gates, with its tolerances: K3a against cuBLAS (rtol
    0.02, atol 0.5) and K3b / TM against cuBLAS's x^T g / TM (rtol 0.05,
    atol 0.5), on the first 2 * TM rows. Raises AssertionError."""
    x, g = big[:2 * TM], small[:2 * TM]
    np.testing.assert_allclose(conv1x1_mm(x, w).float().cpu().numpy(),
                               (x @ w).float().cpu().numpy(), rtol=0.02, atol=0.5)
    np.testing.assert_allclose(conv1x1_wgrad(x, g).float().cpu().numpy() / TM,
                               (x.T @ g).float().cpu().numpy() / TM, rtol=0.05, atol=0.5)


def run(device) -> Dict:
    """Gates, then every row, on ``device`` (a CUDA device)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the conv1x1 probe measures a CUDA device, got {device}")
    gen = torch.Generator(device=device).manual_seed(0)
    big = torch.randn(M, K, generator=gen, device=device, dtype=torch.bfloat16)
    small = torch.randn(M, N, generator=gen, device=device, dtype=torch.bfloat16)
    w = torch.randn(K, N, generator=gen, device=device, dtype=torch.bfloat16)
    gates(big, small, w)

    peak, hbm = device_peaks(device)
    flops = 2.0 * M * K * N
    big_b, small_b, w_b = M * K * 2, M * N * 2, K * N * 2
    rows = []

    def rec(name: str, fn: Callable, nbytes: float, fl: float = flops) -> None:
        us = event_ms(fn, REPS, WARM_UP) * 1e3
        row = {"variant": name, "us": us, "gb_per_sec": nbytes / us / 1e3, "bytes": nbytes}
        if hbm:
            row["pct_of_hbm_peak"] = nbytes / (us * 1e-6) / hbm * 100
        if peak:
            row["pct_of_bf16_peak"] = fl / (us * 1e-6) / peak * 100
        rows.append(row)

    rec("read_ceiling_sum", lambda: big.sum(dtype=torch.float32), big_b, fl=M * K)
    fwd_b = big_b + w_b + small_b
    rec("matmul", lambda: big @ w, fwd_b)
    rec("matmul_outT", lambda: w.T @ big.T, fwd_b)
    rec("matmul_f32out", lambda: torch.mm(big, w, out_dtype=torch.float32),
        big_b + w_b + 2 * small_b)
    rec("conv1x1_mm", lambda: conv1x1_mm(big, w), fwd_b)
    rec("conv1x1_mm_plain", lambda: conv1x1_mm_reference(big, w), fwd_b)
    wgrad_b = big_b + small_b + w_b
    rec("wgrad_matmul", lambda: big.T @ small, wgrad_b)
    rec("conv1x1_wgrad", lambda: conv1x1_wgrad(big, small), wgrad_b)
    rec("conv1x1_wgrad_plain", lambda: conv1x1_wgrad_reference(big, small), wgrad_b)
    rec("matmul_write_big", lambda: small @ w.T, fwd_b)

    out = {"device": device_name(device),
           "shape": f"({M}, {K}) @ ({K}, {N}) bf16 and its weight gradient",
           "bytes": fwd_b, "flops": flops, "reps": REPS, "rows": rows}
    if hbm:
        out["speed_of_light_us"] = fwd_b / hbm * 1e6
    if peak:
        out["compute_floor_us"] = flops / peak * 1e6
    return out


def main(argv: Optional[list] = None) -> Dict:
    p = argparse.ArgumentParser(description="K3a/K3b against cuBLAS at rn50's 1x1 conv")
    p.add_argument("--out", type=str, default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ursabench_tpu_torch.profiling.conv1x1_probe needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    out = {"card": card, **run(torch.device("cuda"))}
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
