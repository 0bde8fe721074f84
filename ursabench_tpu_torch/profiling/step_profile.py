"""Where a WideResNet-28x10 training step spends its device time, on the GPU.

    python -m ursabench_tpu_torch.profiling.step_profile [--out FILE]

The samplers phase's model and data: WideResNet-28x10 in bf16 (float32
parameters) at 100 classes, SGD over 2,048 synthetic CIFAR-100 images at
batch 128 with crop and flip. One untimed epoch (cuDNN picks its
algorithms there), then one epoch under ``torch.profiler`` and one timed
between CUDA events. Reports ms a step, the kernels a step, the device's
busy share (kernel time over the timed epoch's), the achieved TFLOP/s
(one step's FLOPs counted by ``hw.train_step_flops``) against the bf16
peak, and the device time by
kernel class (``KERNEL_CLASSES``, first match of the kernel's name) with
the ten longest kernels. The other samplers run the same forward and
backward; only their update differs.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Optional

import torch

from .hw import card_line, device_name, device_peaks, event_ms, train_step_flops

# class -> substrings of CUDA kernel names, tried in order
KERNEL_CLASSES = (
    ("K1 (sghmc_update)", ("sghmc_update",)),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("layout transforms", ("nchwToNhwc", "nhwcToNchw", "transpose")),
    ("convolutions and GEMMs", ("conv", "gemm", "sm90_", "sm80_", "cutlass", "xmma", "wgrad",
                                "dgrad", "implicit")),
    ("dropout and random", ("bernoulli", "philox", "random", "distribution")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index", "copy", "fill")),
)
HYP = {"lr": 0.05, "epochs": 2, "momentum": 0.9, "weight_decay": 5e-4}
N_TRAIN, BATCH, CLASSES = 2048, 128, 100


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


def device_times(prof) -> dict:
    """{kernel name: (calls, device us)} of the profiled CUDA kernels."""
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = (evt.count, float(us))
    return out


def run(device) -> dict:
    from .. import data, inference, models
    from ..data.transforms import CIFAR_TEST, CIFAR_TRAIN

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"step_profile measures a CUDA device, got {device}")
    splits, _ = data.loaders(
        "CIFAR100", None, batch_size=BATCH, use_validation=False,
        transform_train=CIFAR_TRAIN, transform_test=CIFAR_TEST,
        synthetic_n_train=N_TRAIN, synthetic_n_test=BATCH)
    module = models.get_model("WideResNet28x10").build(CLASSES, dtype=torch.bfloat16)
    flops = train_step_flops(module, BATCH, (3, 32, 32))
    peak, _ = device_peaks(device)
    s = inference.SGD(HYP, model=module, train=splits["train"], seed=0, device=device)
    steps = splits["train"].num_batches
    s._run_epoch()  # untimed
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        s._run_epoch()
        torch.cuda.synchronize()
    ms = event_ms(s._run_epoch, 1) / steps
    kernels = device_times(prof)
    by_class = defaultdict(float)
    for name, (_, us) in kernels.items():
        by_class[kernel_class(name)] += us
    total_us = sum(by_class.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "device": device_name(device), "card": card_line(),
        "config": f"WideResNet28x10 CIFAR100 SGD bf16 bs{BATCH}, {steps} steps an epoch",
        "ms_per_step": ms,
        "tflop_per_step": flops / 1e12,
        "achieved_tflops": flops / ms / 1e9,
        "pct_of_bf16_peak": flops / ms / 1e-3 / peak * 100 if peak else None,
        "kernel_ms_per_step": total_us / 1e3 / steps,
        "device_busy_pct": total_us / 1e3 / steps / ms * 100 if total_us else None,
        "kernels_per_step": sum(c for c, _ in kernels.values()) / steps,
        "by_class_pct": {k: v / total_us * 100 for k, v in
                         sorted(by_class.items(), key=lambda kv: -kv[1])} if total_us else {},
        "top_kernels": [{"name": n[:120], "calls_per_step": c / steps,
                         "us_per_step": us / steps} for n, (c, us) in top],
    }


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description="device time of a WRN-28x10 step by kernel class")
    p.add_argument("--out", type=str, default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ursabench_tpu_torch.profiling.step_profile needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = run("cuda")
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    return res


if __name__ == "__main__":
    main()
