"""A benchmark root of tiny cells for runs on the CPU: the four traffic
kinds over PreResNet-8 and WideResNet-10-1 on a few hundred images, written
into a directory as a later change would add its own files."""

from __future__ import annotations

import json
from pathlib import Path

from portbench import core

CONFIGS = {
    "tiny-preresnet": {"model": "PreResNet8", "reference": "preresnet", "depth": 8,
                       "widths": [16, 32, 64], "num_classes": 10,
                       "image": [32, 32, 3], "n_train": 160, "n_test": 96,
                       "precision": "fp32", "allow_tf32": False, "control": "tf32"},
    "tiny-wrn": {"model": "WideResNet28x10", "model_kwargs": {"depth": 10, "widen_factor": 1},
                 "reference": "wideresnet", "depth": 10, "widths": [16, 32, 64],
                 "num_classes": 100, "image": [32, 32, 3], "n_train": 160, "n_test": 96,
                 "precision": "bf16", "allow_tf32": False, "control": "fp8"},
}
_IMAGES = {"mean": [0.4914, 0.4822, 0.4465], "std": [0.2023, 0.1994, 0.2010], "crop_pad": 4,
           "flip": True}
TRAFFIC = {
    "tiny-sghmc": {"kind": "sampler", "method": "SGHMC", "chains": 1, "batch_size": 32,
                   "hyperparameters": {"lr": 0.01, "prior_std": 1.0, "alpha": 0.1,
                                       "burn_in_epochs": 1, "num_samples": 50},
                   "check_losses": 5, "check_changes": [3, 5]},
    "tiny-pass": {"kind": "bma_pass", "members": 3, "member_jitter": 0.1, "batch_size": 32,
                  "member_strategy": "auto"},
    "tiny-requests": {"kind": "bma_requests", "members": 3, "member_jitter": 0.1,
                      "batch_size": 32, "member_strategy": "auto", "warmup": 1,
                      "traced_requests": 2, "checked_batches": 3},
}
# limits for the CPU runs: the fp32 program and the reference compute alike
# there; the bf16 one's gaps are bf16's (a few 1e-3), the faults' 0.1 to 1
LIMITS = {"preresnet20-cifar10.sghmc": {"loss_gap": 1e-5, "grad_gap": 1e-5,
                                        "change3_gap": 1e-5, "change5_gap": 1e-5},
          "wrn28x10-cifar100.sghmc": {"loss_gap": 5e-3, "grad_gap_median": 2e-2,
                                      "change3_gap_median": 2e-2, "change5_gap_median": 2e-2},
          "preresnet20-cifar10.bma-pass": {"prob_gap": 1e-5, "entropy_gap": 1e-5},
          "wrn28x10-cifar100.bma-requests": {"logit_gap": 5e-2}}
# each tiny cell, by the benchmark cell it stands for
CELLS = {"preresnet20-cifar10.sghmc": ("tiny-preresnet", "tiny-sghmc"),
         "wrn28x10-cifar100.sghmc": ("tiny-wrn", "tiny-sghmc"),
         "preresnet20-cifar10.bma-pass": ("tiny-preresnet", "tiny-pass"),
         "wrn28x10-cifar100.bma-requests": ("tiny-wrn", "tiny-requests")}


def tiny_name(cell: str) -> str:
    return ".".join(CELLS[cell])


def write_root(root: Path) -> core.Registry:
    """The tiny cells' files under ``root``, and a registry that finds them
    (and the package's own drivers and metrics)."""
    root = Path(root)
    for sub in ("configs", "traffic", "workloads"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    for name, cfg in CONFIGS.items():
        (root / "configs" / f"{name}.json").write_text(json.dumps({**cfg, **_IMAGES}))
    for name, tr in TRAFFIC.items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    bench = json.loads((core.CHECKOUT / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for stands_for, (cfg, tr) in CELLS.items():
        cell = tiny_name(stands_for)
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": cfg, "traffic": tr, "chips": 1, "why": "a CPU test",
             "limits": LIMITS[stands_for]}))
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": tr, "chips": 1,
                                   "why": "a CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_name(c) for c in m["workloads"] if c in CELLS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return core.Registry([root], root / "BENCHMARK.json")
