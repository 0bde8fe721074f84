"""Sampler wall time per inference method: ``python -m ursabench_tpu_torch.cli time``.

Counterpart of ``ursabench_tpu/time_script.py``, with its protocol: each
method's tuned hyperparameters (``<hyperparams_path><Method>_BO.json``,
else ``assets/tuned_hyperparams.json`` for the model and dataset, else the
class defaults), the burn-in zeroed (``normalize_burnin``), S samples a
trial, T trials a method, each trial a fresh model and sampler seeded
``seed + t``. A trial's time is ``sample()`` between two
``torch.cuda.synchronize()`` calls on the card. ``--warmup_trials`` runs
untimed trials first (the first CUDA and cuDNN calls of a process are
slow). ``--method_trials SWAG=3`` sets one method's trial count, and every
method's JSON entry records the ``<m>_trials`` it ran, beside ``<m>_mean``
and ``<m>_std`` (ddof 1), in ``<save_path>.json``.

``main(argv, device=None)`` runs on the card unless the caller passes a
device (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import data, inference, models
from .inference.base import resolve_device
from .util import json_open_from_file

DEFAULT_METHODS = [
    "HMC", "SGLD", "SGHMC", "cSGLD", "cSGHMC", "SWAG", "MCdropout", "SGD",
    "PCASubspaceSampler",
]


def normalize_burnin(method: str, hyp: dict, S: int) -> dict:
    """The reference's burn-in zeroing rules, per method."""
    hyp = dict(hyp)
    if method == "HMC":
        hyp["burn"] = -1
    if method == "SWAG":
        hyp["burn_in_epochs"] = 1
    if method in ("SGHMC", "SGLD"):
        hyp["burn_in_epochs"] = 0
    if method in ("cSGHMC", "cSGLD"):
        hyp["burn_in_epochs"] = 0
        hyp["num_cycles"] = 1
        hyp["num_samples_per_cycle"] = S
        # keeps cycle_length > burn_in + samples_per_cycle
        hyp["cycle_length"] = max(hyp.get("cycle_length", S + 2), S + 2)
    if method in ("MCdropout", "SGD"):
        hyp["epochs"] = 0
    if method == "PCASubspaceSampler":
        hyp["swag_burn_in_epochs"] = 1
        hyp["num_swag_iterates"] = max(2, min(int(hyp.get("num_swag_iterates", 5)), 5))
    hyp["num_samples"] = S
    return hyp


def load_method_hyp(hyperparams_path: str | None, method: str,
                    model: str = "MLP200MNIST", dataset: str = "MNIST") -> dict | None:
    """``<hyperparams_path><Method>_BO.json`` if it exists, else the
    bundled tuned values of the model and dataset (groups are named like
    ``WideResNet28x10CIFAR10``), else None."""
    if hyperparams_path:
        p = hyperparams_path + method + "_BO.json"
        if os.path.exists(p):
            return json_open_from_file(p)
    bundled = os.path.join(os.path.dirname(__file__), "..", "assets", "tuned_hyperparams.json")
    if os.path.exists(bundled):
        lib = json_open_from_file(os.path.abspath(bundled))
        for group in (f"{model}{dataset}", model, f"{model}{dataset.upper()}"):
            if group in lib and method in lib[group]:
                return lib[group][method]
    return None


def build_parser():
    p = argparse.ArgumentParser(description="per-method sampler wall time (PyTorch)")
    p.add_argument("--dataset", type=str, default="MNIST")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--model", type=str, default="MLP200MNIST")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--hyperparams_path", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--methods", type=str, nargs="*", default=DEFAULT_METHODS)
    p.add_argument("--S", type=int, default=3)
    p.add_argument("--T", type=int, default=10)
    p.add_argument("--method_trials", type=str, nargs="*", default=[], metavar="METHOD=T",
                   help="a trial count for one method, in place of --T")
    p.add_argument("--warmup_trials", type=int, default=0,
                   help="untimed trials per method before the timed ones")
    p.add_argument("--synthetic_n_train", type=int, default=None)
    p.add_argument("--synthetic_n_test", type=int, default=None)
    return p


def trial_counts(parser, args) -> dict:
    """Each method's trial count: ``--T``, or its ``--method_trials``
    entry; refuses counts below 1 and entries for methods not timed."""
    if args.S < 1 or args.T < 1 or args.warmup_trials < 0:
        parser.error("--S and --T must be >= 1 and --warmup_trials >= 0")
    counts = {m: args.T for m in args.methods}
    for entry in args.method_trials:
        method, _, value = entry.partition("=")
        if method not in counts or not value.isdigit() or int(value) < 1:
            parser.error(f"--method_trials {entry!r}: expected METHOD=T with METHOD one of "
                         f"--methods and T >= 1")
        counts[method] = int(value)
    return counts


def main(argv=None, device=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    counts = trial_counts(parser, args)
    device = resolve_device(device)
    cfg = models.get_model(args.model)
    loaders, num_classes = data.loaders(
        args.dataset, args.data_path, args.batch_size,
        transform_train=cfg.transform_train, transform_test=cfg.transform_test,
        use_validation=False, seed=args.seed,
        synthetic_n_train=args.synthetic_n_train, synthetic_n_test=args.synthetic_n_test,
    )
    train_split = loaders["train"]
    num_classes = int(num_classes)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    timer = {}
    for method in args.methods:
        cls = inference.get_inference(method)
        hyp = load_method_hyp(args.hyperparams_path, method, model=args.model,
                              dataset=args.dataset)
        if hyp is None:
            print(f"{method}: no tuned hyperparameters found, using defaults")
            hyp = dict(cls._DEFAULT_HYP)
        hyp = normalize_burnin(method, hyp, args.S)
        T = counts[method]
        print(method)
        print(f"Time for {args.S} sample.")
        times = np.zeros(T)
        for t in range(-args.warmup_trials, T):
            print("Trial:", t)
            build = models.dropout_twin(args.model) if method == "MCdropout" else cfg
            sampler = cls(hyperparameters=hyp, model=build.build(num_classes), train=train_split,
                          seed=args.seed + t, device=device)
            sync()
            t0 = time.perf_counter()
            sampler.sample()
            sync()
            if t >= 0:
                times[t] = time.perf_counter() - t0
        timer[method + "_mean"] = float(times.mean())
        timer[method + "_std"] = float(times.std(ddof=1)) if T > 1 else 0.0
        timer[method + "_trials"] = T
        print("Time:", timer[method + "_mean"], "+-", timer[method + "_std"])

    with open(args.save_path + ".json", "w") as f:
        json.dump(timer, f)
    print(json.dumps(timer))
    return timer


if __name__ == "__main__":
    main()
