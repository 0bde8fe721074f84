#!/usr/bin/env python3
"""Smoke run of ursabench_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line of output each:
1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, the build time of kernel K1 (nvcc, at first use);
2. kernel K1 (csrc/sghmc_update.cu) against its plain PyTorch version on
   the card: exact agreement with the noise off, the statistics of its
   in-kernel Langevin noise, and both times at PreResNet-20's flat size;
3. the slice: SGHMC on PreResNet-20 / synthetic CIFAR-10 (50,000 train and
   10,000 test images, batch 128, crop + flip), 2 draws after 1 burn-in
   epoch (3 epochs, 1,173 steps), then the BMA Prediction task with all 11
   metrics over the test split; K1 must have run once per step.
Then a JSON line describing each kernel, and last the JSON line
{"ok": true, "device": {...}}. Any failed check exits non-zero before it.
Exits non-zero without a CUDA device. Float32 throughout, TF32 off.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1,
       "burn_in_epochs": 1}
BATCH = 128
STEPS = 3 * 391  # burn_in + num_samples epochs of ceil(50000 / 128) steps
TIMED_LAUNCHES = 2000


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAILED: {msg}", flush=True)
        sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, launches: int) -> float:
    """Mean device time of ``fn`` over ``launches`` back-to-back calls,
    from CUDA events, after a warm-up."""
    for _ in range(20):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(launches):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / launches


def kernel_phase(device, n_slice: int) -> dict:
    from ursabench_tpu_torch.kernels.sghmc import (sghmc_update_flat,
                                                   sghmc_update_flat_reference)
    from ursabench_tpu_torch.ops.sgmcmc import sghmc_scalars

    gen = torch.Generator(device=device).manual_seed(0)
    max_err = 0.0
    cases = 0
    # noise off: the kernel rounds like the plain version (the _rn
    # intrinsics are never contracted into FMAs); the tolerance leaves room
    # for contraction all the same
    for n in (1000, 8193, n_slice):
        p, v, g = (torch.randn(n, generator=gen, device=device) for _ in range(3))
        for first in (False, True):
            for m in (0.9, 0.0):
                s = sghmc_scalars(lr=0.05, momentum=m, wd_over_n=1.0 / 50000,
                                  n_train=50000.0, noise_on=0.0,
                                  is_first_step=first, device=device)
                pk, vk = p.clone(), v.clone()
                sghmc_update_flat(pk, vk, g, s, seed=n)
                pr, vr = p.clone(), v.clone()
                sghmc_update_flat_reference(pr, vr, g, s, torch.zeros_like(p))
                torch.cuda.synchronize()
                for got, want in ((pk, pr), (vk, vr)):
                    check(torch.allclose(got, want, rtol=1e-6, atol=1e-7),
                          f"K1 != plain at n={n} first={first} m={m}")
                    max_err = max(max_err, float((got - want).abs().max()))
                cases += 1

    # noise on, from zeros: p = v = noise_scale * N(0, 1)
    n, lr, m, ntr = 65536, 0.1, 0.9, 100.0
    expected = math.sqrt(2 * (1 - m) * lr) / ntr

    def noisy(seed):
        p, v, g = (torch.zeros(n, device=device) for _ in range(3))
        s = sghmc_scalars(lr=lr, momentum=m, wd_over_n=0.0, n_train=ntr,
                          noise_on=1.0, is_first_step=False, device=device)
        sghmc_update_flat(p, v, g, s, seed=seed)
        return p.double().cpu().numpy()

    a, a2, b = noisy(7), noisy(7), noisy(8)
    std, mean = float(a.std()), float(a.mean())
    check(abs(std / expected - 1) < 0.05, f"noise std {std} vs {expected}")
    check(abs(mean) < 0.05 * std, f"noise mean {mean}")
    check(np.array_equal(a, a2), "same seed gave different noise")
    check(not np.allclose(a, b), "two seeds gave the same noise")
    check(not np.allclose(a[: n // 2], a[n // 2:]), "two halves of the noise agree")
    from scipy import stats

    ks = float(stats.kstest(a / expected, "norm").statistic)
    check(ks < 0.01, f"KS statistic {ks} against N(0,1)")

    # times at the slice's flat size, noise on (the plain version draws its
    # normals with torch.randn, the kernel makes them in registers)
    p, v, g = (torch.randn(n_slice, generator=gen, device=device) for _ in range(3))
    s = sghmc_scalars(lr=0.05, momentum=0.9, wd_over_n=1.0 / 50000, n_train=50000.0,
                      noise_on=1.0, is_first_step=False, device=device)
    ms = time_ms(lambda: sghmc_update_flat(p, v, g, s, seed=1), TIMED_LAUNCHES)
    plain_ms = time_ms(lambda: sghmc_update_flat_reference(
        p, v, g, s, torch.randn(n_slice, device=device)), TIMED_LAUNCHES)
    print(f"kernel K1 sghmc_update: {cases} noise-off cases equal to the plain "
          f"version (max abs err {max_err:.3g}); noise std/expected "
          f"{std / expected:.4f}, KS {ks:.4f}; n={n_slice}: {ms * 1e3:.2f} us "
          f"vs plain {plain_ms * 1e3:.2f} us over {TIMED_LAUNCHES} launches",
          flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def reference_probs(module_factory, ens, x):
    """Sum over members of softmax probabilities from plain modules loaded
    with each member's state (no functional_call), for one NCHW batch."""
    total = 0
    for i in range(ens.num_members):
        m = module_factory()
        m.load_state_dict(ens.member(i))
        with torch.no_grad():
            total = total + torch.softmax(m.eval()(x).double(), dim=-1)
    return total


def slice_phase(device) -> int:
    from ursabench_tpu_torch import data, inference, models, tasks
    from ursabench_tpu_torch.data.transforms import CIFAR_TEST, CIFAR_TRAIN, normalize
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    t0 = time.perf_counter()
    splits, num_classes = data.loaders(
        "CIFAR10", None, batch_size=BATCH, use_validation=False,
        transform_train=CIFAR_TRAIN, transform_test=CIFAR_TEST)
    train, test = splits["train"], splits["test"]
    check(train.n == 50000 and test.n == 10000 and train.num_batches == 391,
          f"unexpected split sizes {train.n} {test.n}")
    data_s = time.perf_counter() - t0
    cfg = models.get_model("PreResNet20")

    sghmc_update_flat.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = inference.SGHMC(HYP, model=cfg.build(num_classes), train=train,
                              seed=0, device=device)
    ens = sampler.sample()
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    task = tasks.Prediction({"in_distribution_test": test}, num_classes,
                            metric_list="ALL")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.update_statistics(ens, output_performance=False)
    torch.cuda.synchronize()
    bma_s = time.perf_counter() - t0
    launches = sghmc_update_flat.launches

    check(launches == STEPS, f"K1 launched {launches} times, expected {STEPS}")
    check(ens.num_members == 2, f"{ens.num_members} members")
    for k, t in ens.state.items():
        check(bool(torch.isfinite(t).all()), f"non-finite ensemble entry {k}")
    losses = [float(x) for x in sampler.epoch_losses]
    check(len(losses) == 3 and all(map(math.isfinite, losses)), f"losses {losses}")
    check(losses[2] < losses[0], f"training loss did not fall: {losses}")

    metrics = task.get_performance_metrics()
    err = metrics["error_rate"]
    for k, val in metrics.items():
        nan_by_design = k.startswith("misclass") and err in (0.0, 1.0)
        check(math.isfinite(val) or nan_by_design, f"metric {k} = {val}")
    check(err < 0.9, f"error rate {err} is no better than chance")

    # the BMA pass against plain modules on the first test batch, and the
    # error rate and nll against numpy in float64
    x = normalize(torch.from_numpy(test.images[:BATCH]).to(device), test.spec)
    want = reference_probs(lambda: cfg.build(num_classes).to(device), ens,
                           x.permute(0, 3, 1, 2).contiguous()).cpu().numpy()
    check(np.allclose(task.ensemble_proba[:BATCH], want, rtol=1e-5, atol=1e-5),
          "BMA probabilities differ from plain modules")
    mean_probs = task.ensemble_proba / 2
    err_np = float(np.mean(mean_probs.argmax(1) != test.labels))
    smoothed = (1 - 1e-4) * mean_probs + 1e-4 / num_classes
    nll_np = float(-np.mean(np.log(smoothed[np.arange(test.n), test.labels])))
    check(abs(err_np - err) < 1e-6 and abs(nll_np - metrics["nll"]) < 1e-4,
          f"metrics disagree with numpy: {err_np} {nll_np}")

    print(f"slice SGHMC PreResNet-20 CIFAR-10 bs{BATCH}: {launches} K1 launches, "
          f"epoch losses {[round(v, 4) for v in losses]}, "
          f"{STEPS / sample_s:.1f} steps/s over sample() ({sample_s:.2f} s, "
          f"3 epochs incl. the first), BMA {test.n / bma_s:.0f} img/s "
          f"({ens.num_members} members, {bma_s:.2f} s); data {data_s:.1f} s; "
          f"metrics {json.dumps(metrics)}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", flush=True)
        return 1
    device = torch.device("cuda")
    # float32 is the protocol dtype: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)

    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.kernels.sghmc import load_library

    lib = load_library()
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"K1 built in {lib.build_seconds:.2f} s ({lib.path.name}), TF32 off",
          flush=True)

    n_slice = sum(p.numel() for p in models.get_model("PreResNet20").build(10).parameters())
    kernel = kernel_phase(device, n_slice)
    launches = slice_phase(device)

    print(json.dumps({"kernels": [{
        "name": "sghmc_update", "route": "cuda",
        "source": "ursabench_tpu_torch/csrc/sghmc_update.cu",
        "replaces": "benchmarks/pallas_sgmcmc.py:75",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
