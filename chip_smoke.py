#!/usr/bin/env python3
"""Smoke run of ursabench_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each ending with its seconds:
1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, the build time of each kernel (one nvcc per source, all
   started together, at first use) and ptxas's registers and spills for
   each K3 kernel;
2. kernel K1 (csrc/sghmc_update.cu) against its plain PyTorch version on
   the card: exact agreement with the noise off, the statistics of its
   in-kernel Langevin noise, and both device times at PreResNet-20's flat
   size beside the bound its bytes allow;
3. the slice: SGHMC on PreResNet-20 / synthetic CIFAR-10 (50,000 train and
   10,000 test images, batch 128, crop + flip), 2 draws after 1 burn-in
   epoch (3 epochs, 1,173 steps), then the BMA Prediction task with all 11
   metrics over the test split; K1 must have run once per step;
4. the int8 kernels K2/K4b/K4d (csrc/int8_gemv.cu, variants mma, mma_row,
   dp4a) and K4a/K4c (csrc/stream_probe.cu, outputs (G, 1) and (G, 128))
   against their plain versions, bit for bit, at 512x256, 3072x3072,
   6144x6144 and a ragged 1000x384 (GEMV only);
5. the int8 microbench entry point (profiling/int8_microbench.run) at
   6144x6144, the weights rotating over a 113 MB working set: every
   variant's device time beside its plain version's, the stream speed of
   light and the share of it; each new kernel must have been launched there;
6. the latency path (profiling/latency.profile_config): PreResNet-20 /
   CIFAR-10, fp32, bf16 and int8 engines, S=6, batch 1 and 128, per-call
   and CUDA-graph device times, both member strategies for bf16; a graph
   replay must equal the eager forward, bf16 and int8 must stay within 0.03
   of fp32 on a fresh ensemble (and are printed for the slice's trained
   one), and make_latex_table must render every row;
7. profile_prediction: Prediction in latency mode, S=2, over the 10,000
   test images; its 11 metrics must equal a plain Prediction's on the same
   ensemble, with one latency per batch (79);
8. the 1x1-conv kernels K3a/K3b (csrc/conv1x1.cu) against their plain
   versions at every 1x1 conv shape of ResNet-50 at 224x224 and batch 128
   (the stride-2 ones on the top-left tap), which includes the probe's
   (401408, 256) @ (256, 64), at a ragged M of 1000 (also with N = 1024,
   K3a's 256-column tiles), at M = 1 and 63 and at K = N = 16: each element
   within one bf16 ulp of the plain result plus 1e-3 of its largest
   magnitude; K3b twice, bit-equal, and bit-equal again under a CUDA-graph
   replay of one call; then, at the 16 rn50 shapes, K3a,
   K3b, cuBLAS's x @ w and x.T @ g over 20 calls each, beside the bound
   (the larger of the bytes at 3.35 TB/s and the FLOPs at 989 TFLOP/s);
9. the conv1x1 probe entry point (profiling/conv1x1_probe.run): its gates,
   then K3a, K3b, their plain versions and cuBLAS at the probe's shape;
   both kernels must have been launched there;
10. the ImageNet slice (profiling/imagenet_train.run): TVResNet-50 in bf16
   at 224x224 / 1000 classes, batch 128, SGHMC over 2,048 images (a warm-up
   epoch, 3 timed epochs, 2 sampling epochs: K1 once per step), finite
   losses, the BMA pass over 512 test images equal to plain per-member
   modules within 1e-2; then K3a and K3b on the model's own layer1[1].conv1
   (input (128, 256, 56, 56)) against cuDNN's forward and autograd's weight
   gradient of that conv, within 2 bf16 ulps plus 1e-3 of the largest
   magnitude.
The latency phase (6.) also runs TVResNet-50 / ImageNet, S=2, batch 1 and
32, in the three precisions under both member strategies.
Then a JSON line describing each kernel (its launches on the main path,
its error against its plain version, its time, the plain version's, its
bound and the single library call's where there is one), and last the JSON
line {"ok": true, "device": {...}}. Any failed check exits non-zero before
it.
Exits non-zero without a CUDA device. TF32 off throughout.
"""

from __future__ import annotations

import json
import math
import re
import sys
import time

import numpy as np
import torch

HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1,
       "burn_in_epochs": 1}
BATCH = 128
STEPS = 3 * 391  # burn_in + num_samples epochs of ceil(50000 / 128) steps
TIMED_LAUNCHES = 2000
GEMV_SHAPES = ((512, 256), (3072, 3072), (6144, 6144), (1000, 384))  # the last ragged
# kernel JSON name -> (source, TPU kernel it replaces, microbench variant)
INT8_KERNELS = {
    "int8_gemv_mma": ("int8_gemv.cu", "benchmarks/pallas_int8.py:53", "int8_mma"),
    "int8_gemv_mma_row": ("int8_gemv.cu",
                          "benchmarks/pallas_matvec_probe.py:100 (_row_kernel)",
                          "int8_mma_row"),
    "int8_gemv_dp4a": ("int8_gemv.cu", "benchmarks/pallas_matvec_probe2.py:89; "
                       "benchmarks/pallas_matvec_probe.py:100 (_vpu_kernel)", "int8_dp4a"),
    "stream_probe_g1": ("stream_probe.cu", "benchmarks/pallas_matvec_probe.py:66",
                        "stream_g1"),
    "stream_probe_g128": ("stream_probe.cu", "benchmarks/pallas_matvec_probe2.py:65",
                          "stream_g128"),
}
MICROBENCH_D = 6144
AMORTIZE_K = 100
LATENCY_S = 6
TV_AMORTIZE_K = 20  # TVResNet-50 forwards take milliseconds: fewer replays
TV_LATENCY = (2, (1, 32))  # S, batch sizes: benchmarks/rn50_latency.py:45-51
TV_FLAT = 25557032  # TVResNet-50's parameters: K1's flat size in the ImageNet slice
# every 1x1 conv of torchvision's ResNet-50 at 224^2 (benchmarks/
# rn50_conv_lowering_probe.py:45-62): name, input side, C_in, C_out, stride
RN50_1X1 = (
    ("l1_1x1_in", 56, 64, 64, 1), ("l1_1x1_out", 56, 64, 256, 1),
    ("l1_down", 56, 64, 256, 1), ("l1_1x1_in256", 56, 256, 64, 1),
    ("l2_1x1_in", 56, 256, 128, 1), ("l2_down_s2", 56, 256, 512, 2),
    ("l2_1x1_in512", 28, 512, 128, 1), ("l2_1x1_out", 28, 128, 512, 1),
    ("l3_1x1_in", 28, 512, 256, 1), ("l3_down_s2", 28, 512, 1024, 2),
    ("l3_1x1_in1024", 14, 1024, 256, 1), ("l3_1x1_out", 14, 256, 1024, 1),
    ("l4_1x1_in", 14, 1024, 512, 1), ("l4_down_s2", 14, 1024, 2048, 2),
    ("l4_1x1_in2048", 7, 2048, 512, 1), ("l4_1x1_out", 7, 512, 2048, 1),
)
RAGGED_M = 1000
# beside the rn50 shapes: name, M, C_in, C_out (TMA's zero fill masks them)
K3_SMALL = (("ragged_m", RAGGED_M, 256, 64), ("m1", 1, 256, 64), ("m63", 63, 256, 64),
            ("kn16", RAGGED_M, 16, 16), ("ragged_n1024", RAGGED_M, 128, 1024))
K3_TIMED_CALLS = 20
PROBE_SHAPE = "l1_1x1_in256"  # (401408, 256) @ (256, 64), the conv1x1 probe's
# peak rates by operand type on an H100 SXM (dense; NVIDIA's data sheet): the
# bf16 and int8 tensor cores and float32 outside them
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
SGHMC_BYTES = 20  # K1 a parameter: reads p, v, g and writes p, v, float32
SGHMC_FLOPS = 13  # K1 a parameter: the update's 8 plus Box-Muller's ~5


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAILED: {msg}", flush=True)
        sys.exit(1)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |t| (8 significant bits), in float32."""
    a = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def bound(nbytes: float, ops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time an H100 could take to
    move ``nbytes`` through HBM at 3.35 TB/s or to do ``ops`` operations
    of type ``kind`` at its peak, whichever is longer."""
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_close(got: torch.Tensor, want: torch.Tensor, ulps: int) -> float:
    """Checks |got - want| <= ulps * ulp(want) + 1e-3 * max|want| elementwise
    (float32 sums in another order, then one rounding to bf16); returns the
    largest |got - want|."""
    err = (got.float() - want.float()).abs()
    bound = ulps * bf16_ulp(want) + 1e-3 * float(want.float().abs().max())
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    check(bool((err <= bound).all()),
          f"bf16 results differ by up to {float((err / bound).max()):.3g} x the bound")
    return float(err.max())


def kernel_phase(device, n_slice: int) -> dict:
    from ursabench_tpu_torch.kernels.sghmc import (sghmc_update_flat,
                                                   sghmc_update_flat_reference)
    from ursabench_tpu_torch.ops.sgmcmc import sghmc_scalars
    from ursabench_tpu_torch.profiling.hw import event_ms
    from ursabench_tpu_torch.profiling.int8_microbench import graph_ms

    gen = torch.Generator(device=device).manual_seed(0)
    max_err = 0.0
    cases = 0
    # noise off: the kernel rounds like the plain version (the _rn
    # intrinsics are never contracted into FMAs); the tolerance leaves room
    # for contraction all the same
    for n in (1000, 8193, n_slice, TV_FLAT):
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
    # device times from CUDA graphs of the calls (a launch from Python costs
    # more host time than the kernel takes), and the time a call takes
    # launched from Python
    def kernel_call():
        sghmc_update_flat(p, v, g, s, seed=1)

    def plain_call():
        sghmc_update_flat_reference(p, v, g, s, torch.randn(n_slice, device=device))

    ms, plain_ms = graph_ms([kernel_call], TIMED_LAUNCHES), graph_ms([plain_call], TIMED_LAUNCHES)
    call_ms = event_ms(kernel_call, TIMED_LAUNCHES, 20)
    bound_ms, bound_by = bound(SGHMC_BYTES * n_slice, SGHMC_FLOPS * n_slice, "f32")
    print(f"kernel K1 sghmc_update: {cases} noise-off cases equal to the plain "
          f"version (max abs err {max_err:.3g}); noise std/expected "
          f"{std / expected:.4f}, KS {ks:.4f}; n={n_slice}: device {ms * 1e3:.2f} us "
          f"vs plain {plain_ms * 1e3:.2f} us (graphs of {TIMED_LAUNCHES} calls), "
          f"{call_ms * 1e3:.2f} us a call from Python; bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}), {bound(SGHMC_BYTES * TV_FLAT, 0, 'f32')[0] * 1e3:.1f}"
          f" us at TVResNet-50's {TV_FLAT}", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


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


def slice_phase(device):
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
    return launches, splits, ens


def int8_kernel_phase(device) -> dict:
    """Every GEMV variant and both stream layouts against their plain
    versions on the card; returns the largest |kernel - plain| per kernel."""
    from ursabench_tpu_torch.kernels.int8_gemv import (
        VARIANTS, int8_gemv, int8_gemv_reference, int8_matvec, quantize_activation)
    from ursabench_tpu_torch.kernels.stream_probe import (LAYOUTS, stream_probe,
                                                          stream_probe_reference)
    from ursabench_tpu_torch.profiling.quantize import quantize_tensor

    err = {name: 0.0 for name in INT8_KERNELS}
    cases = 0
    for n, k in GEMV_SHAPES:
        gen = torch.Generator(device=device).manual_seed(n + k)
        w = torch.randn(n, k, generator=gen, device=device) / math.sqrt(k)
        q8, scale = quantize_tensor(w, channel_axis=0)
        scale = scale.reshape(n)
        x = torch.randn(k, generator=gen, device=device)
        xq, xs = quantize_activation(x)
        want = int8_gemv_reference(q8, scale, xq, xs)
        # every weight and activation at +-127: the accumulator's bound
        q_max = torch.full_like(q8, 127)
        q_max[1::2] = -127
        x_max = torch.full_like(xq, 127)
        want_max = int8_gemv_reference(q_max, scale, x_max, xs)
        for v in VARIANTS:
            got = int8_gemv(q8, scale, xq, xs, v)
            whole = int8_matvec(q8, scale, x, v)
            got_max = int8_gemv(q_max, scale, x_max, xs, v)
            torch.cuda.synchronize()
            for a, b in ((got, want), (whole, want), (got_max, want_max)):
                check(torch.equal(a, b), f"int8_gemv {v} != plain at {n}x{k}")
            err[f"int8_gemv_{v}"] = max(err[f"int8_gemv_{v}"],
                                        float((got - want).abs().max()))
            cases += 1
        if n % 512:
            continue
        qs = torch.randint(-127, 128, (n, k), generator=gen, device=device,
                           dtype=torch.int8)
        for tile_n in (128, 512):
            for cols in LAYOUTS:
                out, sums = stream_probe(qs, 3, tile_n=tile_n, out_cols=cols)
                want_out, want_sums = stream_probe_reference(qs, 3, tile_n=tile_n,
                                                             out_cols=cols)
                torch.cuda.synchronize()
                check(torch.equal(out, want_out) and torch.equal(sums, want_sums),
                      f"stream_probe g{cols} != plain at {n}x{k} tile {tile_n}")
                name = f"stream_probe_g{cols}"
                err[name] = max(err[name], float((out - want_out).abs().max()))
                cases += 1
    print(f"int8 kernels: {cases} cases bit-equal to their plain versions at "
          f"{', '.join(f'{n}x{k}' for n, k in GEMV_SHAPES)} "
          f"(max abs err {max(err.values())})", flush=True)
    return err


def microbench_phase(device) -> dict:
    """The int8 microbench entry point at 6144x6144; every new kernel must
    have been launched there."""
    from ursabench_tpu_torch.kernels.int8_gemv import int8_gemv
    from ursabench_tpu_torch.kernels.stream_probe import stream_probe
    from ursabench_tpu_torch.profiling import int8_microbench

    for counts in (int8_gemv.launches, stream_probe.launches):
        counts.update(dict.fromkeys(counts, 0))
    res = int8_microbench.run(MICROBENCH_D, device)
    launches = {**{f"int8_gemv_{k}": n for k, n in int8_gemv.launches.items()},
                **{f"stream_probe_g{k}": n for k, n in stream_probe.launches.items()}}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the microbench")
    for name, r in res["variants"].items():
        check(all(math.isfinite(v) and v > 0 for k, v in r.items() if k != "bytes"),
              f"microbench {name}: {r}")
        extra = (f", kernel {r['kernel_ms'] * 1e3:.2f} us (hot {r['kernel_hot_ms'] * 1e3:.2f})"
                 if "kernel_ms" in r else "")
        print(f"  microbench {res['matrix']} {name}: {r['ms'] * 1e3:.2f} us rotating, "
              f"hot {r['hot_ms'] * 1e3:.2f} us, dispatch {r['dispatch_ms'] * 1e3:.2f} us"
              f"{extra}, {r.get('pct_of_sol_ms', float('nan')):.1f}% of stream SoL",
              flush=True)
    v = res["variants"]
    sol = res.get("speed_of_light_int8_ms")
    check(sol is not None, "no peak bandwidth for this card in profiling/hw.py")
    print(f"microbench {res['matrix']} ({res['copies']} copies, "
          f"{res['working_set_bytes'] / 1e6:.1f} MB int8): stream speed of light "
          f"{sol * 1e3:.2f} us at 3.35 TB/s; int8_mma kernel "
          f"{v['int8_mma']['pct_of_sol_kernel_ms']:.1f}%, int8_dp4a kernel "
          f"{v['int8_dp4a']['pct_of_sol_kernel_ms']:.1f}%, stream_g1 "
          f"{v['stream_g1']['pct_of_sol_ms']:.1f}%, bf16 "
          f"{v['bf16']['pct_of_sol_ms']:.1f}% (of the bf16 SoL "
          f"{res['speed_of_light_bf16_ms'] * 1e3:.2f} us); launches {launches}",
          flush=True)
    return {"launches": launches, "variants": v}


def latency_phase(device, ens, test) -> list:
    from ursabench_tpu_torch.data.transforms import normalize
    from ursabench_tpu_torch.profiling.latency import (ProfileConfig, build_engine,
                                                       profile_config, random_ensemble,
                                                       resolve_member_strategy)
    from ursabench_tpu_torch.profiling.tables import make_latex_table

    # the precision envelope of tests/test_quantize.py:60 on a real test
    # batch: held on a freshly initialised 2-member ensemble, whose weights do
    # not depend on the run, and printed for the slice's trained one, whose
    # weights do (cuDNN's backward is not deterministic)
    x = normalize(torch.from_numpy(test.images[:BATCH]).to(device), test.spec)
    x = x.permute(0, 3, 1, 2).contiguous()
    for label, e in (("fresh", random_ensemble("PreResNet20", 10, 2, device)),
                     ("trained", ens)):
        probs = {prec: build_engine(e.module, e.state, BATCH, (3, 32, 32), prec)[0](x)
                 for prec in ("fp32", "bf16", "int8")}
        for prec in ("bf16", "int8"):
            diff = float((probs[prec] - probs["fp32"]).abs().max())
            if label == "fresh":
                check(diff < 0.03, f"{prec} engine differs from fp32 by {diff}")
            print(f"  {prec} engine vs fp32 on the {label} ensemble: max |dp| {diff:.2e}",
                  flush=True)

    # bf16 runs both member strategies, the others the 'auto' rule's choice;
    # the table shows the 'auto' rows
    results, cache = [], {}
    for prec in ("fp32", "bf16", "int8"):
        for b in (1, 128):
            cfg = ProfileConfig("PreResNet20", "CIFAR10", prec, LATENCY_S, b)
            auto = resolve_member_strategy("auto", LATENCY_S, b, (3, 32, 32), prec)
            for strategy in (("scan", "vmap") if prec == "bf16" else (auto,)):
                r = profile_config(cfg, amortize_k=AMORTIZE_K, member_strategy=strategy,
                                   device=device)
                results.append((strategy == auto, r))
                if strategy == auto:
                    cache[cfg.key()] = r
    # TVResNet-50 / ImageNet (224^2, 1000 classes): every configuration under
    # both member strategies, the measurement behind the 'auto' rule there
    s, batches = TV_LATENCY
    for prec in ("fp32", "bf16", "int8"):
        for b in batches:
            cfg = ProfileConfig("TVResNet50", "ImageNet", prec, s, b)
            auto = resolve_member_strategy("auto", s, b, (3, 224, 224), prec)
            by = {}
            for strategy in ("scan", "vmap"):
                r = profile_config(cfg, amortize_k=TV_AMORTIZE_K, member_strategy=strategy,
                                   device=device)
                results.append((strategy == auto, r))
                by[strategy] = r["amortized_latency_s"]
                if strategy == auto:
                    cache[cfg.key()] = r
            print(f"  TVResNet50 {prec} S={s} bs{b}: device scan {by['scan'] * 1e3:.4f} ms, "
                  f"vmap {by['vmap'] * 1e3:.4f} ms, auto {auto}", flush=True)
    for is_auto, r in results:
        check(r["graph_max_abs_diff"] == 0.0,
              f"graph replay != eager for {r}")
        check(all(math.isfinite(r[k]) and r[k] > 0 for k in
                  ("latency_mean_s", "amortized_latency_s")), f"latency {r}")
        print(f"  latency {r['precision']} S={r['ensemble_size']} bs{r['batch_size']} "
              f"{r['amortized_member_strategy']}{' (auto)' if is_auto else ''}: "
              f"per call {r['latency_mean_s'] * 1e3:.3f} ms, device "
              f"{r['amortized_latency_s'] * 1e3:.4f} ms, "
              f"{r.get('mfu_pct_of_bf16_peak')}% of bf16 peak, "
              f"{r.get('hbm_bytes_accessed')} B counted", flush=True)
    table = make_latex_table(cache)
    rows = [line for line in table.splitlines()
            if line.startswith(("PreResNet20", "TVResNet50"))]
    check(len(rows) == 4 and all("--" not in row for row in rows),
          f"latency table rows: {rows}")
    print(f"latency: {len(results)} engine configurations, graph replay equal to "
          f"eager in all, table of {len(rows)} rows x 3 precisions", flush=True)
    return results


def prediction_phase(device, splits) -> dict:
    from ursabench_tpu_torch import tasks
    from ursabench_tpu_torch.profiling.latency import (ProfileConfig, profile_prediction,
                                                       random_ensemble)

    cfg = ProfileConfig("PreResNet20", "CIFAR10", "fp32", 2, BATCH)
    res = profile_prediction(cfg, splits, 10, device=device)
    want_batches = -(-splits["test"].n // BATCH)
    check(res["num_batches"] == want_batches == 79,
          f"{res['num_batches']} latencies, expected {want_batches}")
    plain = tasks.Prediction({"in_distribution_test": splits["test"]}, 10)
    plain.update_statistics(random_ensemble(cfg.model, 10, cfg.ensemble_size, device),
                            output_performance=False)
    want = plain.get_performance_metrics()
    got = res["metrics"]
    check(list(got) == list(want), f"metric names {list(got)}")
    for k, v in want.items():
        # the tolerances of tests/test_tasks.py:68-97
        tol = 0.05 if k.endswith(("auroc", "aucpr")) else 1e-5
        both_nan = math.isnan(v) and math.isnan(got[k])
        check(both_nan or abs(v - got[k]) < tol, f"{k}: latency mode {got[k]} vs {v}")
    print(f"profile_prediction S=2 over {splits['test'].n} images: {res['num_batches']} "
          f"batches, {res['latency_mean_s'] * 1e3:.3f} +- {res['latency_std_s'] * 1e3:.3f} "
          f"ms per batch after burn-in; metrics equal to the plain Prediction's",
          flush=True)
    return res


def k3_kernel_phase(device) -> dict:
    """K3a and K3b against their plain versions at every 1x1 conv shape of
    ResNet-50 at batch 128 and at the small and ragged shapes; K3b twice
    and under a CUDA-graph replay, bit-equal; then the rn50 shapes timed
    against cuBLAS. Returns the largest errors and the timing rows."""
    from ursabench_tpu_torch.kernels.conv1x1 import (conv1x1_mm, conv1x1_mm_reference,
                                                     conv1x1_wgrad, conv1x1_wgrad_reference,
                                                     mm_plan, wgrad_plan)

    err = {"conv1x1_mm": 0.0, "conv1x1_wgrad": 0.0}
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    cases = RN50_1X1 + tuple((name, m, cin, cout, None) for name, m, cin, cout in K3_SMALL)
    for i, (name, side, cin, cout, stride) in enumerate(cases):
        gen = torch.Generator(device=device).manual_seed(i)
        if stride is None:  # side is M
            x = torch.randn(side, cin, generator=gen, device=device, dtype=bf16)
        else:
            x = torch.randn(BATCH, side, side, cin, generator=gen, device=device, dtype=bf16)
            x = x[:, ::stride, ::stride, :].reshape(-1, cin).contiguous()
        w = torch.randn(cin, cout, generator=gen, device=device, dtype=bf16)
        g = torch.randn(x.shape[0], cout, generator=gen, device=device, dtype=bf16)
        y, dw, dw2 = conv1x1_mm(x, w), conv1x1_wgrad(x, g), conv1x1_wgrad(x, g)
        torch.cuda.synchronize()
        err["conv1x1_mm"] = max(err["conv1x1_mm"],
                                bf16_close(y, conv1x1_mm_reference(x, w), 1))
        err["conv1x1_wgrad"] = max(err["conv1x1_wgrad"],
                                   bf16_close(dw, conv1x1_wgrad_reference(x, g), 1))
        check(torch.equal(dw, dw2), f"K3b gave two results at {name}")
        if name == PROBE_SHAPE:
            check(torch.equal(graph_replay(lambda: conv1x1_wgrad(x, g)), dw),
                  "K3b under a CUDA-graph replay differs from its eager result")
            mp, wp = mm_plan(*x.shape, cout, sms), wgrad_plan(*x.shape, cout, sms)
            print(f"  K3 grids at the probe's shape on {sms} SMs: K3a {mp.ctas} CTAs over "
                  f"{mp.grid[0] * mp.grid[1]} tiles of {mp.tile}; K3b {wp.ctas} CTAs, "
                  f"{wp.splits} splits of {wp.chunk} rows of a {wp.tile} dw tile", flush=True)
        if stride is not None:
            rows.append(k3_timing_row(name, x, w, g))
    print(f"K3 kernels: conv1x1_mm and conv1x1_wgrad within 1 bf16 ulp + 1e-3 max of "
          f"their plain versions at {len(cases)} shapes (the {len(RN50_1X1)} rn50 1x1 "
          f"convs at batch 128, {', '.join(c[0] for c in K3_SMALL)}); K3b bit-equal across "
          f"two runs and a graph replay; max abs err {err}", flush=True)
    return {"err": err, "rows": rows}


def graph_replay(fn) -> torch.Tensor:
    """``fn()`` captured in a CUDA graph (after a warm-up call on a side
    stream, as torch asks), replayed twice; returns the replay's output."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return out


def k3_timing_row(name, x, w, g) -> dict:
    """K3a, K3b and cuBLAS's two products at one shape, beside the bound:
    device time from a CUDA graph of 20 calls replayed between CUDA events,
    and the time a call takes launched from Python, 20 back to back (the
    host's share shows where it exceeds the device time)."""
    from ursabench_tpu_torch.kernels.conv1x1 import conv1x1_mm, conv1x1_wgrad
    from ursabench_tpu_torch.profiling.int8_microbench import dispatch_ms, graph_ms

    (m, k), n = x.shape, w.shape[1]
    bound_ms, bound_by = bound(2 * (m * k + k * n + m * n), 2 * m * k * n, "bf16")
    calls = {"conv1x1_mm": lambda: conv1x1_mm(x, w), "matmul": lambda: x @ w,
             "conv1x1_wgrad": lambda: conv1x1_wgrad(x, g), "wgrad_matmul": lambda: x.T @ g}
    us = {label: graph_ms([fn], K3_TIMED_CALLS) * 1e3 for label, fn in calls.items()}
    per_call = {label: dispatch_ms(fn, K3_TIMED_CALLS) * 1e3 for label, fn in calls.items()}
    b = bound_ms * 1e3
    print(f"  {name} ({m}, {k}) @ ({k}, {n}): bound {b:.2f} us ({bound_by}); device K3a "
          f"{us['conv1x1_mm']:.2f} us ({b / us['conv1x1_mm'] * 100:.1f}%), cuBLAS x @ w "
          f"{us['matmul']:.2f} us ({b / us['matmul'] * 100:.1f}%); K3b "
          f"{us['conv1x1_wgrad']:.2f} us ({b / us['conv1x1_wgrad'] * 100:.1f}%), cuBLAS "
          f"x.T @ g {us['wgrad_matmul']:.2f} us ({b / us['wgrad_matmul'] * 100:.1f}%); a call "
          f"from Python {', '.join(f'{v:.1f}' for v in per_call.values())} us", flush=True)
    return {"name": name, "m": m, "k": k, "n": n, "bound_us": b, "bound_by": bound_by, **us,
            "per_call_us": per_call}


def probe_phase(device) -> dict:
    """The conv1x1 probe entry point; both K3 kernels must launch there."""
    from ursabench_tpu_torch.kernels.conv1x1 import conv1x1_mm, conv1x1_wgrad
    from ursabench_tpu_torch.profiling import conv1x1_probe

    conv1x1_mm.launches = conv1x1_wgrad.launches = 0
    res = conv1x1_probe.run(device)
    launches = {"conv1x1_mm": conv1x1_mm.launches, "conv1x1_wgrad": conv1x1_wgrad.launches}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the conv1x1 probe")
    rows = {r["variant"]: r for r in res["rows"]}
    for name, r in rows.items():
        check(math.isfinite(r["us"]) and r["us"] > 0, f"probe row {r}")
        print(f"  probe {name}: {r['us']:.2f} us, {r['gb_per_sec']:.1f} GB/s, "
              f"{r.get('pct_of_hbm_peak', float('nan')):.1f}% of HBM peak, "
              f"{r.get('pct_of_bf16_peak', float('nan')):.2f}% of bf16 peak", flush=True)
    sol = res.get("speed_of_light_us")
    check(sol is not None, "no peak bandwidth for this card in profiling/hw.py")
    print(f"conv1x1 probe {res['shape']}: gates passed; speed of light {sol:.1f} us; "
          f"K3a {rows['conv1x1_mm']['us']:.2f} us ({sol / rows['conv1x1_mm']['us'] * 100:.1f}%"
          f" of SoL) vs cuBLAS {rows['matmul']['us']:.2f} us; K3b "
          f"{rows['conv1x1_wgrad']['us']:.2f} us ({sol / rows['conv1x1_wgrad']['us'] * 100:.1f}%)"
          f" vs cuBLAS {rows['wgrad_matmul']['us']:.2f} us; launches {launches}", flush=True)
    return {"launches": launches, "rows": rows}


def model_check(device, test) -> None:
    """K3a and K3b on TVResNet-50's own layer1[1].conv1 (bf16, a real batch
    of 128 at 224^2) against cuDNN's forward of that conv and autograd's
    weight gradient of it."""
    import torch.nn.functional as F

    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.data.transforms import normalize
    from ursabench_tpu_torch.kernels.conv1x1 import conv1x1_mm, conv1x1_wgrad

    bf16 = torch.bfloat16
    m = models.get_model("TVResNet50").build(1000, dtype=bf16).to(device)
    m.init_parameters(torch.Generator().manual_seed(0))
    conv = m.layer1[1].conv1
    seen = {}
    hook = conv.register_forward_hook(
        lambda mod, inp, out: seen.update(x=inp[0].detach(), y=out.detach()))
    x = normalize(torch.from_numpy(test.images[:BATCH]).to(device), test.spec)
    with torch.no_grad():
        m.train()(x.permute(0, 3, 1, 2).contiguous())
    hook.remove()
    inp, out = seen["x"], seen["y"]
    check(tuple(inp.shape) == (BATCH, 256, 56, 56) and inp.dtype == bf16,
          f"layer1[1].conv1 input {tuple(inp.shape)} {inp.dtype}")
    rows = inp.permute(0, 2, 3, 1).reshape(-1, 256).contiguous()  # (401408, 256)
    w = conv.weight.detach().to(bf16)  # (64, 256, 1, 1)
    y = conv1x1_mm(rows, w.reshape(64, 256).T.contiguous())
    g = torch.randn(out.shape, generator=torch.Generator(device=device).manual_seed(1),
                    device=device, dtype=bf16)
    wb = w.clone().requires_grad_(True)
    F.conv2d(inp, wb).backward(g)
    dw = conv1x1_wgrad(rows, g.permute(0, 2, 3, 1).reshape(-1, 64).contiguous())
    torch.cuda.synchronize()
    e_mm = bf16_close(y, out.permute(0, 2, 3, 1).reshape(-1, 64), 2)
    e_wg = bf16_close(dw, wb.grad.reshape(64, 256).T, 2)
    print(f"  model check, TVResNet-50 layer1[1].conv1 on rows {tuple(rows.shape)}: K3a vs "
          f"cuDNN max abs err {e_mm:.3g}, K3b vs autograd {e_wg:.3g} (within 2 bf16 ulps "
          f"+ 1e-3 max)", flush=True)


def imagenet_phase(device) -> dict:
    """TVResNet-50 bf16 SGHMC + BMA at 224^2 (profiling/imagenet_train.run),
    then the K3 check on the model's own layer."""
    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.data.transforms import normalize
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat
    from ursabench_tpu_torch.profiling import imagenet_train as IT

    sghmc_update_flat.launches = 0
    res, ens, task, test = IT.run(device)
    launches = sghmc_update_flat.launches
    steps = (1 + IT.EPOCHS + 2) * (IT.N_TRAIN // IT.BATCH)
    check(launches == steps, f"K1 launched {launches} times, expected {steps}")
    losses = res["epoch_losses"]
    check(len(losses) == 1 + IT.EPOCHS + 2 and all(map(math.isfinite, losses)),
          f"losses {losses}")
    metrics = res["metrics"]
    err = metrics["error_rate"]
    for k, val in metrics.items():
        nan_by_design = k.startswith("misclass") and err in (0.0, 1.0)
        check(math.isfinite(val) or nan_by_design, f"metric {k} = {val}")
    x = normalize(torch.from_numpy(test.images[:BATCH]).to(device), test.spec)
    want = reference_probs(
        lambda: models.get_model("TVResNet50").build(IT.CLASSES, dtype=torch.bfloat16).to(device),
        ens, x.permute(0, 3, 1, 2).contiguous()).cpu().numpy()
    diff = float(np.abs(task.ensemble_proba[:BATCH] - want).max())
    check(diff < 1e-2, f"BMA probabilities differ from plain modules by {diff}")
    t, b = res["train"], res["bma_eval"]
    print(f"imagenet slice {res['model']}: {launches} K1 launches, epoch losses "
          f"{[round(v, 4) for v in losses]}; {t['steps_per_sec']:.2f} steps/s, "
          f"{t['images_per_sec']:.0f} img/s, {t['achieved_tflops']:.1f} TFLOP/s "
          f"({res['flops_per_step'] / 1e12:.3f} TFLOP a step), "
          f"{t.get('mfu_pct_of_bf16_peak', float('nan')):.1f}% of bf16 peak; BMA "
          f"{b['images_per_sec']:.0f} img/s ({b['members']} members, "
          f"{b.get('mfu_pct_of_bf16_peak', float('nan')):.1f}% of bf16 peak), equal to plain "
          f"modules within {diff:.2g}; data {res['data_seconds']:.1f} s", flush=True)
    model_check(device, test)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", flush=True)
        return 1
    device = torch.device("cuda")
    # float32 is the protocol dtype: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from ursabench_tpu_torch.profiling.hw import card_line

    card = card_line()
    print(card, flush=True)

    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.kernels import build, conv1x1, int8_gemv, sghmc, stream_probe
    from ursabench_tpu_torch.profiling import conv1x1_probe

    t0 = time.perf_counter()
    kernel_modules = (sghmc, int8_gemv, stream_probe, conv1x1)
    seconds = build.build([module.SOURCE for module in kernel_modules])
    for module in kernel_modules:
        module.load_library()
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, nvcc "
          + ", ".join(f"{s.name} {t:.2f} s" for s, t in seconds.items())
          + f" (in parallel), TF32 off; {time.perf_counter() - t0:.1f} s", flush=True)
    for kernel, line in build.ptxas_report(conv1x1.SOURCE).items():
        name = re.search(r"(conv1x1_[a-z]+_kernel)I((?:Li\d+E)+)", kernel)
        if name:  # conv1x1_mm_kernel<64, 8>: its template arguments
            kernel = f"{name[1]}<{', '.join(re.findall(r'Li(\d+)E', name[2]))}>"
        print(f"  ptxas {kernel}: {line}", flush=True)

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    n_slice = sum(p.numel() for p in models.get_model("PreResNet20").build(10).parameters())
    kernel = phase("K1", kernel_phase, device, n_slice)
    launches, splits, ens = phase("slice", slice_phase, device)
    int8_err = phase("int8 kernels", int8_kernel_phase, device)
    bench = phase("microbench", microbench_phase, device)
    phase("latency", latency_phase, device, ens, splits["test"])
    phase("profile_prediction", prediction_phase, device, splits)
    k3 = phase("K3 kernels", k3_kernel_phase, device)
    probe = phase("conv1x1 probe", probe_phase, device)
    phase("imagenet slice", imagenet_phase, device)

    kernels = [{
        "name": "sghmc_update", "route": "cuda",
        "source": "ursabench_tpu_torch/csrc/sghmc_update.cu",
        "replaces": "benchmarks/pallas_sgmcmc.py:75",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": None,
    }]
    v = bench["variants"]
    d = MICROBENCH_D
    for name, (source, replaces, variant) in INT8_KERNELS.items():
        gemv = name.startswith("int8")
        # the GEMVs' time is the kernel's alone, without quantizing x
        ms = v[variant].get("kernel_ms", v[variant]["ms"])
        plain_ms = v["int8_plain" if gemv else "stream_plain"]["ms"]
        bound_ms, bound_by = bound(v[variant]["bytes"], (2 if gemv else 1) * d * d, "int8")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"ursabench_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": bench["launches"][name],
                        "max_abs_err": int8_err[name], "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": v["int8_int_mm" if gemv else "stream_sum"]["ms"]})
    rows = probe["rows"]
    m, k, n = conv1x1_probe.M, conv1x1_probe.K, conv1x1_probe.N
    bound_ms, bound_by = bound(2 * (m * k + k * n + m * n), 2 * m * k * n, "bf16")
    for name, library in (("conv1x1_mm", "matmul"), ("conv1x1_wgrad", "wgrad_matmul")):
        kernels.append({"name": name, "route": "cuda",
                        "source": "ursabench_tpu_torch/csrc/conv1x1.cu",
                        "replaces": ("benchmarks/rn50_conv1x1_pallas_probe.py:39"
                                     if name == "conv1x1_mm" else
                                     "benchmarks/rn50_conv1x1_pallas_probe.py:66"),
                        "launches": probe["launches"][name], "max_abs_err": k3["err"][name],
                        "ms": rows[name]["us"] / 1e3,
                        "plain_ms": rows[f"{name}_plain"]["us"] / 1e3,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": rows[library]["us"] / 1e3})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
