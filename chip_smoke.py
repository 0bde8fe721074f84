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
   magnitude;
11. the samplers: WideResNet-28x10 at full width and depth (36,546,980
   parameters at 100 classes, bf16 compute) over synthetic CIFAR-100
   (2,048 train and 512 test images, batch 128, crop + flip; cut from
   50,000 train images), through the samplers' own entry points: cSGHMC
   with 2 chains (4 epochs, 4 members), cSGLD (2 members), SGD (3 epochs, 1
   member), DeepEnsemble (3 members, 2 epochs), MCdropout on the twin (5
   epochs, 4 members), SWA and SWAG (full_cov, max_rank 3, pca_rank 2; 5
   epochs, 3 members each), each followed by Prediction("ALL"): member and
   epoch counts, finite losses, ensembles and metrics, SGD's and
   DeepEnsemble's loss falling, DeepEnsemble's BMA equal to plain
   per-member modules within 1e-2, MCdropout's logits equal under one seed
   and different between members; K1 launched exactly once a step by
   cSGHMC (both chains in one launch) and cSGLD, 128 in all, and never by
   the others; bn_refresh equal to a plain recomputation from forward hooks
   within 1e-4 of each layer's largest statistic; K1 at the two stacked
   chains (73,093,960 floats) equal to its plain version with the noise
   off, its noise statistics, and both device times from CUDA graphs
   beside the 436 us bound;
12. the benchmark runner (experiment): `cli run` in this process, (a)
   BASELINE.md config 4 at full width and depth: WideResNet-28x10 bf16 /
   synthetic CIFAR-100 (2,048 train, 512 test images, batch 128), SGHMC
   with 2 chains (1 burn-in epoch, 2 draws), 2 trials of Prediction and OOD
   detection against STL10 and SVHN, then the Decision task on an
   imbalanced train set for each trial: every result key of the JAX runner
   finite, the OOD AUROCs in [0, 1], the CSV row and the .npz written, K1
   once a step for both chains over all four samplers, and (d) every
   chain's last-epoch loss below its first; (b) validation mode (one CSV
   row) and test mode on MLP200MNIST / MNIST with SGLD, the MNIST cost
   matrix and the FashionMNIST and KMNIST pairings; (c) that SGLD
   ensemble distilled onto MLP200MNIST and an entropy head, the distilled
   error within 0.2 of the ensemble's and the distilled OOD AUROCs in
   [0, 1]; the seconds of sampling, of each task's BMA passes and of its
   host metrics, and the step-forwards/s.
13. the hyperparameter-optimization layer (hypopt): (a) K1's per-row table
   at 4 PreResNet-20 rows (1,089,128 floats): bit-equal to its plain version
   with the noise off and distinct lr, momentum and weight decay a row; a
   (1, 5) table bit-equal to the float32[5] launch with the noise on; no
   noise in a row whose noise_scale is 0 and each other row's noise std
   within 1% of its noise_scale; its device time and 4 single-row launches'
   from CUDA graphs beside the 6.50 us bound; (b) BASELINE.md config 5
   through hyperopt.batched_bayesopt: PreResNet-20 at full width and depth,
   synthetic CIFAR-10 (10,240 train and 2,048 test images, cut from 50,000
   and 10,000), batch 128, crop + flip, SGHMC over lr (log 1e-3..0.2) and
   prior_std (log 0.3..3) at alpha 0.1, 1 draw after 1 burn-in epoch (cut
   from 4), 4 initial configs and 2 rounds of 4 (three sweeps of 4): 12 'll'
   objectives, finite ones <= 0, the best their max, every hyperparameter in
   its bounds, K1 once a sweep step (never 4 times); the sweep's
   step-forwards/s beside one config run solo, and each round's seconds of
   sampling, BMA, GP refit and acquisition; (c) an SGD sweep and a noise-off
   SGHMC sweep of 2 configs on MLP200MNIST equal to the 2 solo runs within
   1e-6 of the largest weight; (d) `cli hypopt` (BayesOpt, 3 random then 3
   GP evaluations, SGHMC on MLP200MNIST / MNIST) writing its _best.json;
   (e) `cli hypopt-par --dry_run` printing 2 commands that name
   ursabench_tpu_torch.experiment, the first run to rc 0; (f) BASELINE.md
   config 2, cut: LeNet5MNIST / FashionMNIST (8,192 train, 2,048 test), SGHMC
   with 4 chains (one K1 launch a step over 4 rows) and SWA, then one SGHMC
   epoch of ResNet20 / CIFAR-10 at full depth, each with Prediction: finite
   losses and metrics, the member counts.
14. HMC, the PCA-subspace ESS sampler, checkpoints and the timing entry point
   (hmc_ess): (a) HMC on MLP200MNIST over 60,000 synthetic MNIST images at
   the reference's tuned step size, L, tau and mass (float32, TF32 allowed
   outside the potential), 4 draws from the init (their log ratios
   printed), then 20 draws after 10 burn-in (cut from 300 after 200) from a
   1-epoch SGD warm start: some draw accepted, Prediction on the 11 kept
   members finite, the first draw's float32 log ratio within 1e-3 of its
   float64 recompute (its CE-sum difference against a float64 model's
   printed), the TF32 flags restored; seconds a draw and full-batch
   gradients/s; (b) HMC on PreResNet-20 at full width and depth, 2 chains,
   2,048 CIFAR-10 images, L 3, 4 draws after 1 burn-in: 8 members,
   Prediction finite; (c) the PCA-subspace ESS sampler on WideResNet-28x10
   bf16 at full width and depth over the samplers' CIFAR-100 cut, at the
   tuned values (lr_init 0.1, swag_lr 0.05, momentum 0.9, wd 5e-4,
   temperature 5000, prior_std 2, rank 20) with the SWA phase cut from 160
   burn-in epochs and 140 iterates to 1 and 20, 2 chains, 3 draws: subspace
   rank 20, the SWA's BatchNorm buffers unchanged by every log-density
   call, Prediction finite; bracket proposals and seconds a draw; (d) HMC
   (checkpoint every 2 draws, killed after 4 of 6), SGLD (every epoch) and
   PCA-ESS on MLP200MNIST killed and resumed: each equal to its
   uninterrupted run within 1e-6 of its largest weight (the largest
   difference printed); (e) `cli time` over the nine methods on
   MLP200MNIST / MNIST (10,000 train images, cut from 60,000), S=3, T cut
   from 10 to 2 after 1 warm-up trial: every method's mean beside the
   torch-CPU baseline, K1 once a step of the SGHMC, SGLD, cSGHMC and cSGLD
   trials.
15. host streaming and the rest of the profiling layer (stream): (a)
   PreResNet-20 / synthetic CIFAR-10 at full size (50,000 images, batch
   128, fp32, SGHMC on one chain), resident, streamed through
   HostStreamingSplit (M = 1) and chunked (M = 16): a warm-up epoch each,
   every streamed transfer of it compared on the card, after its step, with
   the host's gather of native.permutation(n, seed + epoch), then one timed
   epoch each in the order resident, streamed, chunked, chunked, streamed,
   resident: steps/s, streamed_pct_of_in_hbm, the host's time in the
   stream and in ursa_stream_next a step, H2D GB/s; K1 once a step; three
   float32-mode batches equal to gather_normalize; (b) TVResNet-50 bf16 at
   224x224, batch 128, SGHMC streamed from a uint8 memmap of 4,096 synthetic
   images written under smoke_out/stream/ (cut from ImageNet's 1,281,167):
   a checked warm-up epoch, a timed epoch beside the ImageNet slice's
   resident rate, an epoch under torch.profiler for the device's busy share
   and the copies' rate, finite losses; (c) `cli run --stream
   --stream_chunk 4`, SGLD on MLP200MNIST / MNIST, 2 trials: the result
   keys, K1 once a step; (d) PreResNet-20, S=6, batch 128, exported (fp32
   and bf16), saved and loaded: within 1e-5 (fp32) and 1e-2 (bf16) of the
   eager engine, one loaded call's ms; (e) profile_config with a trace_dir
   (MLP200MNIST, S=1, batch 1): the trace names CUDA kernels.
16. how C chains advance (chains): SGHMC at batch 128, one epoch a run,
   under "scan" (in turn) and "vmap" (one batched forward and backward), on
   MLP200MNIST and LeNet5MNIST (10,240 MNIST images) and PreResNet-20 fp32
   (2,048 CIFAR-10 images) at C = 1, 2, 4 and 8, and WideResNet-28x10 bf16
   (2,048 CIFAR-100 images) at C = 1, 2 and 4 (a C whose vmap run would not
   fit is skipped and printed): a warm-up epoch of each strategy (its peak
   memory), then epochs timed with CUDA events in the order scan, vmap,
   vmap, scan: aggregate and per-chain step-forwards/s and vmap/scan; K1
   once a step in every epoch; each model's vmap against scan from one seed
   over one batch, the first step's gradients and, after 4 noisy steps,
   parameters, momenta, BatchNorm statistics and losses: ||vmap - scan|| /
   ||scan|| within 1e-4 in fp32 (TF32 off); in bf16, vmap's distance from a
   float32 run of the same seed within twice bf16 scan's own; then HMC x4
   chains on MLP200MNIST (gradients/s, s a draw, accept rate, the same
   accepts and draws within 1e-4), PCA-ESS x4 chains on PreResNet-20 (a
   check draw in turn and in
   lock step from one state: the same brackets and points; s a draw,
   proposals) and MethodSweep K=4 on PreResNet-20 (step-forwards/s); the
   table printed, its JSON under smoke_out/chains/.
The latency phase (6.) also runs TVResNet-50 / ImageNet, S=2, batch 1 and
32, in the three precisions, bf16 under both member strategies and fp32 and
int8 under the 'auto' rule's.
Last of the phases, "mesh" (the device mesh, ``ursabench_tpu_torch/parallel``):
(a) K1 with a global element offset on 4 rows of PreResNet-20's flat size
(272,282, 2 mod 4): blocks of 2 + 2 and 1 + 3 rows, launched with their
offsets in place and as copies, bit-equal in p and v to the whole buffer's
launch, and one row's time at offsets 0 and 272,282 from CUDA graphs; (b)
two ranks sharing the card as child processes (gloo on CUDA tensors:
NCCL refuses two ranks on one device): PreResNet-20 SGHMC x2 chains on a
(2, 1) mesh against one process of the same seed (||a - b|| / ||b|| at
most 1e-5, TF32 off, cuDNN deterministic), Prediction on the sharded
ensemble equal to the gathered one, MLP200MNIST on (1, 2) within rtol
2e-4 / atol 1e-5 of one process with bit-equal replicas, K1 once a step on
each rank; the seconds are two processes on one card, no scaling figure;
(c) NCCL at a world size of 1 under ``torchrun --standalone``: one
all-reduce, and ``cli run --mesh auto`` with the result keys of a run
without torchrun; its JSON under smoke_out/mesh/.
Then a JSON line describing each kernel (its launches on the main path,
K1's summed over the slice, the ImageNet slice, the samplers, the
experiment, the hypopt, the hmc_ess, the stream, the chains and the mesh
phases, the mesh phase's two ranks included; its
error against its plain version, its time, the plain version's, its
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
# the samplers phase: WideResNet-28x10, bf16 compute, synthetic CIFAR-100
WRN_CLASSES, WRN_TRAIN, WRN_TEST = 100, 2048, 512
WRN_FLAT = 36546980  # WideResNet-28x10's parameters at 100 classes
WRN_STEPS = WRN_TRAIN // BATCH  # 16 steps an epoch
CYC_HYP = {"lr_0": 0.05, "prior_std": 1.0, "cycle_length": 4, "burn_in_epochs": 1,
           "num_samples_per_cycle": 2, "num_cycles": 1, "alpha": 0.1}
SGD_HYP = {"lr": 0.05, "epochs": 2, "momentum": 0.9, "weight_decay": 5e-4}
MCD_HYP = {"lr": 0.02, "epochs": 1, "dropout": 0.1, "lengthscale": 0.01, "num_samples": 4,
           "momentum": 0.9, "weight_decay": 0}
SWA_HYP = {"lr_init": 0.05, "swag_lr": 0.01, "swag_wd": 5e-4, "momentum": 0.9,
           "burn_in_epochs": 2, "num_iterates": 3, "num_samples": 3}
# sampler -> (constructor keywords, sample() keywords, members, epochs, chains)
SAMPLERS = {
    "cSGHMC": (dict(hyperparameters=CYC_HYP, chains=2), {}, 4, 4, 2),
    "cSGLD": (dict(hyperparameters=CYC_HYP), {}, 2, 4, 1),
    "SGD": (dict(hyperparameters=SGD_HYP), {}, 1, 3, 1),
    "DeepEnsemble": (dict(hyperparameters={**SGD_HYP, "epochs": 1, "num_members": 3}), {},
                     3, 2, 3),
    "MCdropout": (dict(hyperparameters=MCD_HYP, model_name="WideResNet28x10"), {}, 4, 5, 1),
    "SWA": (dict(hyperparameters=SWA_HYP, max_rank=3, pca_rank=2), {}, 3, 5, 1),
    "SWAG": (dict(hyperparameters=SWA_HYP, max_rank=3, pca_rank=2), {"full_cov": True},
             3, 5, 1),
}
K1_WRN_CALLS = 20  # graph-timed K1 calls at the two stacked WRN chains
# the experiment phase: BASELINE.md config 4 (WRN-28x10 / CIFAR-100, SGHMC with
# 2 chains, OOD against STL10 and SVHN) through `cli run`; SGHMC's hyperparameters
# are the reference's tuned ones for that pair (assets/tuned_hyperparams.json),
# cut to 1 burn-in epoch and 2 draws
EXP_HYP = {"lr": 0.1, "prior_std": 0.5, "alpha": 0.5, "burn_in_epochs": 1, "num_samples": 2}
EXP_TRIALS = 2
EXP_OUT = "smoke_out/experiment"  # the runner's CSV rows and .npz files
MNIST_HYP = {"lr": 0.03, "prior_std": 1.0, "num_samples": 4, "burn_in_epochs": 3}  # SGLD
MNIST_TRAIN, MNIST_TEST = 4096, 1024
# the hypopt phase: BASELINE.md config 5 (benchmarks/baseline_suite.py:161-195),
# burn-in cut from 4 epochs to 1 and the train split from 50,000 images
HP_ROWS, HP_TABLE_CALLS = 4, 200
HP_COPIES = 8  # copies of K1's table buffers timed in turn: 8 x 13 MB exceed the 50 MB L2
HP_TRAIN, HP_TEST = 10240, 2048
HP_DOMAIN = [
    {"name": "lr", "type": "continuous", "domain": (1e-3, 0.2), "option": "logspace"},
    {"name": "prior_std", "type": "continuous", "domain": (0.3, 3.0), "option": "logspace"},
    {"name": "alpha", "type": "constant", "domain": 0.1},
    {"name": "num_samples", "type": "constant", "domain": 1},
    {"name": "burn_in_epochs", "type": "constant", "domain": 1},
]
HP_BO = dict(rounds=2, q=4, init_evaluations=4, seed=7)
HP_OUT = "smoke_out/hypopt"
# BASELINE.md config 2 (benchmarks/baseline_suite.py:64-94), burn-in cut from 8
# epochs to 1, SWA's iterates from 10 to 2, FashionMNIST to 8,192 / 2,048 images
C2_HYP = {"lr": 0.01, "prior_std": 1.0, "num_samples": 3, "alpha": 0.1, "burn_in_epochs": 1}
C2_SWA = {"swag_lr": 0.005, "swag_wd": 1e-4, "lr_init": 0.02, "num_samples": 1,
          "momentum": 0.9, "burn_in_epochs": 1, "num_iterates": 2}
C2_TRAIN, C2_TEST, C2_CHAINS = 8192, 2048, 4
# the hmc_ess phase. (a) HMC at the reference's tuned MLP200MNIST values
# (assets/tuned_hyperparams.json) on full-size synthetic MNIST; its 300 draws
# after 200 burn-in cut to 20 after 10, from a 1-epoch SGD warm start (from the
# init, the tuned trajectories' energy error rejects nearly every draw: the
# cold run beside it shows it)
HE_MNIST_TRAIN, HE_MNIST_TEST = 60000, 10000
HE_DRAWS, HE_BURN, HE_COLD_DRAWS = 20, 10, 4
HE_WARM_SGD = {"lr": 0.01, "epochs": 0, "momentum": 0.9, "weight_decay": 3e-4}
# (b) HMC on PreResNet-20, 2 chains, eval-mode BatchNorm in the potential
HE_CONV_HYP = {"step_size": 1e-4, "num_samples": 4, "L": 3, "tau": 1.0, "burn": 1,
               "mass": 1.0}
HE_CONV_TRAIN, HE_CONV_TEST, HE_CONV_CHAINS = 2048, 512, 2
# (c) PCA-ESS on WRN-28x10 at the tuned WideResNet28x10CIFAR100 values, the SWA
# phase's 160 burn-in epochs and 140 iterates cut to 1 and 20
HE_PCA_CUT = {"swag_burn_in_epochs": 1, "num_swag_iterates": 20, "num_samples": 3}
HE_PCA_CHAINS = 2
# (d) kill and resume, MLP200MNIST on MNIST_TRAIN images
HE_RESUME = {
    "HMC": ({"step_size": 2e-4, "num_samples": 6, "L": 3, "tau": 100.0, "burn": 0,
             "mass": 0.19, "draw_chunk": 2}, 2, 4),
    "SGLD": ({"lr": 0.03, "prior_std": 1.0, "num_samples": 3, "burn_in_epochs": 1}, 1, 1),
    "PCASubspaceSampler": ({"swag_lr": 0.01, "swag_wd": 1e-4, "lr_init": 0.02,
                            "num_samples": 4, "swag_momentum": 0.9, "swag_burn_in_epochs": 1,
                            "num_swag_iterates": 3, "rank": 2, "max_rank": 3,
                            "temperature": 100.0, "prior_std": 1.0}, 1, 2),
}  # method -> (hyperparameters, checkpoint every, draws before the kill)
# (e) cli time over the nine methods: S=3, T cut from 10 to 2 after 1 warm-up
# trial, the train split from 60,000 images
HE_TIME_T, HE_TIME_WARMUP, HE_TIME_TRAIN, HE_TIME_TEST = 2, 1, 10000, 2000
HE_OUT = "smoke_out/hmc_ess"
# the stream phase: (a) PreResNet-20 streamed per batch and in chunks of 16
# (bench.py:146-148's chunk_batches), (b) TVResNet-50 from a memmap of
# ST_IMAGENET_N images (cut from ImageNet's 1,281,167), (c) cli run --stream,
# (d) export, (e) trace_dir
STREAM_CHUNK = 16
ST_IMAGENET_N = 4096
ST_OUT = "smoke_out/stream"
# the chains phase: one cut SGHMC epoch under scan and vmap at C chains, batch 128;
# model, dataset, train images, compute dtype, chain counts
CH_MODELS = (
    ("MLP200MNIST", "MNIST", 10240, "fp32", (1, 2, 4, 8)),
    ("LeNet5MNIST", "MNIST", 10240, "fp32", (1, 2, 4, 8)),
    ("PreResNet20", "CIFAR10", 2048, "fp32", (1, 2, 4, 8)),
    ("WideResNet28x10", "CIFAR100", 2048, "bf16", (1, 2, 4)),
)
CH_CHECK_STEPS, CH_CHECK_CHAINS = 4, 2  # vmap against scan: 4 noisy steps of 2 chains
# its limits: in float32, ||vmap - scan|| / ||scan|| (TF32 off); in bf16, vmap's
# distance from a float32 run of the same seed, as a multiple of bf16 scan's own
CH_FP32, CH_BF16 = 1e-4, 2.0
CH_ROWS = 4  # chains of the HMC and PCA-ESS rows, configs of the sweep row
CH_HMC = {"step_size": 2e-4, "num_samples": 2, "L": 10, "tau": 100.0, "burn": 0,
          "mass": 0.19, "grad_batch": 4096}
CH_PCA = {"swag_lr": 0.02, "swag_wd": 5e-4, "lr_init": 0.05, "num_samples": 1,
          "swag_momentum": 0.9, "swag_burn_in_epochs": 1, "num_swag_iterates": 4, "rank": 3,
          "max_rank": 4, "temperature": 5000.0, "prior_std": 2.0}
CH_SWEEP_LR = (0.01, 0.02, 0.05, 0.1)
CH_OUT = "smoke_out/chains"
# the mesh phase: (b) two ranks sharing the one card (gloo on CUDA tensors: NCCL
# refuses two ranks on one device), PreResNet-20 SGHMC x2 chains over MESH_TRAIN
# images on a (2, 1) mesh (one epoch, one draw: 4 steps) and MLP200MNIST x1 chain
# over MESH_MLP_TRAIN images on a (1, 2) mesh, each against one process of the
# same seed; (c) NCCL at a world size of 1 under torchrun
MESH_TRAIN, MESH_MLP_TRAIN = 512, 4096
MESH_HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 1, "alpha": 0.1, "burn_in_epochs": 0}
MESH_PRR_GAP = 1e-5  # PreResNet-20 on (2, 1) against one process: ||a - b|| / ||b||
MESH_TIMEOUT = 300  # seconds for the two ranks, or for one torchrun command
MESH_RUN = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--inference_method", "SGLD",
            "--hyperparams", json.dumps({**MNIST_HYP, "num_samples": 2, "burn_in_epochs": 1}),
            "--synthetic_n_train", "4096", "--synthetic_n_test", "1024", "--num_trials", "1"]
MESH_OUT = "smoke_out/mesh"


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
                                                       member_cost, profile_config,
                                                       random_ensemble,
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
            auto = resolve_member_strategy("auto", LATENCY_S, b, (3, 32, 32), prec,
                                           *member_cost("PreResNet20", 10, (3, 32, 32)))
            for strategy in (("scan", "vmap") if prec == "bf16" else (auto,)):
                r = profile_config(cfg, amortize_k=AMORTIZE_K, member_strategy=strategy,
                                   device=device)
                results.append((strategy == auto, r))
                if strategy == auto:
                    cache[cfg.key()] = r
    # TVResNet-50 / ImageNet (224^2, 1000 classes): every configuration, bf16
    # under both member strategies (the measurement behind the 'auto' rule
    # there), fp32 and int8 under the rule's choice (cut from both strategies,
    # to make room for the mesh phase)
    s, batches = TV_LATENCY
    for prec in ("fp32", "bf16", "int8"):
        for b in batches:
            cfg = ProfileConfig("TVResNet50", "ImageNet", prec, s, b)
            auto = resolve_member_strategy("auto", s, b, (3, 224, 224), prec,
                                           *member_cost("TVResNet50", 1000, (3, 224, 224)))
            by = {}
            for strategy in (("scan", "vmap") if prec == "bf16" else (auto,)):
                r = profile_config(cfg, amortize_k=TV_AMORTIZE_K, member_strategy=strategy,
                                   device=device)
                results.append((strategy == auto, r))
                by[strategy] = r["amortized_latency_s"]
                if strategy == auto:
                    cache[cfg.key()] = r
            print(f"  TVResNet50 {prec} S={s} bs{b}: device "
                  + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in by.items())
                  + f", auto {auto}", flush=True)
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
    res["k1_launches"] = launches
    return res


def k1_stacked_check(device) -> dict:
    """K1 at two stacked WideResNet-28x10 chains (one launch a step for
    both): equal to its plain version with the noise off, its noise
    statistics (and the two chains' rows independent), and both device
    times from CUDA graphs beside the bound."""
    from scipy import stats

    from ursabench_tpu_torch.kernels.sghmc import (sghmc_update_flat,
                                                   sghmc_update_flat_reference)
    from ursabench_tpu_torch.ops.sgmcmc import sghmc_scalars
    from ursabench_tpu_torch.profiling.int8_microbench import graph_ms

    n = 2 * WRN_FLAT
    gen = torch.Generator(device=device).manual_seed(2)
    p, v, g = (torch.randn(n, generator=gen, device=device) for _ in range(3))
    err = 0.0
    for first in (False, True):
        s = sghmc_scalars(lr=0.05, momentum=0.9, wd_over_n=1.0 / WRN_TRAIN,
                          n_train=float(WRN_TRAIN), noise_on=0.0, is_first_step=first,
                          device=device)
        pk, vk = p.clone(), v.clone()
        sghmc_update_flat(pk, vk, g, s, seed=3)
        pr, vr = p.clone(), v.clone()
        sghmc_update_flat_reference(pr, vr, g, s, torch.zeros_like(p))
        torch.cuda.synchronize()
        for got, want in ((pk, pr), (vk, vr)):
            check(torch.allclose(got, want, rtol=1e-6, atol=1e-7),
                  f"K1 != plain at the stacked WRN size, first={first}")
            err = max(err, float((got - want).abs().max()))
    del pk, vk, pr, vr
    lr, m = 0.05, 0.9
    expected = math.sqrt(2 * (1 - m) * lr) / WRN_TRAIN
    z = torch.zeros(n, device=device)
    pn, vn = z.clone(), z.clone()
    s = sghmc_scalars(lr=lr, momentum=m, wd_over_n=0.0, n_train=float(WRN_TRAIN),
                      noise_on=1.0, is_first_step=False, device=device)
    sghmc_update_flat(pn, vn, z, s, seed=5)
    rows = pn.view(2, WRN_FLAT).double()
    std, mean = float(rows.std()), float(rows.mean())
    check(abs(std / expected - 1) < 1e-3, f"noise std {std} vs {expected}")
    check(abs(mean) < 1e-3 * std, f"noise mean {mean}")
    corr = float(torch.corrcoef(rows[:, : 1 << 22])[0, 1])
    check(abs(corr) < 3e-3, f"the two chains' noise correlates: {corr}")
    sub = rows[0, :: 64].cpu().numpy() / expected
    ks = float(stats.kstest(sub, "norm").statistic)
    check(ks < 0.005, f"KS statistic {ks} against N(0,1)")
    del pn, vn, rows, z

    def kernel_call():
        sghmc_update_flat(p, v, g, s, seed=1)

    def plain_call():
        sghmc_update_flat_reference(p, v, g, s, torch.randn(n, device=device))

    ms = graph_ms([kernel_call], K1_WRN_CALLS)
    plain_ms = graph_ms([plain_call], K1_WRN_CALLS)
    bound_ms, bound_by = bound(SGHMC_BYTES * n, SGHMC_FLOPS * n, "f32")
    print(f"  K1 at 2 x WideResNet-28x10 ({n} floats): noise-off equal to plain (max abs "
          f"err {err:.3g}); noise std/expected {std / expected:.5f}, chains' correlation "
          f"{corr:.2g}, KS {ks:.4f}; device {ms * 1e3:.1f} us vs plain {plain_ms * 1e3:.1f} "
          f"us (graphs of {K1_WRN_CALLS} calls); bound {bound_ms * 1e3:.1f} us ({bound_by}), "
          f"{bound_ms / ms * 100:.1f}% of it", flush=True)
    return {"n": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def bn_refresh_check(device, train) -> None:
    """engine.bn_refresh on a bf16 WideResNet-28x10 against a plain
    recomputation: each BatchNorm's input captured by a forward hook over
    the same batches in train mode, its per-batch mean and biased variance
    in float64, averaged (the batches are equal in size). Within 1e-4 of
    each layer's largest statistic."""
    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.data.transforms import normalize
    from ursabench_tpu_torch.inference.engine import bn_refresh

    m = models.get_model("WideResNet28x10").build(WRN_CLASSES, dtype=torch.bfloat16).to(device)
    m.init_parameters(torch.Generator().manual_seed(4))
    images, _ = train.device_tensors(device)
    bn_refresh(m, train, images=images)
    bns = [b for b in m.modules() if isinstance(b, models.BatchNorm2d)]
    refreshed = [(b.running_mean.clone(), b.running_var.clone()) for b in bns]
    sums = {b: [0.0, 0.0] for b in bns}

    def hook(mod, inp, out):
        x = inp[0].double()
        sums[mod][0] = sums[mod][0] + x.mean(dim=(0, 2, 3))
        sums[mod][1] = sums[mod][1] + x.var(dim=(0, 2, 3), unbiased=False)

    hooks = [b.register_forward_hook(hook) for b in bns]
    with torch.no_grad():
        m.train()
        for i in range(0, train.n, train.batch_size):
            x = normalize(images[i: i + train.batch_size], train.spec)
            m(x.permute(0, 3, 1, 2).contiguous())
    for h in hooks:
        h.remove()
    worst = 0.0
    for b, (mean, var) in zip(bns, refreshed):
        for got, total in ((mean, sums[b][0]), (var, sums[b][1])):
            want = total / (train.n // train.batch_size)
            rel = float((got.double() - want).abs().max() / want.abs().max())
            worst = max(worst, rel)
    check(worst < 1e-4, f"bn_refresh differs from the hook recomputation by {worst:.3g}")
    print(f"  bn_refresh: {len(bns)} BatchNorm layers equal to the plain recomputation "
          f"within {worst:.2g} of each layer's largest statistic", flush=True)


def samplers_phase(device) -> dict:
    """Every epoch sampler on WideResNet-28x10 (bf16, 100 classes, full
    width and depth) over 2,048 synthetic CIFAR-100 images at batch 128,
    then Prediction on 512 test images; K1 once a step for cSGHMC's two
    chains and for cSGLD, and never for the others."""
    from ursabench_tpu_torch import data, inference, models, tasks
    from ursabench_tpu_torch.data.transforms import CIFAR_TEST, CIFAR_TRAIN, normalize
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    splits, num_classes = data.loaders(
        "CIFAR100", None, batch_size=BATCH, use_validation=False,
        transform_train=CIFAR_TRAIN, transform_test=CIFAR_TEST,
        synthetic_n_train=WRN_TRAIN, synthetic_n_test=WRN_TEST)
    train, test = splits["train"], splits["test"]
    check(num_classes == WRN_CLASSES and train.num_batches == WRN_STEPS and test.n == WRN_TEST,
          f"unexpected split {num_classes} {train.n} {test.n}")
    cfg = models.get_model("WideResNet28x10")
    build = lambda: cfg.build(WRN_CLASSES, dtype=torch.bfloat16)  # noqa: E731
    check(sum(p.numel() for p in build().parameters()) == WRN_FLAT, "WRN parameter count")
    x = normalize(torch.from_numpy(test.images[:BATCH]).to(device), test.spec)
    x = x.permute(0, 3, 1, 2).contiguous()

    sghmc_update_flat.launches = 0
    rows, k1_after = {}, {}
    for name, (kw, sample_kw, members, epochs, chains) in SAMPLERS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler = getattr(inference, name)(model=build(), train=train, seed=0, device=device,
                                           **kw)
        ens = sampler.sample(**sample_kw)
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        k1_after[name] = sghmc_update_flat.launches
        check(ens.num_members == members, f"{name}: {ens.num_members} members, not {members}")
        check(sampler.epochs_run == epochs and sampler.chains == chains,
              f"{name}: {sampler.epochs_run} epochs, {sampler.chains} chains")
        losses = torch.stack([torch.as_tensor(v).float().reshape(-1)
                              for v in sampler.epoch_losses])  # (epochs, chains)
        check(bool(torch.isfinite(losses).all()), f"{name}: losses {losses.tolist()}")
        for k, t in ens.state.items():
            check(bool(torch.isfinite(t).all()), f"{name}: non-finite ensemble entry {k}")
        if name in ("SGD", "DeepEnsemble"):
            check(bool((losses[-1] < losses[0]).all()),
                  f"{name}: the training loss did not fall: {losses.tolist()}")

        task = tasks.Prediction({"in_distribution_test": test}, num_classes, metric_list="ALL")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.update_statistics(ens, output_performance=False)
        torch.cuda.synchronize()
        bma_s = time.perf_counter() - t0
        metrics = task.get_performance_metrics()
        err = metrics["error_rate"]
        for k, val in metrics.items():
            nan_by_design = k.startswith("misclass") and err in (0.0, 1.0)
            check(math.isfinite(val) or nan_by_design, f"{name}: metric {k} = {val}")
        if name == "DeepEnsemble":  # the BMA pass against plain per-member modules
            want = reference_probs(lambda: build().to(device), ens, x).cpu().numpy()
            diff = float(np.abs(task.ensemble_proba[:BATCH] - want).max())
            check(diff < 1e-2, f"DeepEnsemble BMA differs from plain modules by {diff}")
        if name == "MCdropout":
            a, b = ens.logits_all(x, 0), ens.logits_all(x, 0)
            check(torch.equal(a, b), "MCdropout: one seed gave different logits")
            check(not torch.allclose(a[0], a[1]), "MCdropout: two members agree")
        steps = epochs * WRN_STEPS
        rows[name] = {"members": members, "epochs": epochs, "chains": chains, "steps": steps,
                      "sample_s": sample_s, "step_forwards_per_s": steps * chains / sample_s,
                      "bma_s": bma_s, "bma_img_per_s": test.n / bma_s, "error_rate": err,
                      "epoch_losses": losses.tolist()}
        print(f"  {name}: {members} members, {epochs} epochs x {chains} chain(s) of "
              f"{WRN_STEPS} steps in {sample_s:.2f} s, {steps * chains / sample_s:.2f} "
              f"step-forwards/s over sample(); BMA {test.n / bma_s:.0f} img/s ({bma_s:.2f} s); "
              f"error rate {err:.4f}; K1 launches so far {k1_after[name]}", flush=True)
        del sampler, ens, task

    cyc_steps = SAMPLERS["cSGHMC"][3] * WRN_STEPS
    check(k1_after["cSGHMC"] == cyc_steps, f"cSGHMC: {k1_after['cSGHMC']} K1 launches for "
          f"{cyc_steps} steps of 2 chains")
    launches = sghmc_update_flat.launches
    check(launches == 2 * cyc_steps, f"K1 launched {launches} times in the samplers phase, "
          f"expected {2 * cyc_steps} (cSGHMC and cSGLD only)")
    bn_refresh_check(device, train)
    k1 = k1_stacked_check(device)
    return {"launches": launches, "rows": rows, "k1": k1}


def _run_cli(argv, runs):
    """``cli run argv`` in this process, every sampler it makes recorded in
    ``runs``: its epochs, chains, batches an epoch, epoch losses (epochs,
    chains) and ensemble. Returns the seconds and K1's launches."""
    from ursabench_tpu_torch import cli, experiment
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    make = experiment._make_sampler

    def recording(args, hyp, module, train, seed, device, mesh=None):
        sampler = make(args, hyp, module, train, seed, device, mesh=mesh)
        sample = sampler.sample

        def sample_and_record():
            ens = sample()
            runs.append({"epochs": sampler.epochs_run, "chains": sampler.chains,
                         "batches": train.num_batches, "ensemble": ens,
                         "losses": torch.stack([torch.as_tensor(v).float().reshape(-1)
                                                for v in sampler.epoch_losses]).cpu()})
            return ens

        sampler.sample = sample_and_record
        return sampler

    experiment._make_sampler = recording
    try:
        sghmc_update_flat.launches = 0
        t0 = time.perf_counter()
        check(cli.main(["run", *argv]) == 0, f"cli run {argv} failed")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sghmc_update_flat.launches
    finally:
        experiment._make_sampler = make


def _check_launches(name, launches, runs) -> int:
    steps = sum(r["epochs"] * r["batches"] for r in runs)
    check(launches == steps, f"{name}: K1 launched {launches} times for {steps} steps "
          f"(all chains of a step in one launch)")
    return steps


def _csv_rows(path) -> list:
    import csv

    with open(path) as f:
        return list(csv.reader(f))


def _stage_line(timings) -> str:
    parts = [f"data {timings['data']:.2f} s, sampler set-up {timings['setup']:.2f} s, "
             f"sampling {timings['sample']:.2f} s"]
    for task in ("Prediction", "Decision", "OODDetection"):
        if f"{task}_bma" in timings:
            bma, host = timings[f"{task}_bma"], timings[f"{task}_host"]
            parts.append(f"{task} BMA {timings[f'{task}_images'] / bma:.0f} img/s "
                         f"({bma:.2f} s), host metrics {host:.3f} s")
    return "; ".join(parts)


def experiment_phase(device) -> dict:
    """The benchmark runner on the card, through `cli run`: (a) BASELINE
    config 4 at full width and depth in test mode, with the imbalanced
    Decision rerun; (b) validation mode, and test mode on MNIST; (c) the SGLD
    ensemble of (b) distilled and scored by the distilled tasks; (d) every
    SGHMC chain's training loss falling over its epochs in (a)."""
    import os

    from ursabench_tpu_torch import data, experiment, inference, models, tasks

    os.makedirs(EXP_OUT, exist_ok=True)
    for fn in os.listdir(EXP_OUT):
        os.remove(os.path.join(EXP_OUT, fn))
    out = {}

    # (a) WRN-28x10 bf16 / CIFAR-100, 2 chains, 2 trials, OOD STL10 + SVHN
    runs = []
    save = f"{EXP_OUT}/config4"
    argv = ["--dataset", "CIFAR100", "--model", "WideResNet28x10", "--dtype", "bf16",
            "--inference_method", "SGHMC", "--chains", "2", "--num_trials", str(EXP_TRIALS),
            "--synthetic_n_train", str(WRN_TRAIN), "--synthetic_n_test", str(WRN_TEST),
            "--batch_size", str(BATCH), "--use_dm_imbalance", "--save_path", save,
            "--hyperparams", json.dumps(EXP_HYP)]
    seconds, launches = _run_cli(argv, runs)
    timings = dict(experiment.TIMINGS)
    check(len(runs) == 2 * EXP_TRIALS, f"{len(runs)} samplers, not {2 * EXP_TRIALS}")
    epochs = EXP_HYP["burn_in_epochs"] + EXP_HYP["num_samples"]
    for r in runs:
        check(r["epochs"] == epochs and r["chains"] == 2
              and r["ensemble"].num_members == 2 * EXP_HYP["num_samples"],
              f"config 4: {r['epochs']} epochs, {r['chains']} chains")
        check(sum(p.numel() for p in r["ensemble"].module.parameters()) == WRN_FLAT,
              "config 4: not WRN-28x10's parameter count")
        # (d) SG-MCMC on the card: each chain's last epoch below its first
        losses = r["losses"]
        check(bool(torch.isfinite(losses).all()), f"config 4: losses {losses.tolist()}")
        check(bool((losses[-1] < losses[0]).all()),
              f"config 4: an SGHMC chain's loss did not fall: {losses.tolist()}")
    check(runs[0]["batches"] == WRN_STEPS and runs[-1]["batches"] <= WRN_STEPS,
          f"batches an epoch {[r['batches'] for r in runs]}")
    steps = _check_launches("config 4", launches, runs)
    results = dict(np.load(save + "_tests.npz"))
    metrics = ([m for m in tasks.Prediction.supported_metric_list]
               + [f"{kind}_uncertainty_auroc_{d}" for d in ("STL10", "SVHN")
                  for kind in ("total", "model")] + ["cost"])
    want = {f"{m}_{stat}" for m in metrics for stat in ("mean", "std")}
    check(set(results) == want, f"config 4 keys: {sorted(set(results) ^ want)}")
    # the two trials' error rates from their mean and std (ddof 1): a trial
    # that got every image right or wrong leaves the misclass ranks undefined
    half = float(results["error_rate_std"]) / math.sqrt(2)
    errs = [float(results["error_rate_mean"]) + sign * half for sign in (-1, 1)]
    degenerate = any(min(e, 1 - e) < 1e-6 for e in errs)
    for k, v in results.items():
        nan_by_design = k.startswith("misclass") and degenerate
        check(math.isfinite(float(v)) or nan_by_design, f"config 4: {k} = {v}")
        if "auroc" in k and k.endswith("_mean") and not nan_by_design:
            check(0.0 <= float(v) <= 1.0, f"config 4: {k} = {v}")
    rows = _csv_rows(save + "results.csv")
    check(len(rows) == 1 and len(rows[0]) == 6 + len(EXP_HYP) + len(want),
          f"config 4: CSV rows {[len(r) for r in rows]}")
    forwards = sum(r["epochs"] * r["batches"] * r["chains"] for r in runs)
    out["config4"] = {"seconds": seconds, "launches": launches, "steps": steps,
                      "step_forwards_per_s": forwards / timings["sample"],
                      "timings": timings,
                      "losses": [r["losses"].tolist() for r in runs],
                      "batches": [r["batches"] for r in runs],
                      "results": {k: float(v) for k, v in results.items()}}
    print(f"  config 4 (WRN-28x10 bf16 / CIFAR-100, SGHMC x2 chains, {EXP_TRIALS} trials + "
          f"{EXP_TRIALS} imbalanced): {seconds:.1f} s, K1 {launches} launches = {steps} steps; "
          f"{forwards / timings['sample']:.2f} step-forwards/s; {_stage_line(timings)}; "
          f"error {results['error_rate_mean']:.4f}, AUROC total/model STL10 "
          f"{results['total_uncertainty_auroc_STL10_mean']:.4f}/"
          f"{results['model_uncertainty_auroc_STL10_mean']:.4f}, SVHN "
          f"{results['total_uncertainty_auroc_SVHN_mean']:.4f}/"
          f"{results['model_uncertainty_auroc_SVHN_mean']:.4f}, imbalanced cost "
          f"{results['cost_mean']:.1f}; epoch losses "
          f"{[[round(v, 3) for v in r['losses'][:, c].tolist()] for r in runs for c in (0, 1)]}",
          flush=True)
    runs.clear()

    # (b) validation mode, then test mode on MNIST (FashionMNIST/KMNIST pairings)
    mnist = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--inference_method", "SGLD",
             "--batch_size", str(BATCH), "--synthetic_n_train", str(MNIST_TRAIN),
             "--synthetic_n_test", str(MNIST_TEST), "--hyperparams", json.dumps(MNIST_HYP)]
    seconds_val, launches_val = _run_cli(mnist + ["--use_val", "--save_path",
                                                  f"{EXP_OUT}/val_"], runs)
    steps_val = _check_launches("validation", launches_val, runs)
    rows = _csv_rows(f"{EXP_OUT}/val_results.csv")
    check(len(rows) == 1 and len(rows[0]) == 6 + len(MNIST_HYP) + 11,
          f"validation: CSV rows {[len(r) for r in rows]}")
    runs.clear()
    seconds_mnist, launches_mnist = _run_cli(mnist + ["--save_path", f"{EXP_OUT}/mnist"], runs)
    mnist_timings = dict(experiment.TIMINGS)
    steps_mnist = _check_launches("MNIST", launches_mnist, runs)
    res = dict(np.load(f"{EXP_OUT}/mnist_tests.npz"))
    for d in ("FashionMNIST", "KMNIST"):
        for kind in ("total", "model"):
            v = float(res[f"{kind}_uncertainty_auroc_{d}_mean"])
            check(0.0 <= v <= 1.0, f"MNIST: {kind} AUROC against {d} = {v}")
    splits, c = data.loaders("MNIST", None, BATCH, use_validation=False,
                             synthetic_n_train=MNIST_TRAIN, synthetic_n_test=MNIST_TEST,
                             transform_train=models.get_model("MLP200MNIST").transform_train,
                             transform_test=models.get_model("MLP200MNIST").transform_test)
    ens = runs[0]["ensemble"]
    dec = tasks.Decision({"decision_data_test": splits["test"]}, c)
    cost = dec.update_statistics(ens, output_performance=True)["True_Cost"]
    check(dec.cost_mat[3, 0] == dec.cost_mat[7, 1] == 100.0 and dec.cost_mat[0, 3] == 0.1,
          "MNIST cost matrix")
    check(abs(cost - float(res["cost_mean"])) < 1e-6, f"MNIST cost {cost} vs {res['cost_mean']}")
    print(f"  MNIST (MLP200MNIST, SGLD): validation mode {seconds_val:.1f} s, 1 CSV row, "
          f"K1 {launches_val} launches; test mode {seconds_mnist:.1f} s, K1 {launches_mnist}, "
          f"{_stage_line(mnist_timings)}; error {float(res['error_rate_mean']):.4f}, cost "
          f"{cost:.1f}, AUROC total FashionMNIST "
          f"{float(res['total_uncertainty_auroc_FashionMNIST_mean']):.4f}, KMNIST "
          f"{float(res['total_uncertainty_auroc_KMNIST_mean']):.4f}", flush=True)

    # (c) distillation of the MNIST ensemble onto MLP200MNIST and a small head
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pair = inference.distill_ensemble(ens, splits["train"],
                                      models.get_model("MLP200MNIST").build(c),
                                      inference.EntropyHead(784), epochs=15, lr=2e-3,
                                      seed=0, device=device)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    pred = tasks.PredictionDistilled({"in_distribution_test": splits["test"]}, c,
                                     metric_list=["error_rate", "nll"])
    pred.update_statistics(pair, output_performance=False)
    dm = pred.get_performance_metrics()
    ens_err = float(res["error_rate_mean"])
    check(dm["error_rate"] <= ens_err + 0.2 and math.isfinite(dm["nll"]),
          f"distilled error {dm['error_rate']} vs the ensemble's {ens_err}")
    ood, _ = data.loaders("FashionMNIST", None, BATCH, use_validation=False,
                          synthetic_n_train=BATCH, synthetic_n_test=MNIST_TEST)
    dood = tasks.OODDetectionDistilled({"in_distribution_test": splits["test"],
                                        "out_distribution_test": ood["test"]}, c
                                       ).update_statistics(pair, output_performance=True)
    check(all(0.0 <= v <= 1.0 for v in dood.values()), f"distilled OOD {dood}")
    print(f"  distillation: {distill_s:.2f} s (2 x 15 epochs of Adam), distilled error "
          f"{dm['error_rate']:.4f} against the ensemble's {ens_err:.4f}; distilled OOD "
          f"FashionMNIST {json.dumps(dood)}", flush=True)
    runs.clear()

    out["mnist"] = {"validation_s": seconds_val, "test_s": seconds_mnist,
                    "timings": mnist_timings, "error_rate": ens_err, "cost": cost,
                    "distill_s": distill_s, "distilled": dm, "distilled_ood": dood}
    out["launches"] = launches + launches_val + launches_mnist
    out["steps"] = steps + steps_val + steps_mnist
    with open(f"{EXP_OUT}/experiment_phase.json", "w") as f:
        json.dump(out, f, indent=1)
    return out


def k1_table_check(device, row_len: int) -> dict:
    """K1's per-row table at HP_ROWS PreResNet-20 rows: bit-equal to its
    plain version with the noise off, a (1, 5) table bit-equal to the
    float32[5] launch with the noise on, the noise gated and scaled row by
    row; device times of one table launch and of HP_ROWS single-row launches
    (one a row, each with its float32[5]) from CUDA graphs, beside the bound.
    Each timed launch takes the next of HP_COPIES copies of (p, v, g), so it
    reads them from HBM, as in a sweep step, whose forwards and backwards
    evict the L2 between updates; one copy alone (L2-resident) is timed
    beside it."""
    from ursabench_tpu_torch.kernels.sghmc import (sghmc_update_flat,
                                                   sghmc_update_flat_reference)
    from ursabench_tpu_torch.ops.sgmcmc import sghmc_scalars
    from ursabench_tpu_torch.profiling.int8_microbench import graph_ms

    rows, n_train = HP_ROWS, float(HP_TRAIN)
    gen = torch.Generator(device=device).manual_seed(11)
    p, v, g = (torch.randn(rows, row_len, generator=gen, device=device) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=device)
    lr = torch.tensor([0.1, 0.05, 0.02, 0.005], **f32)
    mom = torch.tensor([0.9, 0.5, 0.99, 0.0], **f32)
    wd = torch.tensor([1e-4, 3e-5, 1e-3, 0.0], **f32)
    for first in (False, True):
        table = sghmc_scalars(lr=lr, momentum=mom, wd_over_n=wd, n_train=n_train,
                              noise_on=0.0, is_first_step=first, device=device)
        pk, vk = p.clone(), v.clone()
        sghmc_update_flat(pk, vk, g, table, seed=3)
        pr, vr = p.clone(), v.clone()
        sghmc_update_flat_reference(pr, vr, g, table, torch.zeros_like(p))
        torch.cuda.synchronize()
        check(torch.equal(pk, pr) and torch.equal(vk, vr),
              f"K1's table != plain at {rows} x {row_len}, first={first}")
    one = sghmc_scalars(lr=0.05, momentum=0.9, wd_over_n=1e-4, n_train=n_train, noise_on=1.0,
                        is_first_step=False, device=device)
    a, b = [p.clone(), v.clone()], [p.clone(), v.clone()]
    sghmc_update_flat(*a, g, one, seed=17)
    sghmc_update_flat(*b, g, one.view(1, 5), seed=17)
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "a (1, 5) table != the float32[5]")
    # per-row noise from zeros: row 0's noise_scale is 0, the others' differ
    gate = torch.tensor([0.0, 1.0, 1.0, 1.0], **f32)
    table = sghmc_scalars(lr=lr, momentum=mom, wd_over_n=torch.zeros_like(wd), n_train=n_train,
                          noise_on=gate, is_first_step=False, device=device)
    z = torch.zeros(rows, row_len, **f32)
    pn, vn = z.clone(), z.clone()
    sghmc_update_flat(pn, vn, z, table, seed=5)
    scale = table[:, 3].double()
    ratio = (pn.double().std(dim=1)[1:] / scale[1:]).cpu()
    check(float(pn[0].abs().max()) == 0.0, "noise in the row whose noise_scale is 0")
    check(bool(((ratio - 1).abs() < 0.01).all()), f"per-row noise std / scale {ratio.tolist()}")
    corr = float(torch.corrcoef(pn[1:].double())[0, 1])
    check(abs(corr) < 0.01, f"rows' noise correlates: {corr}")

    single = [sghmc_scalars(lr=float(lr[r]), momentum=float(mom[r]), wd_over_n=float(wd[r]),
                            n_train=n_train, noise_on=1.0, is_first_step=False, device=device)
              for r in range(rows)]
    table = sghmc_scalars(lr=lr, momentum=mom, wd_over_n=wd, n_train=n_train, noise_on=1.0,
                          is_first_step=False, device=device)

    copies = [(p, v, g)] + [tuple(t.clone() for t in (p, v, g)) for _ in range(HP_COPIES - 1)]

    def table_call(p, v, g):
        return lambda: sghmc_update_flat(p, v, g, table, seed=1)

    def row_calls(p, v, g):
        def call():
            for r in range(rows):
                sghmc_update_flat(p[r], v[r], g[r], single[r], seed=1 + r)
        return call

    def plain_call(p, v, g):
        return lambda: sghmc_update_flat_reference(p, v, g, table,
                                                   torch.randn(p.shape, device=device))

    ms, rows_ms, plain_ms = (graph_ms([call(*c) for c in copies], HP_TABLE_CALLS)
                             for call in (table_call, row_calls, plain_call))
    l2_ms = graph_ms([table_call(p, v, g)], HP_TABLE_CALLS)
    n = rows * row_len
    bound_ms, bound_by = bound(SGHMC_BYTES * n, SGHMC_FLOPS * n, "f32")
    print(f"  K1 table at {rows} x {row_len} ({n} floats): noise-off bit-equal to plain, "
          f"(1, 5) = float32[5], row 0 noiseless, rows 1-3 std/scale "
          f"{', '.join(f'{x:.4f}' for x in ratio.tolist())}, correlation {corr:.2g}; device "
          f"{ms * 1e3:.2f} us vs {rows} single-row launches {rows_ms * 1e3:.2f} us vs plain "
          f"{plain_ms * 1e3:.2f} us (graphs of {HP_TABLE_CALLS}, {HP_COPIES} copies in turn); "
          f"bound {bound_ms * 1e3:.2f} us ({bound_by}), {bound_ms / ms * 100:.1f}% of it; "
          f"one copy (L2-resident) {l2_ms * 1e3:.2f} us", flush=True)
    return {"n": n, "ms": ms, "rows_ms": rows_ms, "plain_ms": plain_ms, "l2_ms": l2_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "noise_ratio": ratio.tolist(),
            "corr": corr}


def _in_bounds(hyp, domain) -> bool:
    return all(d["domain"][0] * (1 - 1e-6) <= hyp[d["name"]] <= d["domain"][1] * (1 + 1e-6)
               for d in domain if d["type"] == "continuous")


def config5_run(device) -> dict:
    """BASELINE.md config 5 through hyperopt.batched_bayesopt, then one of
    its configs run solo for comparison."""
    from ursabench_tpu_torch import data, hyperopt, inference, models, tasks
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    cfg = models.get_model("PreResNet20")
    t0 = time.perf_counter()
    splits, c = data.loaders("CIFAR10", None, batch_size=BATCH, use_validation=False,
                             transform_train=cfg.transform_train,
                             transform_test=cfg.transform_test,
                             synthetic_n_train=HP_TRAIN, synthetic_n_test=HP_TEST)
    data_s = time.perf_counter() - t0
    train, test = splits["train"], splits["test"]

    def task_factory():
        return tasks.Prediction({"in_distribution_test": test}, c, metric_list=["ll"])

    before = sghmc_update_flat.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds = []
    best_hyp, best_obj, hyps, objs = hyperopt.batched_bayesopt_sghmc(
        HP_DOMAIN, cfg.build(c), train, task_factory, device=device, round_seconds=rounds,
        **HP_BO)
    torch.cuda.synchronize()
    bo_s = time.perf_counter() - t0
    launches = sghmc_update_flat.launches - before
    sweeps = 1 + HP_BO["rounds"]
    epochs = HP_DOMAIN[4]["domain"] + 1
    steps = sweeps * epochs * train.num_batches
    check(launches == steps, f"config 5: K1 launched {launches} times for {steps} sweep steps")
    n_obj = HP_BO["init_evaluations"] + HP_BO["rounds"] * HP_BO["q"]
    finite = [o for o in objs if math.isfinite(o)]
    check(len(objs) == len(hyps) == n_obj and finite, f"config 5: objectives {objs}")
    check(best_obj == max(objs), f"config 5: best {best_obj} is not the max of {objs}")
    check(all(o <= 0 for o in finite), f"config 5: a log-likelihood above 0: {objs}")
    check(all(_in_bounds(h, HP_DOMAIN) for h in hyps), f"config 5: out of bounds {hyps}")
    forwards = HP_BO["q"] * epochs * train.num_batches

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = inference.SGHMC(dict(hyps[0]), model=cfg.build(c), train=train, seed=0,
                           device=device)
    solo.sample()
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo_rate = epochs * train.num_batches / solo_s
    rates = [forwards / r["sample"] for r in rounds]
    print(f"  config 5 (PreResNet-20 / CIFAR-10 {train.n} train, {test.n} test; batched BO "
          f"{HP_BO}): {bo_s:.1f} s, K1 {launches} launches = {steps} sweep steps (4 configs "
          f"a launch); sweep step-forwards/s {', '.join(f'{x:.1f}' for x in rates)} vs one "
          f"config solo {solo_rate:.1f} steps/s ({solo_s:.2f} s with set-up); best ll "
          f"{best_obj:.4f} at {json.dumps(best_hyp)}; all ll "
          f"{[round(o, 4) for o in objs]}; data {data_s:.1f} s", flush=True)
    for i, r in enumerate(rounds):
        gp = (f", GP refit {r['gp_fit'] * 1e3:.1f} ms, acquisition "
              f"{r['acquisition'] * 1e3:.1f} ms" if "gp_fit" in r else "")
        print(f"    sweep {i}: sampling {r['sample']:.2f} s, BMA {r['bma']:.2f} s{gp}",
              flush=True)
    return {"seconds": bo_s, "launches": launches, "steps": steps, "objs": objs,
            "best_hyp": best_hyp, "best_obj": best_obj, "rounds": rounds,
            "sweep_step_forwards_per_s": rates, "solo_steps_per_s": solo_rate,
            "solo_s": solo_s, "solo_epochs": epochs, "data_s": data_s}


def sweep_equals_solo(device) -> float:
    """An SGD sweep and a noise-off SGHMC sweep of 2 configs on MLP200MNIST
    against the 2 solo samplers of the same seeds; returns the largest
    difference over the largest weight."""
    from ursabench_tpu_torch import data, inference, models
    from ursabench_tpu_torch.util import derive_seed

    splits, c = data.loaders("MNIST", None, batch_size=BATCH, use_validation=False,
                             synthetic_n_train=MNIST_TRAIN, synthetic_n_test=MNIST_TEST)
    build = lambda: models.get_model("MLP200MNIST").build(c)  # noqa: E731
    cases = {
        "SGD": [{"lr": lr, "epochs": 1, "momentum": 0.9, "weight_decay": 5e-4}
                for lr in (0.05, 0.1)],
        "SGHMC": [{"lr": lr, "prior_std": ps, "num_samples": 1, "alpha": 0.1,
                   "burn_in_epochs": 0} for lr, ps in ((0.05, 1.0), (0.02, 0.5))],
    }
    worst = 0.0
    for method, hyps in cases.items():
        # in turn, as each solo run: equal to it, not within vmap's rounding
        sweep = inference.MethodSweep(hyps, model=build(), train=splits["train"], seed=3,
                                      method=method, device=device, chain_strategy="scan")
        if method == "SGD":
            got = [e.state for e in sweep.sample()]
        else:
            sweep.sampler._run_epoch(noise_on=False)
            got = [m.state_dict() for m in sweep.modules]
        for k, h in enumerate(hyps):
            solo = getattr(inference, method)(h, model=build(), train=splits["train"],
                                              seed=derive_seed(3, "config", k), device=device)
            if method == "SGD":
                want = solo.sample().state
            else:
                solo._run_epoch(noise_on=False)
                want = solo.module.state_dict()
            for name, w in want.items():
                diff = float((got[k][name].float() - w.float()).abs().max())
                worst = max(worst, diff / float(w.float().abs().max()))
    check(worst <= 1e-6, f"a sweep config differs from its solo run by {worst:.3g} of the max")
    return worst


def hypopt_entry_points(device, tmp) -> dict:
    """`cli hypopt` (sequential BayesOpt) and `cli hypopt-par --dry_run`, one of
    whose commands is then run."""
    import contextlib
    import io
    import os
    import subprocess

    from ursabench_tpu_torch import cli, run_hypopt

    domain_path = os.path.join(tmp, "domain.json")
    with open(domain_path, "w") as f:
        json.dump([{"name": "lr", "type": "continuous", "domain": [1e-3, 0.1],
                    "option": "logspace"},
                   {"name": "prior_std", "type": "continuous", "domain": [0.5, 2.0],
                    "option": "linspace"},
                   {"name": "num_samples", "type": "constant", "domain": 2},
                   {"name": "burn_in_epochs", "type": "constant", "domain": 1}], f)
    common = ["--domain_path", domain_path, "--dataset", "MNIST", "--model", "MLP200MNIST",
              "--synthetic_n_train", str(MNIST_TRAIN), "--synthetic_n_test", str(MNIST_TEST)]
    save = os.path.join(tmp, "bo")
    t0 = time.perf_counter()
    check(cli.main(["hypopt", *common, "--inference_method", "SGHMC", "--N_evaluations", "3",
                    "--init_evaluations", "3", "--save_path", save]) == 0, "cli hypopt failed")
    seq_s = time.perf_counter() - t0
    with open(save + "_best.json") as f:
        best = json.load(f)
    check(len(best["times"]) == 6 and math.isfinite(best["max_obj"]),
          f"cli hypopt's _best.json: {best}")

    par = common + ["--inference_method", "SGLD", "--N_evaluations", "2", "--dry_run"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(cli.main(["hypopt-par", *par]) == 0, "cli hypopt-par failed")
    lines = [ln for ln in out.getvalue().splitlines() if "-m ursabench_tpu_torch.experiment" in ln]
    check(len(lines) == 2, f"hypopt-par printed {out.getvalue()!r}")
    with contextlib.redirect_stdout(io.StringIO()):
        commands = run_hypopt.main_par(par, device=device)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")]))}
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, *commands[0][1:], "--synthetic_n_train",
                          str(MNIST_TRAIN), "--synthetic_n_test", str(MNIST_TEST)],
                         cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
    par_s = time.perf_counter() - t0
    check(run.returncode == 0, f"the hypopt-par command failed:\n{run.stderr[-2000:]}")
    print(f"  cli hypopt: BayesOpt 3 + 3 evaluations in {seq_s:.1f} s, best ll "
          f"{best['max_obj']:.4f} at {json.dumps(best['best_hyp'])}; cli hypopt-par --dry_run: "
          f"2 commands, the first run to rc 0 in {par_s:.1f} s", flush=True)
    return {"seq_s": seq_s, "best": best, "par_command_s": par_s}


def config2_run(device) -> dict:
    """BASELINE.md config 2, cut: LeNet5MNIST / FashionMNIST, SGHMC with 4
    chains and SWA, then one SGHMC epoch of ResNet20 / CIFAR-10, each scored
    by Prediction."""
    from ursabench_tpu_torch import data, inference, models, tasks
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    out = {}
    resnet_hyp = {"lr": 0.05, "prior_std": 1.0, "num_samples": 1, "alpha": 0.1,
                  "burn_in_epochs": 0}
    runs = (("LeNet5MNIST", "FashionMNIST", "SGHMC",
             dict(hyperparameters=C2_HYP, chains=C2_CHAINS), 3 * C2_CHAINS, C2_TRAIN),
            ("LeNet5MNIST", "FashionMNIST", "SWA", dict(hyperparameters=C2_SWA),
             C2_SWA["num_iterates"], C2_TRAIN),
            ("ResNet20", "CIFAR10", "SGHMC", dict(hyperparameters=resnet_hyp), 1,
             C2_TRAIN // 2))
    for name, dataset, method, kw, members, n_train in runs:
        cfg = models.get_model(name)
        splits, c = data.loaders(dataset, None, batch_size=BATCH, use_validation=False,
                                 transform_train=cfg.transform_train,
                                 transform_test=cfg.transform_test,
                                 synthetic_n_train=n_train, synthetic_n_test=C2_TEST)
        before = sghmc_update_flat.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler = getattr(inference, method)(model=cfg.build(c), train=splits["train"], seed=2,
                                             device=device, **kw)
        ens = sampler.sample()
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        launches = sghmc_update_flat.launches - before
        steps = sampler.epochs_run * splits["train"].num_batches
        check(ens.num_members == members, f"{name} {method}: {ens.num_members} members")
        check(launches == (steps if method == "SGHMC" else 0),
              f"{name} {method}: K1 launched {launches} times for {steps} steps")
        losses = torch.stack([torch.as_tensor(x).float().reshape(-1)
                              for x in sampler.epoch_losses])
        check(bool(torch.isfinite(losses).all()), f"{name} {method}: losses {losses.tolist()}")
        task = tasks.Prediction({"in_distribution_test": splits["test"]}, c,
                                metric_list=["error_rate", "nll", "ece"])
        task.update_statistics(ens, output_performance=False)
        metrics = task.get_performance_metrics()
        check(all(math.isfinite(x) for x in metrics.values()), f"{name} {method}: {metrics}")
        out[f"{name}_{method}"] = {"sample_s": sample_s, "launches": launches, "steps": steps,
                                   "members": members, "chains": sampler.chains,
                                   "metrics": metrics, "losses": losses.tolist()}
        print(f"  {name} / {dataset} {method} x{sampler.chains} chain(s): {members} members, "
              f"{sampler.epochs_run} epochs of {splits['train'].num_batches} steps in "
              f"{sample_s:.2f} s, K1 {launches}; epoch losses "
              f"{[[round(x, 4) for x in row] for row in losses.tolist()]}; "
              f"{json.dumps(metrics)}", flush=True)
    return out


def hypopt_phase(device, row_len: int) -> dict:
    """The hyperparameter-optimization layer on the card: K1's table, then
    config 5, the sweep against solo runs, the two CLI commands and config 2,
    whose K1 launches are counted."""
    import os
    import tempfile

    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    table = k1_table_check(device, row_len)
    sghmc_update_flat.launches = 0
    res = {"k1_table": table, "config5": config5_run(device)}
    res["sweep_vs_solo"] = sweep_equals_solo(device)
    print(f"  sweep vs solo (MLP200MNIST, SGD and noise-off SGHMC, 2 configs): largest "
          f"difference {res['sweep_vs_solo']:.3g} of the largest weight", flush=True)
    os.makedirs(HP_OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HP_OUT) as tmp:
        res["cli"] = hypopt_entry_points(device, tmp)
    res["config2"] = config2_run(device)
    res["launches"] = sghmc_update_flat.launches
    with open(f"{HP_OUT}/hypopt_phase.json", "w") as f:
        json.dump(res, f, indent=1, default=str)
    return res


def _metrics_finite(name, metrics) -> None:
    err = metrics["error_rate"]
    for k, val in metrics.items():
        nan_by_design = k.startswith("misclass") and err in (0.0, 1.0)
        check(math.isfinite(val) or nan_by_design, f"{name}: metric {k} = {val}")


def _predict(name, ens, split, num_classes) -> dict:
    from ursabench_tpu_torch import tasks

    task = tasks.Prediction({"in_distribution_test": split}, num_classes, metric_list="ALL")
    task.update_statistics(ens, output_performance=False)
    metrics = task.get_performance_metrics()
    _metrics_finite(name, metrics)
    return metrics


def _timed_sample(sampler, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = sampler.sample(**kw)
    torch.cuda.synchronize()
    return ens, time.perf_counter() - t0


def _ce_sum_f64(module, theta, split, device) -> float:
    """The CE sum over ``split`` in float64, of a float64 copy of ``module``
    with flat weights ``theta`` (``parameters()`` order)."""
    import copy

    from ursabench_tpu_torch.data.transforms import normalize

    m = copy.deepcopy(module).double().eval()
    with torch.no_grad():
        offset = 0
        for p in m.parameters():
            p.copy_(theta[offset: offset + p.numel()].view_as(p))
            offset += p.numel()
        images, labels = split.device_tensors(device)
        total = torch.zeros((), dtype=torch.float64, device=device)
        for i in range(0, split.n, 4096):
            x = normalize(images[i: i + 4096], split.spec).double().permute(0, 3, 1, 2)
            total += torch.nn.functional.cross_entropy(m(x.contiguous()), labels[i: i + 4096],
                                                       reduction="sum")
    return float(total)


def hmc_tuned_run(device) -> dict:
    """(a) HMC on MLP200MNIST at the reference's tuned values over 60,000
    synthetic MNIST images (float32, grad_batch 4096), TF32 allowed around it
    (HMC turns it off in its potential): a cold start from the init, then
    the cut chain from a 1-epoch SGD warm start, Prediction on its kept
    draws, and its first draw's float32 log ratio against float64."""
    from ursabench_tpu_torch import data, inference, models, time_script

    splits, c = data.loaders("MNIST", None, batch_size=BATCH, use_validation=False,
                             synthetic_n_train=HE_MNIST_TRAIN, synthetic_n_test=HE_MNIST_TEST)
    tuned = time_script.load_method_hyp(None, "HMC")
    check(tuned["L"] == 40 and abs(tuned["step_size"] - 2.0897e-4) < 1e-7,
          f"tuned HMC values: {tuned}")
    build = lambda: models.get_model("MLP200MNIST").build(c)  # noqa: E731
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cold = inference.HMC({**tuned, "num_samples": HE_COLD_DRAWS, "burn": 0}, model=build(),
                             train=splits["train"], seed=0, device=device)
        cold_ratios = []
        transition = cold._transition

        def record_cold(theta, ll, draws=None):
            out = transition(theta, ll, draws)
            cold_ratios.append(out[3])
            return out

        cold._transition = record_cold
        cold.sample()
        cold_ratios = [float(r) for r in cold_ratios]
        check(all(math.isfinite(r) for r in cold_ratios), f"cold log ratios {cold_ratios}")

        sgd = inference.SGD(HE_WARM_SGD, model=build(), train=splits["train"], seed=0,
                            device=device)
        sgd.sample()
        hmc = inference.HMC({**tuned, "num_samples": HE_DRAWS, "burn": HE_BURN}, model=build(),
                            train=splits["train"], seed=0, device=device)
        hmc._theta0 = sgd._state.params.detach().clone().reshape(1, -1)
        first = []
        transition = hmc._transition

        def record_first(theta, ll, draws=None):
            out = transition(theta, ll, draws)
            if not first:
                first.append((theta.clone(), ll.clone(), out))
            return out

        hmc._transition = record_first
        ens, sample_s = _timed_sample(hmc)
        check(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32,
              "HMC did not restore the TF32 flags")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    check(hmc.accept_rate > 0, f"HMC accepted no draw of {HE_DRAWS}")
    check(ens.num_members == HE_DRAWS + 1 - HE_BURN, f"HMC: {ens.num_members} members")
    for k, t in ens.state.items():
        check(bool(torch.isfinite(t).all()), f"HMC: non-finite ensemble entry {k}")
    metrics = _predict("HMC", ens, splits["test"], c)

    theta, ll_cur, (_, _, _, log_ratio, (th, p0, p_new, ll_new)) = first[0]
    f64 = [t.double() for t in (theta, th, p0, p_new)]
    tau, inv_mass = hmc.tau, 1.0 / hmc.mass
    sq = lambda a, b: float(torch.sum(a * a) - torch.sum(b * b))  # noqa: E731
    ratio64 = ((float(ll_cur) - float(ll_new)) - 0.5 * tau * sq(f64[1], f64[0])
               - 0.5 * inv_mass * sq(f64[3], f64[2]))
    ratio_err = abs(float(log_ratio) - ratio64)
    check(ratio_err < 1e-3, f"HMC's first log ratio {float(log_ratio)} vs float64 {ratio64}")
    # for the record: the float32 model's own error in the data term
    ce64 = [_ce_sum_f64(hmc.module, t, splits["train"], device) for t in (theta, th)]
    ce_err = abs((float(ll_cur) - float(ll_new)) - (ce64[0] - ce64[1]))
    grads = HE_DRAWS * (hmc.L + 1)
    out = {"accept_rate": hmc.accept_rate, "cold_accept_rate": cold.accept_rate,
           "cold_log_ratios": cold_ratios, "sample_s": sample_s,
           "s_per_draw": sample_s / HE_DRAWS, "grads_per_s": grads / sample_s,
           "log_ratio": float(log_ratio), "log_ratio_f64": ratio64, "log_ratio_err": ratio_err,
           "ce_diff_err_vs_f64_model": ce_err, "metrics": metrics,
           "warm_sgd_losses": [float(x) for x in sgd.epoch_losses]}
    print(f"  (a) HMC MLP200MNIST / MNIST {HE_MNIST_TRAIN}, tuned step {hmc.step_size:.4g}, "
          f"L {hmc.L}, tau {hmc.tau:g}, mass {hmc.mass:.4g}: cold start accept rate "
          f"{cold.accept_rate:.3f} over {HE_COLD_DRAWS} draws (log ratios "
          f"{[round(r, 3) for r in cold_ratios]}); from the SGD warm start (loss "
          f"{out['warm_sgd_losses'][-1]:.4f}) {HE_DRAWS} draws in {sample_s:.2f} s, accept rate "
          f"{hmc.accept_rate:.3f}, {sample_s / HE_DRAWS:.4f} s/draw, {grads / sample_s:.1f} "
          f"full-batch gradients/s; first log ratio {float(log_ratio):.6f}, float64 "
          f"{ratio64:.6f} (|diff| {ratio_err:.3g}), CE-sum difference vs a float64 model "
          f"{ce_err:.3g}; {ens.num_members} members: {json.dumps(metrics)}", flush=True)
    return out


def hmc_conv_run(device) -> dict:
    """(b) HMC on PreResNet-20 at full width and depth, 2 chains, over 2,048
    synthetic CIFAR-10 images: eval-mode BatchNorm and cuDNN convolutions in
    the potential; members = kept draws x 2."""
    from ursabench_tpu_torch import data, inference, models

    cfg = models.get_model("PreResNet20")
    splits, c = data.loaders("CIFAR10", None, batch_size=BATCH, use_validation=False,
                             transform_train=cfg.transform_train,
                             transform_test=cfg.transform_test,
                             synthetic_n_train=HE_CONV_TRAIN, synthetic_n_test=HE_CONV_TEST)
    hmc = inference.HMC(HE_CONV_HYP, model=cfg.build(c), train=splits["train"], seed=1,
                        device=device, chains=HE_CONV_CHAINS)
    ens, sample_s = _timed_sample(hmc)
    kept = HE_CONV_HYP["num_samples"] + 1 - HE_CONV_HYP["burn"]
    check(ens.num_members == kept * HE_CONV_CHAINS,
          f"HMC x{HE_CONV_CHAINS} chains: {ens.num_members} members, not {kept} x 2")
    metrics = _predict("HMC PreResNet-20", ens, splits["test"], c)
    grads = HE_CONV_HYP["num_samples"] * HE_CONV_CHAINS * (HE_CONV_HYP["L"] + 1)
    print(f"  (b) HMC PreResNet-20 x{HE_CONV_CHAINS} chains, {HE_CONV_TRAIN} images, L "
          f"{HE_CONV_HYP['L']}: {ens.num_members} members in {sample_s:.2f} s, "
          f"{grads / sample_s:.1f} full-batch gradients/s, accept rate {hmc.accept_rate:.3f}; "
          f"{json.dumps(metrics)}", flush=True)
    return {"sample_s": sample_s, "members": ens.num_members, "accept_rate": hmc.accept_rate,
            "grads_per_s": grads / sample_s, "metrics": metrics}


def pca_wrn_run(device) -> dict:
    """(c) The PCA-subspace ESS sampler on WideResNet-28x10 bf16 at full
    width and depth over the samplers phase's synthetic CIFAR-100 cut, 2
    chains, 3 draws: the SWA's trained BatchNorm buffers untouched by every
    log-density call, Prediction finite."""
    from ursabench_tpu_torch import data, inference, models, time_script
    from ursabench_tpu_torch.data.transforms import CIFAR_TEST, CIFAR_TRAIN

    splits, c = data.loaders("CIFAR100", None, batch_size=BATCH, use_validation=False,
                             transform_train=CIFAR_TRAIN, transform_test=CIFAR_TEST,
                             synthetic_n_train=WRN_TRAIN, synthetic_n_test=WRN_TEST)
    tuned = time_script.load_method_hyp(None, "PCASubspaceSampler", model="WideResNet28x10",
                                        dataset="CIFAR100")
    check((tuned["lr_init"], tuned["swag_lr"], tuned["swag_momentum"], tuned["swag_wd"],
           tuned["temperature"], tuned["prior_std"], tuned["rank"])
          == (0.1, 0.05, 0.9, 5e-4, 5000, 2.0, 20), f"tuned PCA-ESS values: {tuned}")
    pca = inference.PCASubspaceSampler(
        {**tuned, **HE_PCA_CUT}, model=models.get_model("WideResNet28x10").build(
            c, dtype=torch.bfloat16), train=splits["train"], seed=2, device=device,
        chains=HE_PCA_CHAINS)
    swa_sample, lnpdf, state = pca.swa.sample, pca.lnpdf, {"calls": 0}

    def timed_swa(*a, **kw):
        t0 = time.perf_counter()
        out = swa_sample(*a, **kw)
        torch.cuda.synchronize()
        state["swa_s"] = time.perf_counter() - t0
        return out

    def checked_lnpdf(theta):
        if "trained" not in state:
            state["trained"] = {k: b.clone() for k, b in pca.module.named_buffers()}
        out = lnpdf(theta)
        state["calls"] += 1
        for k, b in pca.module.named_buffers():
            check(torch.equal(b, state["trained"][k]),
                  f"PCA-ESS: log-density call {state['calls']} changed the SWA's {k}")
        return out

    pca.swa.sample, pca.lnpdf = timed_swa, checked_lnpdf
    ens, sample_s = _timed_sample(pca)
    draws = HE_PCA_CUT["num_samples"]
    check(ens.num_members == draws * HE_PCA_CHAINS, f"PCA-ESS: {ens.num_members} members")
    check(pca.subspace.rank == tuned["rank"], f"PCA-ESS subspace rank {pca.subspace.rank}")
    for k, t in ens.state.items():
        check(bool(torch.isfinite(t).all()), f"PCA-ESS: non-finite ensemble entry {k}")
    metrics = _predict("PCA-ESS", ens, splits["test"], c)
    ess_s = sample_s - state["swa_s"]
    out = {"rank": pca.subspace.rank, "bracket_iters": pca.bracket_iters,
           "lnpdf_calls": state["calls"], "sample_s": sample_s, "swa_s": state["swa_s"],
           "ess_s_per_draw": ess_s / draws, "metrics": metrics}
    print(f"  (c) PCA-ESS WRN-28x10 bf16 x{HE_PCA_CHAINS} chains: SWA {pca.swa.epochs_run} "
          f"epochs in {state['swa_s']:.2f} s, subspace rank {pca.subspace.rank}; {draws} draws: "
          f"bracket proposals per draw and chain {pca.bracket_iters}, {state['calls']} "
          f"full-data log densities, {ess_s / draws:.2f} s a draw (both chains, the last with "
          f"its BatchNorm refresh); SWA's BatchNorm buffers unchanged; {json.dumps(metrics)}",
          flush=True)
    return out


def resume_checks(device, tmp) -> dict:
    """(d) HMC, SGLD and PCA-ESS on MLP200MNIST killed mid-chain and
    resumed from their checkpoints: each ensemble against its uninterrupted
    run's."""
    import os

    from ursabench_tpu_torch import data, inference, models

    splits, c = data.loaders("MNIST", None, batch_size=BATCH, use_validation=False,
                             synthetic_n_train=MNIST_TRAIN, synthetic_n_test=MNIST_TEST)
    out = {}
    for method, (hyp, every, kill_at) in HE_RESUME.items():
        def make():
            return getattr(inference, method)(hyp, model=models.get_model("MLP200MNIST").build(c),
                                              train=splits["train"], seed=3, device=device)

        path = os.path.join(tmp, f"{method}.npz")
        full, part = make(), make()
        part.enable_auto_checkpoint(path, every_epochs=every, resume=False)
        if method == "SGLD":  # an epoch sampler: its chain resumes, its draws do not
            want = [full.sample_iterative() for _ in range(hyp["num_samples"])]
            got = [part.sample_iterative() for _ in range(kill_at)]
            res = make()
            check(res.enable_auto_checkpoint(path, every_epochs=every), f"{method}: no resume")
            got += [res.sample_iterative() for _ in range(hyp["num_samples"] - kill_at)]
            pairs = [(g[k], w[k]) for g, w in zip(got, want) for k in w]
        else:
            want = full.sample().state
            part.sample(num_samples=kill_at)
            res = make()
            check(res.enable_auto_checkpoint(path, every_epochs=every), f"{method}: no resume")
            got = res.sample().state
            pairs = [(got[k], want[k]) for k in want]
        diff = max(float((g - w).abs().max()) for g, w in pairs)
        scale = max(float(w.abs().max()) for _, w in pairs)
        check(diff <= 1e-6 * scale, f"{method}: the resumed run differs by {diff}")
        out[method] = {"max_abs_diff": diff, "bit_equal": diff == 0.0}
    print(f"  (d) kill and resume on MLP200MNIST: "
          + ", ".join(f"{m} largest difference {r['max_abs_diff']:.3g}"
                      + (" (bit-equal)" if r["bit_equal"] else "") for m, r in out.items()),
          flush=True)
    return out


def time_run(device, tmp) -> dict:
    """(e) ``cli time`` over the nine methods on MLP200MNIST / MNIST at the
    tuned values, beside the torch-CPU baseline; K1 once a step of the
    SGHMC-family trials."""
    import os

    from ursabench_tpu_torch import cli, time_script
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    save = os.path.join(tmp, "times")
    sghmc_update_flat.launches = 0
    t0 = time.perf_counter()
    check(cli.main(["time", "--dataset", "MNIST", "--model", "MLP200MNIST", "--S", "3",
                    "--T", str(HE_TIME_T), "--warmup_trials", str(HE_TIME_WARMUP),
                    "--save_path", save, "--synthetic_n_train", str(HE_TIME_TRAIN),
                    "--synthetic_n_test", str(HE_TIME_TEST)]) == 0, "cli time failed")
    seconds = time.perf_counter() - t0
    launches = sghmc_update_flat.launches
    with open(save + ".json") as f:
        timer = json.load(f)
    steps_per_epoch = -(-HE_TIME_TRAIN // BATCH)
    epochs = 0
    for m in ("SGHMC", "SGLD", "cSGHMC", "cSGLD"):
        hyp = time_script.normalize_burnin(m, time_script.load_method_hyp(None, m), 3)
        epochs += hyp["cycle_length"] if m.startswith("c") else hyp["burn_in_epochs"] + 3
    want = (HE_TIME_T + HE_TIME_WARMUP) * epochs * steps_per_epoch
    check(launches == want, f"cli time: K1 launched {launches} times, expected {want}")
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "assets", "method_times_mlp200_cpu.json")) as f:
        cpu = json.load(f)
    for m in time_script.DEFAULT_METHODS:
        check(timer[f"{m}_trials"] == HE_TIME_T and math.isfinite(timer[f"{m}_mean"]),
              f"cli time: {m} {timer.get(m + '_mean')} over {timer.get(m + '_trials')}")
        base = (f"{cpu[m + '_mean']:.3f} s over {cpu[m + '_trials']} trials"
                if m + "_mean" in cpu else "none")
        print(f"    {m}: {timer[m + '_mean']:.3f} +- {timer[m + '_std']:.3f} s over "
              f"{HE_TIME_T} trials; torch-CPU baseline (60,000 images) {base}", flush=True)
    print(f"  (e) cli time: {seconds:.1f} s, K1 {launches} launches", flush=True)
    return {"seconds": seconds, "launches": launches, "times": timer}


def hmc_ess_phase(device) -> dict:
    """HMC, the PCA-subspace ESS sampler, mid-chain resume and the timing
    entry point on the card; K1's launches are those of (e)."""
    import os
    import tempfile

    os.makedirs(HE_OUT, exist_ok=True)
    res = {}
    for key, fn in (("hmc_tuned", hmc_tuned_run), ("hmc_conv", hmc_conv_run),
                    ("pca_wrn", pca_wrn_run)):
        t0 = time.perf_counter()
        res[key] = fn(device)
        res[key]["phase_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=HE_OUT) as tmp:
        res["resume"] = resume_checks(device, tmp)
        res["time"] = time_run(device, tmp)
    res["launches"] = res["time"]["launches"]
    with open(f"{HE_OUT}/hmc_ess_phase.json", "w") as f:
        json.dump(res, f, indent=1, default=str)
    return res


class _CheckedStream:
    """A ``HostStreamingSplit`` whose every device batch is compared, on the
    device, with ``expected`` (the host's gather of the epoch's permutation,
    on the card) after the consumer has queued its step on the batch: a
    pinned slot overwritten before its copy finished, or a device batch
    reused while the step still read it, leaves a mismatch. ``bad`` counts
    the mismatched bytes and labels (a device tensor, read once)."""

    def __init__(self, split, expected):
        self.split, self.expected = split, expected  # (images, labels) on the card
        self.bad = torch.zeros((), dtype=torch.int64, device=expected[0].device)
        self.checked = 0

    def __getattr__(self, name):
        return getattr(self.split, name)

    def epoch(self, device):
        rows = self.split.batch_size * self.split.chunk_batches
        for t, (x, y) in enumerate(self.split.epoch(device)):
            yield x, y
            xe = self.expected[0][t * rows:(t + 1) * rows].view(x.shape)
            ye = self.expected[1][t * rows:(t + 1) * rows].view(y.shape)
            self.bad += (x != xe).sum() + (y != ye).sum()
            self.checked += 1


def _expected_epoch(split, device):
    """The next epoch's batches as the host gathers them: ``images[perm]``
    and ``labels[perm]`` for ``perm = native.permutation(n, seed + epoch)``,
    the tail dropped, on the card."""
    from ursabench_tpu_torch.data import native

    perm = native.permutation(split.n, split.seed + split.epochs_started)
    perm = perm[:split.num_batches * split.batch_size]
    return (torch.from_numpy(split.images[perm]).to(device),
            torch.from_numpy(split.labels[perm]).to(device))


def _stream_sampler(device, train, model, chunk):
    """An SGHMC sampler on a uint8 stream of ``train`` (seed 0, ``chunk``
    batches a transfer), after one warm-up epoch through ``_CheckedStream``
    (every transfer byte-equal to the host's gather). Returns (sampler,
    stream, checked transfers)."""
    from ursabench_tpu_torch import inference
    from ursabench_tpu_torch.data.native import HostStreamingSplit

    stream = HostStreamingSplit(train.images, train.labels, train.batch_size, train.spec,
                                seed=0, chunk_batches=chunk)
    checked = _CheckedStream(stream, _expected_epoch(stream, device))
    sampler = inference.SGHMC(HYP, model=model, train=checked, seed=0, device=device)
    sampler._run_epoch()
    bad = int(checked.bad)
    check(bad == 0 and checked.checked == stream.num_chunks,
          f"streamed batches (M={chunk}): {bad} mismatched bytes over {checked.checked} "
          f"transfers")
    sampler.train = stream
    return sampler, stream, checked.checked


def _timed_epoch(sampler, stats=None) -> float:
    """ms a step of one epoch of ``sampler`` (CUDA events); ``stats`` (a
    dict) gains the epoch's change of its stream's counters."""
    from ursabench_tpu_torch.profiling.hw import event_ms

    split = sampler.train
    before = dict(split.stats) if stats is not None else None
    ms = event_ms(sampler._run_epoch, 1) / split.num_batches
    if stats is not None:
        for k, v in split.stats.items():
            stats[k] = stats.get(k, 0) + v - before[k]
    return ms


def _stream_line(stats, steps) -> str:
    gbs = stats["bytes"] / stats["copy_s"] / 1e9 if stats["copy_s"] else float("nan")
    return (f"host in the stream's iterator {stats['host_s'] / steps * 1e3:.3f} ms a step "
            f"(of it in ursa_stream_next {stats['wait_s'] / steps * 1e3:.3f}), H2D "
            f"{gbs:.1f} GB/s over {stats['transfers']} copies of "
            f"{stats['bytes'] / max(stats['transfers'], 1) / 1e6:.2f} MB (events around "
            f"the copies)")


def stream_cifar(device, splits) -> dict:
    """(a) PreResNet-20 / CIFAR-10 (50,000 images, batch 128, fp32, SGHMC, one
    chain), resident, streamed (M=1) and chunked (M=16): a warm-up epoch
    each (every streamed transfer checked byte for byte), then one timed
    epoch each in the order resident, streamed, chunked, chunked, streamed,
    resident; float32-mode batches against gather_normalize."""
    from ursabench_tpu_torch import inference, models
    from ursabench_tpu_torch.data import native
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    train = splits["train"]
    cfg = models.get_model("PreResNet20")
    sghmc_update_flat.launches = 0
    resident = inference.SGHMC(HYP, model=cfg.build(10), train=train, seed=0, device=device)
    resident._run_epoch()
    modes = {"resident": (resident, None, 0)}
    for name, chunk in (("streamed", 1), ("chunked", STREAM_CHUNK)):
        modes[name] = _stream_sampler(device, train, cfg.build(10), chunk)
    ms = {name: [] for name in modes}
    stats = {name: {} for name in modes}
    for name in ("resident", "streamed", "chunked", "chunked", "streamed", "resident"):
        sampler = modes[name][0]
        ms[name].append(_timed_epoch(sampler, None if name == "resident" else stats[name]))
    steps = sum(3 * m[0].train.num_batches for m in modes.values())
    launches = sghmc_update_flat.launches
    check(launches == steps, f"stream (a): K1 launched {launches} times for {steps} steps")
    out = {"launches": launches}
    for name, (sampler, stream, checked) in modes.items():
        losses = [float(v) for v in sampler.epoch_losses]
        check(len(losses) == 3 and all(map(math.isfinite, losses)), f"{name}: losses {losses}")
        sps = [1e3 / v for v in ms[name]]
        out[name] = {"steps_per_sec": sps, "steps": sampler.train.num_batches,
                     "checked_transfers": checked, "stats": stats[name], "losses": losses}
        if stream is not None:
            print(f"  {name} (M={stream.chunk_batches}): "
                  f"{' / '.join(f'{v:.1f}' for v in sps)} steps/s over {stream.num_batches} "
                  f"steps; {checked} transfers of the warm-up epoch byte-equal to the host's "
                  f"gather; {_stream_line(stats[name], 2 * stream.num_batches)}", flush=True)
    mean = {name: sum(out[name]["steps_per_sec"]) / 2 for name in modes}
    out["streamed_pct_of_in_hbm"] = 100 * mean["streamed"] / mean["resident"]
    out["chunked_pct_of_in_hbm"] = 100 * mean["chunked"] / mean["resident"]

    # float32 mode: dataio.cc's normalization, moved as it is
    stream = native.HostStreamingSplit(train.images, train.labels, BATCH, train.spec, seed=5,
                                       transfer_dtype="float32")
    perm = native.permutation(train.n, 5)
    for t, (x, y) in enumerate(stream.epoch(device)):
        if t == 3:
            break
        wx, wy = native.gather_normalize(train.images, train.labels,
                                         perm[t * BATCH:(t + 1) * BATCH],
                                         train.spec.mean, train.spec.std)
        check(x.dtype == torch.float32 and torch.equal(x.cpu(), torch.from_numpy(wx))
              and torch.equal(y.cpu(), torch.from_numpy(wy).long()),
              f"float32 streamed batch {t} differs from gather_normalize")
    print(f"  PreResNet-20 / CIFAR-10 bs{BATCH} fp32 SGHMC, steps/s in the order R S C C S R: "
          f"resident {' / '.join(f'{v:.1f}' for v in out['resident']['steps_per_sec'])}, "
          f"streamed {' / '.join(f'{v:.1f}' for v in out['streamed']['steps_per_sec'])}, "
          f"chunked (M={STREAM_CHUNK}) "
          f"{' / '.join(f'{v:.1f}' for v in out['chunked']['steps_per_sec'])}; "
          f"streamed_pct_of_in_hbm {out['streamed_pct_of_in_hbm']:.1f}, chunked "
          f"{out['chunked_pct_of_in_hbm']:.1f} (means of the two); K1 {launches} launches = "
          f"{steps} steps; 3 float32-mode batches equal to gather_normalize", flush=True)
    return out


def stream_imagenet(device, resident_sps) -> dict:
    """(b) TVResNet-50 bf16 at 224^2, batch 128, SGHMC, streamed from a uint8
    memmap of ``ST_IMAGENET_N`` synthetic images (cut from 1,281,167): one
    checked warm-up epoch, one timed epoch, one epoch under torch.profiler
    for the device's busy share."""
    import os

    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.data.arrays import DataSplit
    from ursabench_tpu_torch.data.transforms import IMAGENET_TRAIN
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat
    from ursabench_tpu_torch.profiling import imagenet_train as IT
    from ursabench_tpu_torch.profiling.step_profile import device_times

    os.makedirs(ST_OUT, exist_ok=True)
    path = f"{ST_OUT}/imagenet_train.npy"
    t0 = time.perf_counter()
    images, labels = IT.synth_imagenet(ST_IMAGENET_N, 0)
    np.save(path, images)
    del images
    images = np.load(path, mmap_mode="r")
    data_s = time.perf_counter() - t0
    check(not images.flags.writeable and images.shape == (ST_IMAGENET_N, 224, 224, 3),
          "the ImageNet memmap")
    train = DataSplit(images, labels, BATCH, IMAGENET_TRAIN)
    model = models.get_model("TVResNet50").build(IT.CLASSES, dtype=torch.bfloat16)
    sghmc_update_flat.launches = 0
    sampler, stream, checked = _stream_sampler(device, train, model, 1)
    steps = stream.num_batches
    delta = {}
    ms = _timed_epoch(sampler, delta)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sampler._run_epoch()
        torch.cuda.synchronize()
    launches = sghmc_update_flat.launches
    check(launches == 3 * steps, f"stream (b): K1 launched {launches} times for {3 * steps} steps")
    losses = [float(v) for v in sampler.epoch_losses]
    check(len(losses) == 3 and all(map(math.isfinite, losses)), f"stream (b): losses {losses}")
    times = device_times(prof)
    copy_us = sum(us for k, (_, us) in times.items() if k.startswith("Memcpy"))
    kernel_us = sum(us for k, (_, us) in times.items() if not k.startswith("Mem"))
    busy = kernel_us / 1e3 / steps / ms * 100
    slot_bytes = delta["bytes"] / delta["transfers"]
    prof_gbs = slot_bytes * steps / copy_us / 1e3 if copy_us else float("nan")
    del sampler, stream, train, images
    os.remove(path)
    out = {"n": ST_IMAGENET_N, "steps": steps, "steps_per_sec": 1e3 / ms,
           "resident_steps_per_sec": resident_sps, "pct_of_resident": 1e3 / ms / resident_sps * 100,
           "stats": delta, "device_busy_pct": busy,
           "kernel_ms_per_step": kernel_us / 1e3 / steps, "copy_ms_per_step": copy_us / 1e3 / steps,
           "profiled_h2d_gb_per_s": prof_gbs,
           "losses": losses, "launches": launches, "memmap_seconds": data_s}
    print(f"  TVResNet-50 bf16 224^2 bs{BATCH} SGHMC from a {ST_IMAGENET_N}-image uint8 memmap: "
          f"streamed {1e3 / ms:.2f} steps/s beside the resident slice's {resident_sps:.2f} "
          f"({out['pct_of_resident']:.1f}%); {_stream_line(delta, steps)}; device busy "
          f"{busy:.1f}% ({kernel_us / 1e3 / steps:.2f} ms of kernels a step, "
          f"{copy_us / 1e3 / steps:.2f} ms of copies beside them: "
          f"{prof_gbs:.1f} GB/s by the profiler); {checked} transfers "
          f"byte-equal; losses {[round(v, 4) for v in losses]}; K1 {launches} launches; "
          f"memmap written in {data_s:.1f} s", flush=True)
    return out


def stream_cli(device) -> dict:
    """(c) ``cli run --stream --stream_chunk 4``: SGLD on MLP200MNIST / MNIST, 2
    trials; the result keys of a resident run, finite, K1 once a step."""
    from ursabench_tpu_torch import tasks

    runs = []
    save = f"{ST_OUT}/mnist_stream"
    argv = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--inference_method", "SGLD",
            "--batch_size", str(BATCH), "--synthetic_n_train", str(MNIST_TRAIN),
            "--synthetic_n_test", str(MNIST_TEST), "--hyperparams", json.dumps(MNIST_HYP),
            "--num_trials", "2", "--stream", "--stream_chunk", "4", "--save_path", save]
    seconds, launches = _run_cli(argv, runs)
    check(len(runs) == 2, f"stream (c): {len(runs)} samplers")
    steps = _check_launches("stream (c)", launches, runs)
    check(runs[0]["batches"] == (MNIST_TRAIN // (4 * BATCH)) * 4,
          f"stream (c): {runs[0]['batches']} batches an epoch")
    res = dict(np.load(save + "_tests.npz"))
    metrics = (list(tasks.Prediction.supported_metric_list)
               + [f"{kind}_uncertainty_auroc_{d}" for d in ("FashionMNIST", "KMNIST")
                  for kind in ("total", "model")] + ["cost"])
    want = {f"{m}_{stat}" for m in metrics for stat in ("mean", "std")}
    check(set(res) == want, f"stream (c) keys: {sorted(set(res) ^ want)}")
    for k, v in res.items():
        check(math.isfinite(float(v)) or k.startswith("misclass"), f"stream (c): {k} = {v}")
    print(f"  cli run --stream --stream_chunk 4 (MLP200MNIST / MNIST, SGLD, 2 trials): "
          f"{seconds:.1f} s, K1 {launches} launches = {steps} steps, error "
          f"{float(res['error_rate_mean']):.4f}, {len(res)} result keys", flush=True)
    return {"seconds": seconds, "launches": launches,
            "error_rate": float(res["error_rate_mean"])}


def stream_export(device) -> dict:
    """(d) PreResNet-20, S=6, batch 128: the BMA engine exported, saved,
    loaded and held against the eager engine, fp32 and bf16."""
    from ursabench_tpu_torch.profiling import export as E
    from ursabench_tpu_torch.profiling import latency as L
    from ursabench_tpu_torch.profiling.hw import event_ms

    ens = L.random_ensemble("PreResNet20", 10, LATENCY_S, device)
    out = {}
    for prec, tol in (("fp32", 1e-5), ("bf16", 1e-2)):
        t0 = time.perf_counter()
        ep = E.export_bma_engine(ens.module, ens.state, BATCH, (3, 32, 32), prec)
        path = f"{ST_OUT}/preresnet20_s{LATENCY_S}_{prec}.pt2"
        E.save_engine(path, ep)
        engine = E.load_engine(path)
        export_s = time.perf_counter() - t0
        # the eager engine that runs the members as the exported one does
        eager, x = L.build_engine(ens.module, ens.state, BATCH, (3, 32, 32), prec, "scan")
        got, want = engine(x), eager(x)
        err = float((got - want).abs().max())
        check(got.shape == (BATCH, 10) and bool(torch.isfinite(got).all()) and err <= tol,
              f"exported {prec} engine differs from the eager one by {err}")
        ms = event_ms(lambda: engine(x), 20, warm_up=3)
        eager_ms = event_ms(lambda: eager(x), 20, warm_up=3)
        out[prec] = {"max_abs_err": err, "ms": ms, "eager_ms": eager_ms, "export_s": export_s}
        print(f"  export PreResNet-20 S={LATENCY_S} bs{BATCH} {prec}: loaded engine within "
              f"{err:.2g} of the eager one (<= {tol}); {ms:.3f} ms a call, eager {eager_ms:.3f} "
              f"ms; export + save + load {export_s:.1f} s", flush=True)
    return out


def stream_trace(device) -> dict:
    """(e) ``profile_config(trace_dir=)``: the trace file names CUDA kernels
    (MLP200MNIST, S=1, batch 1: the per-call protocol's 230 calls with the
    fewest ops a call, so the smallest trace)."""
    from ursabench_tpu_torch.profiling import latency as L

    cfg = L.ProfileConfig("MLP200MNIST", "MNIST", "fp32", 1, 1)
    res = L.profile_config(cfg, device=device, trace_dir=f"{ST_OUT}/traces")
    with open(res["trace_path"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    check(len(kernels) > 0, f"no CUDA kernel in {res['trace_path']}")
    print(f"  trace_dir: {res['trace_path']}, {len(events)} events, {len(kernels)} distinct "
          f"CUDA kernels (e.g. {sorted(kernels)[0][:60]}); {res['latency_mean_s'] * 1e3:.3f} ms "
          f"a call under the profiler", flush=True)
    return {"trace_events": len(events), "kernels": len(kernels)}


def stream_phase(device, splits, imagenet) -> dict:
    """Host streaming and the rest of the profiling layer: (a)-(e)."""
    import os

    os.makedirs(ST_OUT, exist_ok=True)
    out = {"cifar": stream_cifar(device, splits),
           "imagenet": stream_imagenet(device, imagenet["train"]["steps_per_sec"]),
           "cli": stream_cli(device), "export": stream_export(device),
           "trace": stream_trace(device)}
    out["launches"] = sum(out[k]["launches"] for k in ("cifar", "imagenet", "cli"))
    with open(f"{ST_OUT}/stream_phase.json", "w") as f:
        json.dump(out, f, indent=1)
    return out


def _ch_split(name, dataset, n):
    from ursabench_tpu_torch import data, models

    cfg = models.get_model(name)
    splits, c = data.loaders(dataset, None, batch_size=BATCH, use_validation=False,
                             transform_train=cfg.transform_train,
                             transform_test=cfg.transform_test,
                             synthetic_n_train=n, synthetic_n_test=BATCH)
    return splits["train"], c


def _ch_sampler(device, name, split, classes, dtype, chains, strategy):
    """An SGHMC sampler of ``chains`` chains (seed 0) under ``strategy``; at
    one chain "vmap" runs the batched step over its one row."""
    from ursabench_tpu_torch import inference, models

    kw = {"dtype": torch.bfloat16} if dtype == "bf16" else {}
    s = inference.SGHMC(HYP, model=models.get_model(name).build(classes, **kw), train=split,
                        seed=0, device=device, chains=chains,
                        chain_strategy="scan" if chains == 1 else strategy)
    if chains == 1:
        s._resolved_chain_strategy = strategy
    return s


def _ch_epoch(sampler, launches: list) -> float:
    """ms of one epoch of ``sampler`` (CUDA events), K1's launches in it
    appended to ``launches`` and checked against its steps."""
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat
    from ursabench_tpu_torch.profiling.hw import event_ms

    sghmc_update_flat.launches = 0
    ms = event_ms(sampler._run_epoch, 1)
    steps = sampler.train.num_batches
    check(sghmc_update_flat.launches == steps,
          f"chains: K1 launched {sghmc_update_flat.launches} times in an epoch of {steps} "
          f"steps ({sampler._resolved_chain_strategy}, {sampler.chains} chains)")
    launches.append(sghmc_update_flat.launches)
    return ms


def _ch_peak(sampler, launches: list):
    """A warm-up epoch of ``sampler``: (peak GB allocated during it, GB it
    added over what was allocated before it)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _ch_epoch(sampler, launches)
    peak = torch.cuda.max_memory_allocated()
    return peak / 1e9, (peak - base) / 1e9


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


def _ch_state(sampler, grads_step1) -> dict:
    """What the agreement check compares: the first step's gradients, then
    the parameters, momenta, losses and BatchNorm running statistics."""
    return {"grads_step1": grads_step1, "params": sampler._state.params.clone(),
            "momentum": sampler._state.momentum.clone(),
            "losses": torch.stack(sampler.epoch_losses),
            "bn_stats": torch.cat([b.reshape(-1) for m in sampler.modules
                                   for b in m.buffers()] or [torch.zeros(1)])}


def _ch_agree(device, name, dataset, dtype, launches: list) -> dict:
    """vmap against scan from the same seed over one batch of 128 images (an
    epoch is one step, noise on), CH_CHECK_CHAINS chains: the first step's
    gradients, then, after CH_CHECK_STEPS steps, the parameters, momenta,
    losses and BatchNorm running statistics, each as ||vmap - scan|| /
    ||scan||. In bf16 the scan run also runs in float32 from the same seed,
    and vmap's distance from that float32 run may be at most CH_BF16 times
    the bf16 scan run's own."""
    split, c = _ch_split(name, dataset, BATCH)
    runs = {}
    cases = [("scan", dtype), ("vmap", dtype)] + ([("scan", "fp32")] if dtype == "bf16" else [])
    for strategy, run_dtype in cases:
        s = _ch_sampler(device, name, split, c, run_dtype, CH_CHECK_CHAINS, strategy)
        check(s._resolved_chain_strategy == strategy, f"chains: {s._resolved_chain_strategy}")
        _ch_epoch(s, launches)
        grads = s._state.grads.clone()
        for _ in range(CH_CHECK_STEPS - 1):
            _ch_epoch(s, launches)
        runs[strategy, run_dtype] = _ch_state(s, grads)
        del s
    vmap, scan = runs["vmap", dtype], runs["scan", dtype]
    out = {"vmap_vs_scan": {q: _rel(vmap[q], scan[q]) for q in scan}}
    if dtype == "bf16":
        f32 = runs["scan", "fp32"]
        out["scan_vs_fp32"] = {q: _rel(scan[q], f32[q]) for q in scan}
        out["vmap_vs_fp32"] = {q: _rel(vmap[q], f32[q]) for q in scan}
        out["ok"] = all(out["vmap_vs_fp32"][q] <= CH_BF16 * out["scan_vs_fp32"][q]
                        for q in scan)
    else:
        out["ok"] = max(out["vmap_vs_scan"].values()) <= CH_FP32
    return out


def _ch_model(device, name, dataset, n, dtype, counts, launches: list) -> list:
    """The timed rows of one model: at each C, a warm-up epoch of each
    strategy (its peak memory), then timed epochs in the order scan, vmap,
    vmap, scan; a C whose vmap run would not fit beside what is allocated
    (C times the one-chain vmap epoch's working memory) is skipped."""
    import gc

    split, c = _ch_split(name, dataset, n)
    rows, work1 = [], None
    for chains in counts:
        free = torch.cuda.mem_get_info()[0] / 1e9
        if work1 is not None and chains * work1 > 0.9 * free:
            print(f"  {name} C={chains}: skipped, vmap would need ~{chains * work1:.1f} GB, "
                  f"{free:.1f} GB free", flush=True)
            rows.append({"model": name, "chains": chains, "skipped": True})
            continue
        samplers, peak, ms = {}, {}, {"scan": [], "vmap": []}
        try:
            for strategy in ("scan", "vmap"):
                samplers[strategy] = _ch_sampler(device, name, split, c, dtype, chains, strategy)
                peak[strategy] = _ch_peak(samplers[strategy], launches)
            for strategy in ("scan", "vmap", "vmap", "scan"):
                ms[strategy].append(_ch_epoch(samplers[strategy], launches))
        except torch.cuda.OutOfMemoryError:
            print(f"  {name} C={chains}: skipped, out of memory", flush=True)
            rows.append({"model": name, "chains": chains, "skipped": True})
            samplers = {}
            gc.collect()
            torch.cuda.empty_cache()
            continue
        if chains == 1:
            work1 = peak["vmap"][1]
        for strategy, sampler in samplers.items():
            for loss in sampler.epoch_losses:
                check(bool(torch.isfinite(loss).all()), f"chains: {name} {strategy} loss {loss}")
        steps = split.num_batches
        sf = {k: [chains * steps * 1e3 / v for v in ms[k]] for k in ms}
        mean = {k: sum(v) / len(v) for k, v in sf.items()}
        rows.append({"model": name, "dtype": dtype, "chains": chains, "steps": steps,
                     "images": n, "ms": ms, "step_forwards_per_s": sf,
                     "per_chain": {k: v / chains for k, v in mean.items()},
                     "vmap_over_scan": mean["vmap"] / mean["scan"],
                     "peak_gb": {k: v[0] for k, v in peak.items()},
                     "epoch_gb": {k: v[1] for k, v in peak.items()}})
        del samplers
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _ch_hmc(device) -> dict:
    """HMC x CH_ROWS chains on MLP200MNIST over 10,240 images, in turns scan,
    vmap, vmap, scan from the same seed: gradients/s, s a draw, the accept
    rate; vmap's draws against scan's (the same accepts)."""
    from ursabench_tpu_torch import inference, models

    split, c = _ch_split("MLP200MNIST", "MNIST", 10240)
    hmcs = {k: inference.HMC(CH_HMC, model=models.get_model("MLP200MNIST").build(c),
                             train=split, seed=1, device=device, chains=CH_ROWS,
                             chain_strategy=k) for k in ("scan", "vmap")}
    secs, runs = {"scan": [], "vmap": []}, {}
    for k in ("scan", "vmap", "vmap", "scan"):
        hmcs[k]._gen.manual_seed(7)  # every run draws the same momenta and uniforms
        ens, sec = _timed_sample(hmcs[k])
        secs[k].append(sec)
        runs[k] = (ens, hmcs[k].accept_rate)
    grads = CH_ROWS * CH_HMC["num_samples"] * (CH_HMC["L"] + 1)
    worst = max(_rel(runs["vmap"][0].state[n], runs["scan"][0].state[n])
                for n in runs["scan"][0].state)
    check(runs["vmap"][1] == runs["scan"][1] and worst <= CH_FP32,
          f"chains: HMC vmap accept {runs['vmap'][1]} against {runs['scan'][1]}, draws "
          f"{worst:.3g} apart")
    return {"grads_per_s": {k: [grads / v for v in secs[k]] for k in secs},
            "s_per_draw": {k: [v / CH_HMC["num_samples"] for v in secs[k]] for k in secs},
            "accept_rate": runs["scan"][1], "rel_diff": worst}


def _ch_pca(device) -> dict:
    """PCA-ESS x CH_ROWS chains on PreResNet-20 over 2,048 images: the SWA
    phase and a first draw, then one check draw in turn and in lock step from
    the same state and streams (the same points and bracket counts), then
    draws timed in the order in-turn, lock-step, lock-step, in-turn."""
    from ursabench_tpu_torch import inference, models

    split, c = _ch_split("PreResNet20", "CIFAR10", 2048)
    pca = inference.PCASubspaceSampler(CH_PCA, model=models.get_model("PreResNet20").build(c),
                                       train=split, seed=3, device=device, chains=CH_ROWS,
                                       chain_strategy="scan")
    pca.sample_iterative(update_bn=False)
    state = ([g.get_state() for g in pca._gens], pca.current_theta.clone(),
             pca.current_lnpdf.clone())
    check_draw = {}
    for k in ("scan", "vmap"):
        for g, st in zip(pca._gens, state[0]):
            g.set_state(st)
        pca.current_theta, pca.current_lnpdf = state[1].clone(), state[2].clone()
        pca._resolved_chain_strategy = k
        pca.sample_iterative(update_bn=False)
        check_draw[k] = (pca.current_theta.clone(), pca.bracket_iters[-1])
    worst = _rel(check_draw["vmap"][0], check_draw["scan"][0])
    check(check_draw["vmap"][1] == check_draw["scan"][1] and worst <= CH_FP32,
          f"chains: lock-step ESS brackets {check_draw['vmap'][1]} against in-turn "
          f"{check_draw['scan'][1]}, points {worst:.3g} apart")
    secs, props = {"scan": [], "vmap": []}, {"scan": [], "vmap": []}
    for k in ("scan", "vmap", "vmap", "scan"):
        pca._resolved_chain_strategy = k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca.sample_iterative(update_bn=False)
        torch.cuda.synchronize()
        secs[k].append(time.perf_counter() - t0)
        props[k].append(pca.bracket_iters[-1])
    return {"s_per_draw": secs, "proposals": props, "check_brackets": check_draw["scan"][1],
            "rel_diff": worst}


def _ch_sweep(device, launches: list) -> dict:
    """MethodSweep of CH_ROWS SGHMC configs (lr CH_SWEEP_LR) on PreResNet-20
    over 2,048 images: a warm-up epoch of each strategy, then epochs timed
    in the order scan, vmap, vmap, scan; sweep step-forwards/s."""
    from ursabench_tpu_torch import inference, models

    split, c = _ch_split("PreResNet20", "CIFAR10", 2048)
    hyps = [{**HYP, "lr": lr} for lr in CH_SWEEP_LR]
    sweeps = {k: inference.MethodSweep(hyps, model=models.get_model("PreResNet20").build(c),
                                       train=split, seed=5, method="SGHMC", device=device,
                                       chain_strategy=k) for k in ("scan", "vmap")}
    for k, sw in sweeps.items():
        check(sw.sampler._resolved_chain_strategy == k, f"sweep strategy {k}")
        _ch_epoch(sw.sampler, launches)
    ms = {"scan": [], "vmap": []}
    for k in ("scan", "vmap", "vmap", "scan"):
        ms[k].append(_ch_epoch(sweeps[k].sampler, launches))
    steps = split.num_batches
    return {"step_forwards_per_s": {k: [CH_ROWS * steps * 1e3 / v for v in ms[k]] for k in ms}}


def chains_phase(device) -> dict:
    """How C chains advance on the card: scan (in turn) against vmap (one
    batched forward and backward) for SGHMC on MLP200MNIST, LeNet5MNIST,
    PreResNet-20 (fp32, TF32 off) and WideResNet-28x10 (bf16), then HMC,
    PCA-ESS and a sweep; K1 once a step in every epoch; the table printed."""
    import os

    os.makedirs(CH_OUT, exist_ok=True)
    launches: list = []
    out = {"agree": {}, "rows": []}
    for name, dataset, n, dtype, counts in CH_MODELS:
        out["agree"][name] = (dtype, _ch_agree(device, name, dataset, dtype, launches))
        out["rows"] += _ch_model(device, name, dataset, n, dtype, counts, launches)
    out["hmc"] = _ch_hmc(device)
    out["pca"] = _ch_pca(device)
    out["sweep"] = _ch_sweep(device, launches)
    out["launches"] = sum(launches)
    fmt = lambda v, d=1: " / ".join(f"{x:.{d}f}" for x in v)  # noqa: E731
    print(f"  vmap against scan, {CH_CHECK_CHAINS} chains from one seed, ||a - b|| / ||b|| "
          f"of the first step's gradients, then after {CH_CHECK_STEPS} noisy steps (limit "
          f"{CH_FP32} in fp32; in bf16, {CH_BF16}x bf16 scan's distance from float32):",
          flush=True)
    for name, (dtype, agree) in out["agree"].items():
        for key in ("vmap_vs_scan", "scan_vs_fp32", "vmap_vs_fp32"):
            if key in agree:
                print(f"    {name} {dtype} {key}: " + ", ".join(
                    f"{k} {v:.2e}" for k, v in agree[key].items()), flush=True)
    print("  chains table (SGHMC, batch 128, one epoch a run, turns scan vmap vmap scan; "
          "step-forwards/s aggregate, per chain, vmap/scan, peak GB allocated):", flush=True)
    for r in out["rows"]:
        if r.get("skipped"):
            continue
        sf = r["step_forwards_per_s"]
        print(f"    {r['model']} {r['dtype']} C={r['chains']} ({r['steps']} steps of "
              f"{r['images']} images): scan {fmt(sf['scan'])}, vmap {fmt(sf['vmap'])}; per "
              f"chain {r['per_chain']['scan']:.1f} / {r['per_chain']['vmap']:.1f}; vmap/scan "
              f"{r['vmap_over_scan']:.3f}; peak {r['peak_gb']['scan']:.2f} / "
              f"{r['peak_gb']['vmap']:.2f} GB (the epoch's own {r['epoch_gb']['scan']:.2f} / "
              f"{r['epoch_gb']['vmap']:.2f})", flush=True)
    h, p, w = out["hmc"], out["pca"], out["sweep"]
    print(f"    HMC MLP200MNIST x{CH_ROWS} chains, 10,240 images, L {CH_HMC['L']}: gradients/s "
          f"scan {fmt(h['grads_per_s']['scan'])}, vmap {fmt(h['grads_per_s']['vmap'])}; s a "
          f"draw scan {fmt(h['s_per_draw']['scan'], 4)}, vmap {fmt(h['s_per_draw']['vmap'], 4)}; "
          f"accept rate {h['accept_rate']:.3f} (both); draws {h['rel_diff']:.2e} apart",
          flush=True)
    print(f"    PCA-ESS PreResNet-20 x{CH_ROWS} chains, 2,048 images: s a draw in turn "
          f"{fmt(p['s_per_draw']['scan'], 3)}, lock step {fmt(p['s_per_draw']['vmap'], 3)}; "
          f"proposals a draw by chain {p['proposals']['scan']} / {p['proposals']['vmap']}; "
          f"check draw: brackets {p['check_brackets']} in both, points {p['rel_diff']:.2e} "
          "apart", flush=True)
    print(f"    MethodSweep SGHMC K={CH_ROWS} PreResNet-20, 2,048 images: step-forwards/s scan "
          f"{fmt(w['step_forwards_per_s']['scan'])}, vmap {fmt(w['step_forwards_per_s']['vmap'])}"
          f"; K1 {out['launches']} launches, one a step in every epoch", flush=True)
    with open(f"{CH_OUT}/chains_phase.json", "w") as f:
        json.dump(out, f, indent=1, default=str)
    for name, (dtype, agree) in out["agree"].items():
        check(agree["ok"], f"chains: {name} {dtype} vmap disagrees with scan: {agree}")
    return out


def k1_offset_check(device, row_len: int) -> dict:
    """K1 on 4 rows of ``row_len`` (PreResNet-20's P, 2 mod 4), the noise on:
    the whole buffer, then blocks of 2 + 2 and 1 + 3 rows, each launched on
    its own rows with its global element offset, in place in the buffer (a
    block at row 1 starts 8 bytes off a 16-byte boundary: the scalar path)
    and as fresh copies (the float4 path); every block bit-equal to the
    whole launch's rows in p and v. Then one row's device time at offset 0
    and at offset ``row_len`` (two Philox calls a group of four), from CUDA
    graphs."""
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat
    from ursabench_tpu_torch.ops.sgmcmc import sghmc_scalars
    from ursabench_tpu_torch.profiling.int8_microbench import graph_ms

    gen = torch.Generator(device=device).manual_seed(3)
    p0, v0, g = (torch.randn(4, row_len, generator=gen, device=device) for _ in range(3))
    s = sghmc_scalars(lr=0.05, momentum=0.9, wd_over_n=1.0 / 50000, n_train=50000.0,
                      noise_on=1.0, is_first_step=False, device=device)
    whole = [p0.clone(), v0.clone()]
    sghmc_update_flat(whole[0].view(-1), whole[1].view(-1), g.view(-1), s, seed=11)
    cases = []
    for blocks in ((2, 2), (1, 3)):
        for fresh in (False, True):
            pb, vb, start = p0.clone(), v0.clone(), 0
            for rows in blocks:
                sl = slice(start, start + rows)
                p, v, gb = ((t[sl].clone() for t in (pb, vb, g)) if fresh
                            else (pb[sl], vb[sl], g[sl]))
                sghmc_update_flat(p.view(-1), v.view(-1), gb.view(-1), s, seed=11,
                                  offset=start * row_len)
                torch.cuda.synchronize()
                equal = torch.equal(p, whole[0][sl]) and torch.equal(v, whole[1][sl])
                cases.append({"blocks": blocks, "rows": (start, start + rows), "fresh": fresh,
                              "offset_mod4": start * row_len % 4, "equal": equal})
                check(equal, f"K1 block {blocks} rows {start}..{start + rows} "
                             f"({'copy' if fresh else 'in place'}) != the whole launch's")
                start += rows
    p, v, g1 = (t[0].clone() for t in (p0, v0, g))
    ms = {off: graph_ms([lambda off=off: sghmc_update_flat(p, v, g1, s, seed=1, offset=off)],
                        TIMED_LAUNCHES) for off in (0, row_len)}
    print(f"  (a) K1 with a global offset, 4 rows of {row_len}: blocks 2+2 and 1+3, in place "
          f"and as copies, {len(cases)} of {len(cases)} bit-equal to the whole launch in p and "
          f"v; one row from CUDA graphs: offset 0 {ms[0] * 1e3:.2f} us, offset {row_len} "
          f"({row_len % 4} mod 4) {ms[row_len] * 1e3:.2f} us", flush=True)
    return {"cases": cases, "ms_offset0": ms[0], "ms_offset": ms[row_len]}


def _mesh_metrics(ens, split, num_classes) -> dict:
    from ursabench_tpu_torch import tasks

    task = tasks.Prediction({"in_distribution_test": split}, num_classes,
                            metric_list=["error_rate", "nll", "ece"])
    task.update_statistics(ens, output_performance=False)
    return task.get_performance_metrics()


def _mesh_work(device, chain_mesh, data_mesh) -> dict:
    """What the mesh phase runs on a rank, or in one process with both
    meshes None: PreResNet-20 SGHMC x2 chains (one draw after one epoch)
    and its Prediction, sharded and gathered; MLP200MNIST SGHMC x1 chain.
    K1's launches are counted."""
    from ursabench_tpu_torch import data, inference, models
    from ursabench_tpu_torch.data.transforms import CIFAR_TEST, CIFAR_TRAIN
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    sghmc_update_flat.launches = 0
    t0 = time.perf_counter()
    splits, c = data.loaders("CIFAR10", None, batch_size=BATCH, use_validation=False,
                             transform_train=CIFAR_TRAIN, transform_test=CIFAR_TEST,
                             synthetic_n_train=MESH_TRAIN, synthetic_n_test=2 * BATCH)
    s = inference.SGHMC(MESH_HYP, model=models.get_model("PreResNet20").build(c),
                        train=splits["train"], seed=0, chains=2, device=device,
                        chain_strategy="scan", mesh=chain_mesh)
    ens = s.sample()
    full = ens.gather()
    out = {"preresnet": {k: v.cpu() for k, v in full.state.items()},
           "members": (ens.num_members, ens.local_members),
           "metrics": (_mesh_metrics(ens, splits["test"], c),
                       _mesh_metrics(full, splits["test"], c))}
    splits, c = data.loaders("MNIST", None, batch_size=BATCH, use_validation=False,
                             synthetic_n_train=MESH_MLP_TRAIN, synthetic_n_test=BATCH)
    m = inference.SGHMC(MESH_HYP, model=models.get_model("MLP200MNIST").build(c),
                        train=splits["train"], seed=1, device=device, mesh=data_mesh)
    m.sample()
    if device.type == "cuda":
        torch.cuda.synchronize()
    out.update(mlp=m._state.params.cpu(), k1=sghmc_update_flat.launches,
               seconds=time.perf_counter() - t0)
    return out


def _mesh_rank(rank: int, store: str, out: str) -> None:
    """One of two ranks sharing the card (a spawned child): gloo on CUDA
    tensors, the meshes (2, 1) and (1, 2), ``_mesh_work``'s result pickled
    to ``out/rank<r>.pt``."""
    import torch.distributed as dist

    from ursabench_tpu_torch import parallel
    from ursabench_tpu_torch.kernels import sghmc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    sghmc.load_library()
    parallel.initialize(f"file://{store}", 2, rank, backend="gloo", timeout_s=120)
    try:
        chain_mesh, data_mesh = parallel.Mesh(2, 1), parallel.Mesh(1, 2)
        res = _mesh_work(torch.device("cuda"), chain_mesh, data_mesh)
        res["backend"] = dist.get_backend()
        torch.save(res, f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _two_ranks() -> list:
    """``_mesh_rank`` in two spawned processes; their results."""
    import multiprocessing as mp
    import os
    import shutil

    shutil.rmtree(f"{MESH_OUT}/ranks", ignore_errors=True)
    os.makedirs(f"{MESH_OUT}/ranks")
    store = os.path.abspath(f"{MESH_OUT}/ranks/store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, store, f"{MESH_OUT}/ranks"))
             for r in range(2)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + MESH_TIMEOUT
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    check([proc.exitcode for proc in procs] == [0, 0],
          f"mesh: the two ranks exited with {[proc.exitcode for proc in procs]}")
    return [torch.load(f"{MESH_OUT}/ranks/rank{r}.pt", weights_only=False) for r in range(2)]


def _nccl_world1() -> int:
    """Under torchrun (one process): ``parallel.initialize()``, one NCCL
    all-reduce on the card (prints the backend, world and sum), then ``cli
    run --mesh auto`` in the same process group (its ``initialize()`` finds
    the group made)."""
    import torch.distributed as dist

    from ursabench_tpu_torch import cli, parallel

    torch.backends.cudnn.allow_tf32 = False  # as in main(): the run it is compared with
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize()
    t = torch.full((4,), 2.5, device="cuda")
    dist.all_reduce(t)
    print(json.dumps({"nccl_world1": {"backend": dist.get_backend(),
                                      "world": dist.get_world_size(), "sum": t.tolist()}}),
          flush=True)
    try:
        return cli.main(["run", *MESH_RUN, "--mesh", "auto", "--save_path",
                         f"{MESH_OUT}/torchrun"])
    finally:
        dist.destroy_process_group()


def _torchrun(args: list) -> str:
    """``torchrun --standalone --nproc_per_node 1 args``: its stdout, or a
    failed check."""
    import subprocess

    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "1", *args], capture_output=True, text=True,
                         timeout=MESH_TIMEOUT)
    check(out.returncode == 0, f"torchrun {args} failed: {out.stderr[-3000:]}")
    return out.stdout


def mesh_phase(device, row_len: int) -> dict:
    """The device mesh on the one card: (a) K1 with a global offset; (b) two
    ranks sharing the card as child processes against one process; (c)
    NCCL at a world size of 1 and the runner under torchrun."""
    import os

    os.makedirs(MESH_OUT, exist_ok=True)
    out = {"k1": k1_offset_check(device, row_len)}

    torch.cuda.empty_cache()  # room for the two ranks' contexts beside this process
    t0 = time.perf_counter()
    ranks = _two_ranks()
    two_s = time.perf_counter() - t0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = _mesh_work(device, None, None)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = ranks[0]["preresnet"], one["preresnet"]
    gap = _rel(torch.cat([a[k].double().reshape(-1) for k in b]),
               torch.cat([b[k].double().reshape(-1) for k in b]))
    check(gap <= MESH_PRR_GAP, f"mesh: PreResNet-20 on (2, 1) {gap:.3g} from one process")
    check(all(r["members"] == (2, 1) for r in ranks), f"mesh: members {ranks[0]['members']}")
    worst = 0.0
    for r in ranks:
        sharded, gathered = r["metrics"]
        for k in gathered:
            d = abs(sharded[k] - gathered[k])
            worst = max(worst, d)
            check(d <= 1e-7 + 1e-5 * abs(gathered[k]),
                  f"mesh: Prediction {k} sharded {sharded[k]} vs gathered {gathered[k]}")
    check(torch.equal(ranks[0]["mlp"], ranks[1]["mlp"]), "mesh: MLP200 data replicas differ")
    mlp_gap = float(((ranks[0]["mlp"] - one["mlp"]).abs()
                     - (1e-5 + 2e-4 * one["mlp"].abs())).max())
    check(mlp_gap <= 0, f"mesh: MLP200MNIST on (1, 2) outside rtol 2e-4, atol 1e-5 of one "
                        f"process (by {mlp_gap:.3g})")
    steps = MESH_TRAIN // BATCH + MESH_MLP_TRAIN // BATCH
    check(all(r["k1"] == steps for r in ranks) and one["k1"] == steps,
          f"mesh: K1 launches {[r['k1'] for r in ranks]} / {one['k1']}, expected {steps} each")
    print(f"  (b) two processes sharing one card ({ranks[0]['backend']} on CUDA tensors: NCCL "
          f"refuses two ranks on one device), {two_s:.1f} s for both ranks (start-up "
          f"included; not a scaling figure), {ranks[0]['seconds']:.1f} / "
          f"{ranks[1]['seconds']:.1f} s of work, one process {one['seconds']:.1f} s: "
          f"PreResNet-20 x2 chains on (2, 1) {gap:.3g} from one process (limit "
          f"{MESH_PRR_GAP}, TF32 off, cudnn deterministic); Prediction sharded vs gathered "
          f"max |d| {worst:.3g}; MLP200MNIST on (1, 2) within rtol 2e-4 / atol 1e-5, replicas "
          f"bit-equal; K1 {steps} launches a rank", flush=True)
    out["two_ranks"] = {"seconds": two_s, "gap": gap, "metrics_max_abs": worst,
                        "k1": [r["k1"] for r in ranks] + [one["k1"]]}

    t0 = time.perf_counter()
    lines = [json.loads(line) for line in _torchrun([__file__, "--nccl_world1"]).splitlines()
             if line.startswith('{"nccl_world1"')]
    check(len(lines) == 1 and lines[0]["nccl_world1"]["backend"] == "nccl"
          and lines[0]["nccl_world1"]["sum"] == [2.5] * 4, f"mesh: NCCL at world 1: {lines}")
    runs: list = []
    _, launches = _run_cli(MESH_RUN + ["--save_path", f"{MESH_OUT}/plain"], runs)
    with np.load(f"{MESH_OUT}/torchrun_tests.npz") as f1, \
            np.load(f"{MESH_OUT}/plain_tests.npz") as f2:
        keys = sorted(f1.files)
        check(keys == sorted(f2.files), f"mesh: torchrun keys {keys} != {sorted(f2.files)}")
        check(all(np.isfinite(f1[k]).all() for k in keys), "mesh: torchrun results not finite")
        diff = max(float(abs(f1[k] - f2[k])) for k in keys)
    check(diff == 0, f"mesh: cli run under torchrun differs from a run without it by {diff:.3g} "
                     "(one process, one card, the same seed)")
    nccl_s = time.perf_counter() - t0
    print(f"  (c) NCCL at world 1 under torchrun --standalone --nproc_per_node 1: all-reduce "
          f"{lines[0]['nccl_world1']}, then cli run --mesh auto in that process group: the "
          f"{len(keys)} result keys and values of a run without it (largest difference "
          f"{diff:.3g}; a world of 1 builds no mesh); "
          f"{nccl_s:.1f} s", flush=True)
    out["nccl"] = {"seconds": nccl_s, "keys": len(keys), "max_diff": diff}
    out["launches"] = sum(r["k1"] for r in ranks) + one["k1"] + launches
    with open(f"{MESH_OUT}/mesh_phase.json", "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


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
    imagenet = phase("imagenet slice", imagenet_phase, device)
    samplers = phase("samplers", samplers_phase, device)
    experiment = phase("experiment", experiment_phase, device)
    hypopt = phase("hypopt", hypopt_phase, device, n_slice)
    hmc_ess = phase("hmc_ess", hmc_ess_phase, device)
    stream = phase("stream", stream_phase, device, splits, imagenet)
    chains = phase("chains", chains_phase, device)
    mesh = phase("mesh", mesh_phase, device, n_slice)

    kernels = [{
        "name": "sghmc_update", "route": "cuda",
        "source": "ursabench_tpu_torch/csrc/sghmc_update.cu",
        "replaces": "benchmarks/pallas_sgmcmc.py:75",
        "launches": (launches + imagenet["k1_launches"] + samplers["launches"]
                     + experiment["launches"] + hypopt["launches"] + hmc_ess["launches"]
                     + stream["launches"] + chains["launches"] + mesh["launches"]),
        "max_abs_err": max(kernel["max_abs_err"], samplers["k1"]["max_abs_err"]),
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
    if sys.argv[1:] == ["--nccl_world1"]:  # the mesh phase's child under torchrun
        if not torch.cuda.is_available():
            print("FAILED: torch.cuda.is_available() is False", flush=True)
            sys.exit(1)
        sys.exit(_nccl_world1())
    sys.exit(main())
