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
   size beside the bound its bytes allow; its entry that reads the seed
   from device memory (the graphed epoch's) bit-equal to the by-value
   launch at offsets 0 and 2 mod 4, with one and two rows of scalars, and
   its time;
3. the slice: SGHMC on PreResNet-20 / synthetic CIFAR-10 (50,000 train and
   10,000 test images, batch 128, crop + flip), 2 draws after 1 burn-in
   epoch (3 epochs, 1,173 steps), then the BMA Prediction task with all 11
   metrics over the test split; K1 must have run once per step (the
   graph's replays count); step_program "graph", one capture;
   then "graph vs eager": from one state and one set of draws an epoch
   graphed and two eager (train_steps): steps/s, host us a step, the
   largest differences (graphed vs eager, eager vs eager) in the default
   cuDNN mode; under cudnn.deterministic a program captured in that mode,
   kept with its one capture across a second sample() and update_hyp to
   other values, its graphed epoch after them bit-equal to the eager one;
   the device's busy share of a graphed and an eager epoch of 16 steps
   under torch.profiler;
   then "eval graph vs eager" (the evaluation programs, inference/ensemble.py
   EVAL_PROGRAMS): (a) the slice's BMA program (one capture over every
   pass of the phase) graphed against its eager steps: img/s (medians of
   3 passes), host us a replay, the busy share under torch.profiler, within
   1e-6 in the default cuDNN mode and bit-equal under cudnn.deterministic
   (a program captured in that mode); (b) 5 PreResNet-20 members, both
   member layouts graphed beside the one the rule picks and its eager pass;
   (c) an MC-dropout ensemble (MLP200MNIST's twin, 4 members, masks drawn
   into static buffers) graphed bit-equal to eager; (d) SWAG on PreResNet-20
   over the 50,000 train images: its refresh program captured once across
   two draws, against the eager bn_refresh of the same weights within 1e-4
   of each layer's largest statistic, seconds each; (e) the validation-loss
   program against eval_loss within 1e-6, one capture over two calls.
   Every BMA pass of the process (the slice's, the samplers', the
   runner's, ...) must have run its program as a captured graph: the
   slice and samplers phases print the program (layout, capture), and the
   script checks at its end that no pass ran eagerly;
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
   and CUDA-graph device times, both member strategies for bf16 (the one
   the 'auto' rule does not pick: its device time only); a graph
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
   magnitude; then every bf16 conv's weight gradient of TVResNet-50 (batch
   128 at 224x224) and of WideResNet-28x10 (batch 128 at 32x32), each
   through its layer in the memory format the layer runs, against float32's
   from the same bf16 operands, within that bound;
11. the samplers: WideResNet-28x10 at full width and depth (36,546,980
   parameters at 100 classes, bf16 compute) over synthetic CIFAR-100
   (2,048 train and 512 test images, batch 128, crop + flip; cut from
   50,000 train images), through the samplers' own entry points: cSGHMC
   with 2 chains (4 epochs, 4 members), cSGLD (2 members), SGD (3 epochs, 1
   member), DeepEnsemble (3 members, 2 epochs), MCdropout on the twin (5
   epochs, 4 members), SWA and SWAG (full_cov, max_rank 3, pca_rank 2; 5
   epochs, 3 members each; their BatchNorm refresh one program, captured
   once across the draws), each followed by Prediction("ALL"), its BMA
   program graphed (DeepEnsemble's also timed against its eager steps): member and
   epoch counts, finite losses, ensembles and metrics, SGD's and
   DeepEnsemble's loss falling, DeepEnsemble's BMA equal to plain
   per-member modules within 1e-2, MCdropout's logits equal under one seed
   and different between members; K1 launched exactly once a step by
   cSGHMC (both chains in one launch) and cSGLD, 128 in all, and never by
   the others; step_program "graph" with one capture for every sampler but
   MCdropout ("eager": dropout), SGD's kept across update_hyp and a second
   sample(); bn_refresh equal to a plain recomputation from forward hooks
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
   host metrics, and the step-forwards/s; before (a), config 4's data
   stage (its CIFAR-100 splits, STL10 and SVHN, loaded as the runner loads
   them) twice into a fresh synthetic cache: a miss, then a hit.
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
   call, Prediction finite; bracket proposals and seconds a draw. In (a)-(c)
   every potential and log density runs through its program
   (engine.make_potential_fn): step_program "graph", each program captured
   once across every draw (one a variant and row count: its capture ms and
   pool printed); then each is graphed against its eager twin (the programs
   hidden: the plain potentials) from one state and one set of draws under
   deterministic cuDNN, bit-equal: one tuned MLP200MNIST draw from the warm
   start, one PreResNet-20 x2 draw, one PCA-ESS WRN draw of both chains (the
   check alone: the twins' rates, busy shares and host gaps were recorded in
   PERF.md by the runs that added the programs); (d) HMC
   (checkpoint every 2 draws, killed after 4 of 6), SGLD (every epoch) and
   PCA-ESS on MLP200MNIST killed and resumed: each equal to its
   uninterrupted run within 1e-6 of its largest weight (the largest
   difference printed); (e) `cli time` over the nine methods on
   MLP200MNIST / MNIST (10,000 train images, cut from 60,000), S=3, T cut
   from 10 to 1 after 1 warm-up trial: every method's mean beside the
   torch-CPU baseline, K1 once a step of the SGHMC, SGLD, cSGHMC and cSGLD
   trials; then the MCdropout and SGD rows split, one more trial each with
   the CUDA-synchronized seconds of the sampler's set-up, of each of its
   epochs (3 and 1 of 79 steps) and of the harvest after them.
15. host streaming and the rest of the profiling layer (stream): (a)
   PreResNet-20 / synthetic CIFAR-10 at full size (50,000 images, batch
   128, fp32, SGHMC on one chain), resident, streamed through
   HostStreamingSplit (M = 1) and chunked (M = 16): a warm-up epoch each,
   every streamed transfer of it compared on the card, after its step, with
   the host's gather of native.permutation(n, seed + epoch), then one timed
   epoch each in the order resident, streamed, chunked: steps/s,
   streamed_pct_of_in_hbm, the host's time in the stream and in
   ursa_stream_next a step, H2D GB/s; K1 once a step; three
   float32-mode batches equal to gather_normalize; (b) TVResNet-50 bf16 at
   224x224, batch 128, SGHMC streamed from a uint8 memmap of 4,096 synthetic
   images written under smoke_out/stream/ (cut from ImageNet's 1,281,167):
   a checked warm-up epoch, a timed epoch beside the ImageNet slice's
   resident rate, an epoch under torch.profiler for the device's busy share
   and the copies' rate, finite losses; (c) `cli run --stream
   --stream_chunk 4`, SGLD on MLP200MNIST / MNIST, 2 trials: the result
   keys, K1 once a step; (d) PreResNet-20, S=6, batch 128, exported in
   fp32, saved and loaded: within 1e-5 of the eager engine, one loaded
   call's ms (bf16's export is checked on the CPU, by
   tests/test_torch_export.py); (e) profile_config with a trace_dir
   (MLP200MNIST, S=1, batch 1): the trace names CUDA kernels.
16. how C chains advance (chains): SGHMC at batch 128, one epoch a run,
   under "scan" (in turn) and "vmap" (one batched forward and backward), on
   MLP200MNIST and LeNet5MNIST (10,240 MNIST images) and PreResNet-20 fp32
   (2,048 CIFAR-10 images) at C = 1, 2, 4 and 8, and WideResNet-28x10 bf16
   (2,048 CIFAR-100 images) at C = 1, 2 and 4 (a C whose vmap run would not
   fit is skipped and printed): for each strategy a graphed warm-up epoch
   (its first steps eager, the capture; its peak memory and the graph's
   pool), then one graphed and one eager epoch of each timed with CUDA
   events (the eager one's peak memory too), scan then vmap: aggregate and
   per-chain
   step-forwards/s, vmap/scan and graphed/eager; K1
   once a step in every epoch; each model's vmap against scan from one seed
   over one batch, the first step's gradients and, after 4 noisy steps,
   parameters, momenta, BatchNorm statistics and losses: ||vmap - scan|| /
   ||scan|| within 1e-4 in fp32 (TF32 off); in bf16, vmap's distance from a
   float32 run of the same seed within twice bf16 scan's own; then HMC x4
   chains on MLP200MNIST (gradients/s, s a draw, accept rate, the same
   accepts and draws within 1e-4), PCA-ESS x4 chains on PreResNet-20 (a
   check draw in turn and in
   lock step from one state: the same brackets and points; s a draw,
   proposals), both through their potential programs with one capture a
   program (PCA-ESS: one a lock-step row count), and MethodSweep K=4 on
   PreResNet-20 (step-forwards/s); the table printed, its JSON under
   smoke_out/chains/.
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
2e-4 / atol 1e-5 of one process with bit-equal replicas; HMC on
MLP200MNIST (4,096 images): on (1, 2) the CE sum and gradient within 1e-5
relative of one process, the same accepts, the draws within rtol 2e-4 /
atol 1e-5, and two chains on (2, 1) against one process as above; PCA-ESS
on PreResNet-20 (1,024 CIFAR-10 images) on (1, 2), its SWA phase on the
data mesh: the log density within 1e-5 of the local-BN oracle (each half
batch's own statistics), Prediction finite; PreResNet-20 streamed on (1, 2)
per batch and in chunks of 16 (2,048 images) bit-equal to the resident
sharded epoch on the stream's order, each rank's bytes a step half a
batch's; SGHMC x2 on PreResNet-20 on (2, 1) checkpointed every 2 epochs,
killed and resumed bit-equal, rank 0's file against one process's; one HMC
chain and one PCA-ESS chain on MLP200MNIST (4,096 images) on (2, 1),
replicated on both ranks (the chain axis does not divide one chain), each
bit-equal to one process on both; every one of these runs through the
sharded programs (step_program "graph" on every mesh), and on each rank
each program is held to its eager twin (the program hidden) bit for bit
under deterministic cuDNN and captured once: PreResNet-20 SGHMC over 2,048
images on (2, 1) x2 chains (one graph a step) and on (1, 2) x1 (two graphs
a step, the all-reduces between them: 2 a step against the eager step's
3), 2 epochs each, the last one's steps/s printed; the streamed programs
against stream_steps; HMC's (1, 2) potential program against _ce_sum;
PCA-ESS's (1, 2) density program against _plain_lnpdf, its SWA phase
through the cut epoch program; K1 once a step on each rank; the seconds
are two processes on one card, no scaling figure; (c) NCCL at a world size
of 1 under ``torchrun --standalone``: one all-reduce, then ``cli run --mesh
auto`` as it is and with ``--stream`` (the result keys and values of runs
without torchrun) and twice with ``--checkpoint_path`` (the second
resumes); (d) three ranks sharing the card under ``torchrun --standalone``
(gloo on CUDA tensors): ``cli run --mesh chain --chains 2`` lays (2, 1) over
ranks 0-1 and rank 2 idles and writes nothing; rank 0's results within the
runner's limits (rtol 2e-4, atol 1e-5; 2e-3 on the model-uncertainty
AUROCs) of one process's; its JSON under smoke_out/mesh/.
Every sampler these phases run reports step_program "graph", off a mesh
and on every mesh (inference/base.py: the epoch samplers' epochs, HMC's
potentials and PCA-ESS's log densities as programs).
Then a JSON line describing each kernel (its launches on the main path,
K1's summed over the slice, graph vs eager, the ImageNet slice, the samplers, the
experiment, the hypopt, the hmc_ess, the stream, the chains and the mesh
phases, the mesh phase's child ranks included; its
error against its plain version, its time, the plain version's, its
bound and the single library call's where there is one), and last the JSON
line {"ok": true, "device": {...}}. Any failed check exits non-zero before
it.
Exits non-zero without a CUDA device. TF32 off throughout. The synthetic
data cache (URSA_SYNTH_CACHE) is a directory under smoke_out/ emptied at the
start of every run, so no entry of an earlier run is read.
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
HYP_UPDATE = {**HYP, "lr": 0.02, "alpha": 0.2}  # the graph-vs-eager phase's update_hyp
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
AMORTIZE_K = 50  # graph replays a device timing: enough for milliseconds, within the budget
LATENCY_S = 6
TV_AMORTIZE_K = 10  # TVResNet-50 forwards take milliseconds: fewer replays
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
MCD_CHECK_N = 60000  # MNIST's train split: the MCdropout MLP200 check's epoch, 469 steps
SWA_HYP = {"lr_init": 0.05, "swag_lr": 0.01, "swag_wd": 5e-4, "momentum": 0.9,
           "burn_in_epochs": 2, "num_iterates": 3, "num_samples": 3}
# sampler -> (constructor keywords, sample() keywords, members, epochs, chains)
SAMPLERS = {
    "cSGHMC": (dict(hyperparameters=CYC_HYP, chains=2), {}, 4, 4, 2),
    "cSGLD": (dict(hyperparameters=CYC_HYP), {}, 2, 4, 1),
    "SGD": (dict(hyperparameters=SGD_HYP), {}, 1, 3, 1),
    "DeepEnsemble": (dict(hyperparameters={**SGD_HYP, "epochs": 1, "num_members": 3}), {},
                     3, 2, 3),
    "MCdropout": (dict(hyperparameters=MCD_HYP), {}, 4, 5, 1),  # on the bf16 twin itself
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
SYNTH_CACHE = "smoke_out/synth_cache"  # the run's synthetic data cache, emptied at its start
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
# each run's potentials graphed against their eager twin (the programs hidden)
# from one state and one set of draws under deterministic cuDNN, bit for bit
# (the check alone: their timing and profiled draws, recorded in PERF.md, were
# cut to make room for the mesh phase's programs): (a) HE_TWIN_DRAWS tuned
# MLP200MNIST draws from the warm start, (b) HE_CONV_TWIN_DRAWS PreResNet-20 x2
# draws, (c) one PCA-ESS WRN draw of both chains
HE_TWIN_DRAWS, HE_CONV_TWIN_DRAWS = 1, 1
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
# (e) cli time over the nine methods: S=3, T cut from 10 to 1 after 1 warm-up
# trial (2 until the mesh phase grew), the train split from 60,000 images
HE_TIME_T, HE_TIME_WARMUP, HE_TIME_TRAIN, HE_TIME_TEST = 1, 1, 10000, 2000
HE_OUT = "smoke_out/hmc_ess"
# the stream phase: (a) PreResNet-20 streamed per batch and in chunks of 16
# (bench.py:146-148's chunk_batches), (b) TVResNet-50 from a memmap of
# ST_IMAGENET_N images (cut from ImageNet's 1,281,167), (c) cli run --stream,
# (d) export, (e) trace_dir
STREAM_CHUNK = 16
# (a)'s timed epochs, one a mode since the mesh phase grew (R S C C S R until then)
ST_ORDER = ("resident", "streamed", "chunked")
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
# the timed turns of each row, after its warm-up: one a strategy (scan vmap vmap
# scan until the mesh phase grew again)
CH_ORDER = ("scan", "vmap")
# the chain counts whose rows also time an eager epoch of each strategy (PERF.md
# keeps the graphed/eager ratios measured at every count)
CH_EAGER_CHAINS = (1,)
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
# same seed; HMC on MLP200MNIST over MESH_MLP_TRAIN images on (1, 2) and (2, 1)
# against one process; PCA-ESS on PreResNet-20 over MESH_PCA_TRAIN images on
# (1, 2) against the local-BN oracle; PreResNet-20 streamed over (1, 2), per
# batch and in chunks of STREAM_CHUNK, against the resident sharded epoch
# (MESH_STREAM_TRAIN images: one chunk); PreResNet-20 SGHMC x2 on (2, 1)
# checkpointed every 2 epochs, killed after 2, resumed; (c) NCCL at a world
# size of 1 under torchrun, with cli run, --stream and --checkpoint_path
MESH_TRAIN, MESH_MLP_TRAIN = 512, 4096
MESH_PCA_TRAIN, MESH_STREAM_TRAIN = 1024, BATCH * STREAM_CHUNK
MESH_HMC = {"step_size": 2e-4, "num_samples": 2, "L": 10, "tau": 100.0, "burn": 0,
            "mass": 0.19}
MESH_PCA = {"swag_lr": 0.02, "swag_wd": 5e-4, "lr_init": 0.05, "num_samples": 2,
            "swag_momentum": 0.9, "swag_burn_in_epochs": 1, "num_swag_iterates": 2, "rank": 2,
            "max_rank": 2, "temperature": 5000.0, "prior_std": 2.0}
MESH_POTENTIAL = 1e-5  # HMC's CE sum and gradient on (1, 2) against one process, relative
MESH_ORACLE = 1e-5  # PCA-ESS's log density on (1, 2) against the local-BN oracle, relative
MESH_HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 1, "alpha": 0.1, "burn_in_epochs": 0}
# (b) on the ranks, each sharded program against its eager twin (the program
# hidden) under deterministic cuDNN: PreResNet-20 SGHMC over MESH_TWIN_TRAIN
# images (16 steps an epoch) on (2, 1) x2 chains and (1, 2) x1, MESH_TWIN_EPOCHS
# epochs each, the last one timed (two ranks on one card: no scaling figure)
MESH_TWIN_TRAIN, MESH_TWIN_EPOCHS = 2048, 2
MESH_CKPT_HYP = {**MESH_HYP, "num_samples": 2, "burn_in_epochs": 1}  # 3 epochs of 4 steps
MESH_PRR_GAP = 1e-5  # PreResNet-20 on (2, 1) against one process: ||a - b|| / ||b||
MESH_TIMEOUT = 300  # seconds for the two ranks, or for one torchrun command
MESH_RUN = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--inference_method", "SGLD",
            "--hyperparams", json.dumps({**MNIST_HYP, "num_samples": 2, "burn_in_epochs": 1}),
            "--synthetic_n_train", str(MESH_MLP_TRAIN), "--synthetic_n_test", "1024",
            "--num_trials", "1"]
MESH_OUT = "smoke_out/mesh"
# (d): cli run over three ranks sharing the card, a (2, 1) chain mesh and one idle rank
MESH_RUN3 = MESH_RUN + ["--mesh", "chain", "--chains", "2", "--chain_strategy", "scan"]
MESH_WORLD3 = 3
MESH_TORCHRUN = {"plain": [], "stream": ["--stream"],
                 "checkpoint": ["--checkpoint_path", f"{MESH_OUT}/torchrun_ck",
                                "--checkpoint_every", "1"]}


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAILED: {msg}", flush=True)
        sys.exit(1)


def bma_passes() -> dict:
    """The process's BMA passes by program path (``tracing``'s ``bma.pass``)."""
    from ursabench_tpu_torch import tracing

    return tracing.counters()["bma.pass"]["passes"]


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

    seed_t = torch.tensor([1], dtype=torch.int64, device=device)

    def dseed_call():
        sghmc_update_flat(p, v, g, s, seed=seed_t)

    ms, plain_ms = graph_ms([kernel_call], TIMED_LAUNCHES), graph_ms([plain_call], TIMED_LAUNCHES)
    dseed_ms = graph_ms([dseed_call], TIMED_LAUNCHES)
    call_ms = event_ms(kernel_call, TIMED_LAUNCHES, 20)
    bound_ms, bound_by = bound(SGHMC_BYTES * n_slice, SGHMC_FLOPS * n_slice, "f32")
    seeds = k1_device_seed_check(device, n_slice)
    print(f"kernel K1 sghmc_update: {cases} noise-off cases equal to the plain "
          f"version (max abs err {max_err:.3g}); noise std/expected "
          f"{std / expected:.4f}, KS {ks:.4f}; n={n_slice}: device {ms * 1e3:.2f} us "
          f"(its seed read from device memory: {dseed_ms * 1e3:.2f} us) "
          f"vs plain {plain_ms * 1e3:.2f} us (graphs of {TIMED_LAUNCHES} calls), "
          f"{call_ms * 1e3:.2f} us a call from Python; bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}), {bound(SGHMC_BYTES * TV_FLAT, 0, 'f32')[0] * 1e3:.1f}"
          f" us at TVResNet-50's {TV_FLAT}; the device-seed entry bit-equal to the by-value "
          f"launch in {seeds} cases (offsets 0 and 2 mod 4, table of 1 and 2 rows)", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "dseed_ms": dseed_ms}


def k1_device_seed_check(device, n: int) -> int:
    """K1 with its seed in device memory (a one-element int64 CUDA tensor,
    the graphed epoch's launch) against the by-value seed, the noise on, at
    offsets 0 and 2 (2 mod 4: a local group of four spans two global ones),
    with one row of scalars and with two; p and v must be bit-equal.
    Returns the cases checked."""
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat
    from ursabench_tpu_torch.ops.sgmcmc import sghmc_scalars

    gen = torch.Generator(device=device).manual_seed(3)
    rows = 2 * (n // 2)
    p, v, g = (torch.randn(rows, generator=gen, device=device) for _ in range(3))
    cases = 0
    for seed in (12345, 2 ** 63 - 25):
        for offset in (0, 2, 2 * rows + 6):
            for table_rows in (1, 2):
                s = sghmc_scalars(lr=torch.tensor([0.05, 0.02][:table_rows], device=device),
                                  momentum=0.9, wd_over_n=1e-5, n_train=50000.0,
                                  noise_on=1.0, is_first_step=torch.tensor(False, device=device),
                                  device=device).reshape(table_rows, 5).squeeze(0)
                out = []
                for sd in (seed, torch.tensor([seed], dtype=torch.int64, device=device)):
                    pk, vk = p.clone(), v.clone()
                    sghmc_update_flat(pk, vk, g, s, seed=sd, offset=offset)
                    out.append((pk, vk))
                torch.cuda.synchronize()
                check(torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1]),
                      f"K1 with its seed in device memory != the by-value seed at offset "
                      f"{offset}, {table_rows} row(s)")
                check(not torch.equal(out[0][1], v), "K1 left the momentum unchanged")
                cases += 1
    return cases


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
    from ursabench_tpu_torch.data.arrays import device_tensor
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
    passes = bma_passes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task.update_statistics(ens, output_performance=False)
    torch.cuda.synchronize()
    bma_s = time.perf_counter() - t0
    launches = sghmc_update_flat.launches
    bma = _bma_ran(ens, test, False, passes, 1)

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
    x = normalize(device_tensor(test.images[:BATCH], device), test.spec)
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

    prog = sampler._program
    check(sampler.step_program == "graph" and prog is not None and prog.captures == 1,
          f"slice: step_program {sampler.step_program}, captures "
          f"{None if prog is None else prog.captures}")
    print(f"slice SGHMC PreResNet-20 CIFAR-10 bs{BATCH}: step_program {sampler.step_program} "
          f"(captures {prog.captures}, the capture {prog.capture_ms:.1f} ms), {launches} K1 "
          f"launches, epoch losses {[round(v, 4) for v in losses]}, "
          f"{STEPS / sample_s:.1f} steps/s over sample() ({sample_s:.2f} s, "
          f"3 epochs incl. the first), BMA {test.n / bma_s:.0f} img/s "
          f"({ens.num_members} members, {bma_s:.2f} s, its first pass: warm-up and capture; "
          f"{bma}); data {data_s:.1f} s; "
          f"metrics {json.dumps(metrics)}", flush=True)
    return launches, splits, ens, sampler


def _eager_epoch(sampler):
    """One epoch of ``sampler`` on the step-by-step path (``train_steps``),
    its epoch program hidden for the call: what the sampler ran before the
    program, from the same draws."""
    sampler.epoch_program = lambda: None
    try:
        return sampler._run_epoch()
    finally:
        del sampler.epoch_program


def _snapshot(sampler):
    st = sampler._state
    return ([st.params.clone(), st.momentum.clone()],
            [b.clone() for m in sampler.modules for b in m.buffers()],
            st.step, sampler.epochs_run,
            {n: g.get_state() for n, g in sampler._generators().items()})


def _restore(sampler, snap) -> None:
    st = sampler._state
    (params, momentum), buffers, step, epochs, gens = snap
    with torch.no_grad():
        st.params.copy_(params)
        st.momentum.copy_(momentum)
        for b, saved in zip([b for m in sampler.modules for b in m.buffers()], buffers):
            b.copy_(saved)
    st.step, sampler.epochs_run = step, epochs
    for n, g in sampler._generators().items():
        g.set_state(gens[n])


class _TimedGraph:
    """A CUDA graph whose ``replay`` notes the host clock first: the
    intervals between replays are the host's time a graphed step."""

    def __init__(self, graph):
        self.graph, self.stamps = graph, []

    def pool(self):
        return self.graph.pool()

    def replay(self):
        self.stamps.append(time.perf_counter())
        self.graph.replay()


def _path_epoch(sampler, path: str) -> dict:
    """One epoch of ``sampler``, graphed or eager: the state after it, the
    host seconds until the call returned and until the card finished, and
    for the graph the shortest and the median interval between replays."""
    prog = sampler._program
    timed = path == "graph" and prog is not None and prog.graph is not None
    if timed:
        prog.graph = _TimedGraph(prog.graph)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        sampler._run_epoch() if path == "graph" else _eager_epoch(sampler)
    finally:
        host_s = time.perf_counter() - t0
        if timed:
            stamps, prog.graph = prog.graph.stamps, prog.graph.graph
    torch.cuda.synchronize()
    out = {"host_s": host_s, "wall_s": time.perf_counter() - t0}
    if timed:
        gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
        out["replay_gap_us"] = (gaps[0] * 1e6, gaps[len(gaps) // 2] * 1e6)
    st = sampler._state
    out["state"] = [st.params.clone(), st.momentum.clone()] + [
        b.clone() for m in sampler.modules for b in m.buffers()]
    return out


def _graph_and_eager(sampler) -> dict:
    """One epoch of ``sampler`` graphed, then one eager from the same state
    and draws (``_path_epoch`` each), by path."""
    snap, runs = _snapshot(sampler), {}
    for path in ("graph", "eager"):
        _restore(sampler, snap)
        runs[path] = _path_epoch(sampler, path)
    return runs


def _max_diff(a: list, b: list) -> float:
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


def _busy(prof) -> tuple:
    """(the kernels' summed device ms, the share of the window from the
    first kernel's start to the last one's end in which a kernel ran, the
    window's ms) of a torch.profiler trace."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return 0.0, float("nan"), 0.0
    total = sum(b - a for a, b in spans)
    union, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            union, lo, hi = union + hi - lo, a, b
        else:
            hi = max(hi, b)
    union += hi - lo
    window = max(b for _, b in spans) - spans[0][0]
    return total / 1e3, union / window * 100, window / 1e3


def _busy_shares(device, sampler=None) -> dict:
    """A sampler of 16-step epochs, by default PreResNet-20 SGHMC over 2,048
    CIFAR-10 images at the slice's batch: after a warm-up epoch (the
    capture), three untimed graphed and eager epochs each for the untraced
    time, then one graphed and one eager epoch under torch.profiler: the
    kernels' ms a step and the device's busy share of the traced window."""
    from ursabench_tpu_torch.profiling.hw import event_ms

    s = sampler
    if s is None:
        split, c = _ch_split("PreResNet20", "CIFAR10", 2048)
        s = _ch_sampler(device, "PreResNet20", split, c, "fp32", 1, "scan")
    s._run_epoch()
    out, steps = {}, s.train.num_batches
    for path in ("graph", "eager"):
        run = s._run_epoch if path == "graph" else (lambda: _eager_epoch(s))
        untraced = min(event_ms(run, 1) for _ in range(3))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernel_ms, busy, window_ms = _busy(prof)
        out[path] = {"kernel_ms_per_step": kernel_ms / steps, "busy_pct": busy,
                     "window_ms_per_step": window_ms / steps,
                     "untraced_ms_per_step": untraced / steps,
                     "kernel_pct_of_untraced": kernel_ms / untraced * 100}
    out["steps_run"] = (1 + 2 * 4) * steps  # the warm-up, then 3 untraced and 1 traced a path
    return out


def program_phase(device, sampler) -> dict:
    """The slice's sampler after its sample(): from one state and one set of
    draws an epoch graphed and two eager (``train_steps``) in the default
    cuDNN mode (graphed against eager and eager against eager: the largest
    difference; steps/s, host us a step); then, with ``cudnn.deterministic``,
    a program captured in that mode by one epoch, which a second sample() of
    one draw and ``update_hyp`` to other values (HYP_UPDATE: new weights,
    step 0, other rates and momentum, all written in place) must leave as
    the same program with its one capture, and its graphed epoch after them
    bit-equal to the eager one from the same state and draws (a replay that
    read a stale input would differ); then the device's busy share of a
    graphed and an eager step (``_busy_shares``). K1 once a step
    throughout: the replays count as launches."""
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    steps = sampler.train.num_batches
    prog = sampler._program
    sghmc_update_flat.launches = 0
    snap = _snapshot(sampler)
    runs = {}
    for path in ("graph", "eager", "eager2"):
        _restore(sampler, snap)
        runs[path] = _path_epoch(sampler, path.rstrip("2"))
    check(sampler._program is prog and prog.captures == 1,
          f"program: {prog.captures} captures after the timed epochs")
    default_diff = _max_diff(runs["graph"]["state"], runs["eager"]["state"])
    eager_diff = _max_diff(runs["eager2"]["state"], runs["eager"]["state"])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        sampler._program = None  # a program captured under deterministic cuDNN
        sampler._run_epoch()
        det_prog = sampler._program
        sampler.sample(1)
        sampler.update_hyp(HYP_UPDATE)
        check(sampler._program is det_prog and det_prog.captures == 1,
              f"program: a second sample() or update_hyp rebuilt the program or captured "
              f"again ({det_prog.captures} captures)")
        snap = _snapshot(sampler)
        det = {}
        for path in ("graph", "eager"):
            _restore(sampler, snap)
            det[path] = _path_epoch(sampler, path)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    det_diff = _max_diff(det["graph"]["state"], det["eager"]["state"])
    check(det_prog is not prog and det_prog.captures == 1 and det_diff == 0.0,
          f"program: the graphed epoch differs from the eager one by {det_diff:.3g} under "
          "deterministic cuDNN")
    launches = sghmc_update_flat.launches
    epochs = len(runs) + 1 + 1 + len(det)  # the capture's epoch, then sample(1)'s
    check(launches == epochs * steps,
          f"program: K1 launched {launches} times in {epochs} epochs of {steps} steps")
    busy = _busy_shares(device)
    launches = sghmc_update_flat.launches
    check(launches == epochs * steps + busy["steps_run"],
          f"program: K1 launched {launches} times, not once a step")
    out = {"capture_ms": prog.capture_ms, "captures": det_prog.captures,
           "pool_gb": prog.pool_bytes / 1e9, "default_max_abs_diff": default_diff,
           "eager_vs_eager_max_abs_diff": eager_diff, "deterministic_max_abs_diff": det_diff,
           "launches": launches, "busy": busy}
    for path in ("graph", "eager"):
        r = runs[path]
        out[path] = {"steps_per_s": steps / r["wall_s"],
                     "call_us_per_step": r["host_s"] / steps * 1e6}
    out["graph"]["replay_gap_us"] = runs["graph"]["replay_gap_us"]
    g, e = out["graph"], out["eager"]
    print(f"  step_program graph: one capture ({prog.capture_ms:.1f} ms, a pool of "
          f"{out['pool_gb']:.3f} GB); one epoch of {steps} "
          f"steps from one state and draws: graphed {g['steps_per_s']:.1f} steps/s, eager "
          f"{e['steps_per_s']:.1f} ({g['steps_per_s'] / e['steps_per_s']:.2f}x); host us a "
          f"step: eager {e['call_us_per_step']:.1f}, graphed {g['replay_gap_us'][0]:.1f} "
          f"(shortest interval between replays; median {g['replay_gap_us'][1]:.1f}, the call "
          f"{g['call_us_per_step']:.1f} a step with its waits for the card); 16-step epochs "
          f"(graphed / eager): {busy['graph']['untraced_ms_per_step']:.3f} / "
          f"{busy['eager']['untraced_ms_per_step']:.3f} ms a step untraced, the kernels "
          f"{busy['graph']['kernel_ms_per_step']:.3f} / {busy['eager']['kernel_ms_per_step']:.3f}"
          f" ms a step under torch.profiler ({busy['graph']['kernel_pct_of_untraced']:.1f}% / "
          f"{busy['eager']['kernel_pct_of_untraced']:.1f}% of the untraced step), busy "
          f"{busy['graph']['busy_pct']:.1f}% / {busy['eager']['busy_pct']:.1f}% of the traced "
          f"window ({busy['graph']['window_ms_per_step']:.3f} / "
          f"{busy['eager']['window_ms_per_step']:.3f} ms a step); largest difference graphed vs eager "
          f"{default_diff:.3g}, eager vs eager {eager_diff:.3g} (default cuDNN), graphed vs "
          f"eager {det_diff:.3g} (deterministic cuDNN: a program captured in that mode, its "
          f"{det_prog.captures} capture kept across a second sample() and update_hyp); K1 "
          f"{launches} launches, one a step of {epochs} epochs of {steps} and "
          f"{busy['steps_run']} steps of 16-step epochs", flush=True)
    return out


def _bma_ran(ens, split, smooth, passes_before: dict, passes: int) -> str:
    """Checks that the last ``passes`` BMA passes of ``ens`` over ``split``
    ran its program as a captured graph (one capture), none eagerly;
    returns a description of the program."""
    from ursabench_tpu_torch.inference.ensemble import EVAL_PROGRAMS
    from ursabench_tpu_torch.tasks.base import bma_program

    prog = bma_program(ens, split, smooth)
    ran = {k: bma_passes()[k] - v for k, v in passes_before.items()}
    check(prog.path == EVAL_PROGRAMS["bma"] == "graph" and prog.captures == 1
          and ran == {"graph": passes, "eager": 0},
          f"BMA: program {prog.path} with {prog.captures} captures, passes {ran}")
    return (f"BMA program graph ({prog.strategy} layout, {prog.captures} capture "
            f"{prog.capture_ms:.1f} ms, {passes} pass(es))")


def _pass_times(prog, eager: bool, reps: int = 3) -> dict:
    """``reps`` passes of a BMA program, graphed or eager: the median
    seconds (host clock, to the host copy of the sums), the sums of the
    last, and for the graph the median host interval between replays."""
    seconds, gaps, out = [], [], None
    for _ in range(reps):
        timed = not eager and prog.graph is not None
        if timed:
            prog.graph = _TimedGraph(prog.graph)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = prog(eager=eager)
        finally:
            seconds.append(time.perf_counter() - t0)
            if timed:
                stamps, prog.graph = prog.graph.stamps, prog.graph.graph
                gaps += [b - a for a, b in zip(stamps, stamps[1:])]
    r = {"s": sorted(seconds)[len(seconds) // 2], "out": out}
    if gaps:
        r["replay_gap_us"] = sorted(gaps)[len(gaps) // 2] * 1e6
    return r


def _pass_busy(prog, eager: bool) -> float:
    """The device's busy share of one pass under torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        prog(eager=eager)
        torch.cuda.synchronize()
    return _busy(prof)[1]


def _sums_diff(a, b) -> float:
    return max(float(np.abs(x.astype(np.float64) - y).max()) for x, y in zip(a, b))


def eval_program_phase(device, splits, ens) -> dict:
    """The evaluation programs against their eager steps: (a) the slice's
    ensemble (PreResNet-20, 2 members) over the 10,000 test images: one
    capture over two passes, graphed against eager (median of 3 passes
    each, host us a replay, the busy share), within 1e-6 in the default
    cuDNN mode and bit-equal under deterministic cuDNN (a program captured
    in that mode); (b) 5 PreResNet-20 members, the layout the rule picks
    beside both layouts under the graph and the eager pass; (c) an
    MC-dropout ensemble (MLP200MNIST's twin, 4 members, 10,000 MNIST test
    images), graphed against eager, bit-equal; (d) SWAG on PreResNet-20 over
    the 50,000 train images: one refresh program captured once across two
    draws, against the eager bn_refresh of the same weights, seconds each;
    (e) the validation-loss program against eval_loss."""
    import copy

    from ursabench_tpu_torch import data, inference, models
    from ursabench_tpu_torch.inference.engine import bn_refresh, eval_loss
    from ursabench_tpu_torch.inference.ensemble import EVAL_PROGRAMS, Ensemble
    from ursabench_tpu_torch.models.common import BatchNorm2d
    from ursabench_tpu_torch.profiling.latency import random_ensemble
    from ursabench_tpu_torch.tasks.base import bma_program
    from ursabench_tpu_torch.util import make_generator

    test, train = splits["test"], splits["train"]
    out = {}
    # (a) the slice's ensemble: its program from the slice's Prediction
    prog = bma_program(ens, test, False)
    check(prog.captures == 1, f"eval (a): {prog.captures} captures after the slice's pass")
    graph, eager = _pass_times(prog, False), _pass_times(prog, True)
    check(prog.captures == 1, f"eval (a): {prog.captures} captures over 4 graphed passes")
    default_diff = _sums_diff(graph["out"], eager["out"])
    check(default_diff <= 1e-6, f"eval (a): graphed and eager passes differ by {default_diff}")
    busy = {"graph": _pass_busy(prog, False), "eager": _pass_busy(prog, True)}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det_ens = Ensemble(ens.module, ens.state, ens.num_members)  # a program of this mode
        det = bma_program(det_ens, test, False)
        det()
        det_graph, det_eager = det(), det(eager=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    det_diff = _sums_diff(det_graph, det_eager)
    check(det.captures == 1 and det_diff == 0.0,
          f"eval (a): the graphed pass differs from the eager one by {det_diff} under "
          "deterministic cuDNN")
    out["slice"] = {"members": ens.num_members, "strategy": prog.strategy,
                    "graph_img_per_s": test.n / graph["s"], "eager_img_per_s": test.n / eager["s"],
                    "replay_gap_us": graph["replay_gap_us"], "busy_pct": busy,
                    "captures": prog.captures, "capture_ms": prog.capture_ms,
                    "pool_bytes": prog.pool_bytes, "default_max_abs_diff": default_diff,
                    "deterministic_max_abs_diff": det_diff}
    a = out["slice"]
    print(f"  (a) PreResNet-20 x{ens.num_members} ({prog.strategy}), {test.n} images: graphed "
          f"{a['graph_img_per_s']:.0f} img/s, eager {a['eager_img_per_s']:.0f} "
          f"({a['graph_img_per_s'] / a['eager_img_per_s']:.2f}x; medians of 3 passes); "
          f"host {a['replay_gap_us']:.1f} us a replay (median interval); busy "
          f"{busy['graph']:.1f}% / {busy['eager']:.1f}% (graphed / eager); {prog.captures} "
          f"capture over {prog.steps_run // test.num_batches} passes ({prog.capture_ms:.1f} ms, "
          f"a pool of {prog.pool_bytes / 1e6:.1f} MB); largest difference graphed vs eager "
          f"{default_diff:.3g} (default cuDNN), {det_diff:.3g} (deterministic cuDNN)",
          flush=True)

    # (b) 5 members under both layouts
    five = random_ensemble("PreResNet20", 10, 5, device)
    picked = five.strategy(test.batch_size, (3, 32, 32))
    rows = {}
    for strategy in (picked, "scan", "vmap"):
        if strategy in rows:
            continue
        five.member_strategy = strategy
        p = bma_program(five, test, False)
        p()  # the warm-up and the capture
        reps = 3 if strategy == picked else 1  # the other layout: one timed pass
        rows[strategy] = {"graph_img_per_s": test.n / _pass_times(p, False, reps)["s"]}
        if strategy == picked:
            rows[strategy]["eager_img_per_s"] = test.n / _pass_times(p, True)["s"]
        check(p.captures == 1 and p.strategy == strategy, f"eval (b): {strategy}")
    out["five"] = {"picked": picked, "rows": rows}
    print(f"  (b) PreResNet-20 x5, {test.n} images, graphed img/s (the picked layout's the "
          f"median of 3 passes, the other's one pass): "
          + ", ".join(f"{k} {v['graph_img_per_s']:.0f}" for k, v in rows.items())
          + f"; the rule picks {picked}, eager {rows[picked]['eager_img_per_s']:.0f} "
          f"({rows[picked]['graph_img_per_s'] / rows[picked]['eager_img_per_s']:.2f}x)",
          flush=True)

    # (c) MC dropout, bit-equal under deterministic cuDNN
    mnist, c = data.loaders("MNIST", None, batch_size=BATCH, use_validation=False,
                            synthetic_n_train=BATCH)
    twin = models.get_model("MLP200MNIST_dropout").build(c).to(device)
    twin.init_parameters(make_generator("cpu", 0, "twin"))
    state = {k: v.detach().clone().expand((4,) + tuple(v.shape))
             for k, v in twin.state_dict().items()}
    torch.backends.cudnn.deterministic = True
    try:
        mc = Ensemble(twin, state, 4, dropout_seed=11)
        p = bma_program(mc, mnist["test"], False)
        p()
        mc_graph, mc_eager = p(), p(eager=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    mc_diff = _sums_diff(mc_graph, mc_eager)
    check(p.captures == 1 and mc_diff == 0.0 and np.isfinite(mc_graph[1]).all(),
          f"eval (c): MC dropout graphed vs eager {mc_diff}")
    out["mc_dropout"] = {"strategy": p.strategy, "max_abs_diff": mc_diff, "layers": len(p.calls)}
    print(f"  (c) MC dropout MLP200 x4 ({p.strategy}, {len(p.calls)} dropout layers, masks "
          f"drawn into static buffers), {mnist['test'].n} images: graphed vs eager "
          f"{mc_diff:.3g}", flush=True)

    # (d) SWAG's refresh over the 50,000 train images, (e) the loss program
    swag = inference.SWAG({"swag_lr": 0.01, "swag_wd": 5e-4, "lr_init": 0.05, "momentum": 0.9,
                           "burn_in_epochs": 0, "num_iterates": 1, "num_samples": 2},
                          model=models.get_model("PreResNet20").build(10), train=train,
                          device=device, max_rank=2, pca_rank=2)
    swag.sample(2)
    refresh = swag._bn_refresh
    check(refresh.path == EVAL_PROGRAMS["bn_refresh"] and refresh.captures == 1
          and refresh.steps_run == 2 * train.num_batches,
          f"eval (d): the refresh program ran {refresh.path}, {refresh.captures} captures, "
          f"{refresh.steps_run} steps over two draws")
    plain = copy.deepcopy(swag._eval_module)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refresh()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    bn_refresh(plain, train, images=swag._images)
    torch.cuda.synchronize()
    graph_s, eager_s = t1 - t0, time.perf_counter() - t1
    worst = 0.0
    for m, q in zip(swag._eval_module.modules(), plain.modules()):
        if isinstance(m, BatchNorm2d):
            for a_, b_ in ((m.running_mean, q.running_mean), (m.running_var, q.running_var)):
                worst = max(worst, float((a_ - b_).abs().max() / b_.abs().max()))
    check(worst < 1e-4, f"eval (d): the refresh program differs from bn_refresh by {worst}")
    out["refresh"] = {"graph_s": graph_s, "eager_s": eager_s, "max_rel_diff": worst,
                      "captures": refresh.captures, "capture_ms": refresh.capture_ms}
    print(f"  (d) SWAG PreResNet-20 refresh over {train.n} images: one capture over "
          f"{refresh.steps_run // train.num_batches} calls ({refresh.capture_ms:.1f} ms); "
          f"program {graph_s:.3f} s, eager bn_refresh {eager_s:.3f} s "
          f"({eager_s / graph_s:.2f}x); largest difference {worst:.3g} of a layer's largest "
          f"statistic", flush=True)
    want = float(eval_loss(swag.module, test, state=swag._single_member()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [swag.compute_val_loss(test) for _ in range(2)]
    torch.cuda.synchronize()
    loss_s = (time.perf_counter() - t0) / 2
    loss = swag._val_loss_programs[id(test)][1]
    rel = abs(got[1] - want) / abs(want)
    check(loss.path == EVAL_PROGRAMS["val_loss"] and loss.captures == 1 and got[0] == got[1]
          and rel <= 1e-6, f"eval (e): loss program {got} against eval_loss {want}")
    out["val_loss"] = {"program": got[1], "eager": want, "rel_diff": rel, "s": loss_s}
    print(f"  (e) the loss program over {test.n} images: {got[1]:.6f} against eval_loss "
          f"{want:.6f} (relative {rel:.3g}), {loss.captures} capture over two calls, "
          f"{loss_s:.3f} s a call", flush=True)
    return out


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
    from ursabench_tpu_torch.data.arrays import device_tensor
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
    x = normalize(device_tensor(test.images[:BATCH], device), test.spec)
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
                # the strategy the rule does not pick: its device time only
                r = profile_config(cfg, amortize_k=AMORTIZE_K, member_strategy=strategy,
                                   device=device, per_call=strategy == auto)
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
                                   device=device, per_call=strategy == auto)
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
                  (("latency_mean_s",) if is_auto else ()) + ("amortized_latency_s",)),
              f"latency {r}")
        per_call = (f"{r['latency_mean_s'] * 1e3:.3f} ms" if "latency_mean_s" in r
                    else "not timed")
        print(f"  latency {r['precision']} S={r['ensemble_size']} bs{r['batch_size']} "
              f"{r['amortized_member_strategy']}{' (auto)' if is_auto else ''}: "
              f"per call {per_call}, device "
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

    from ursabench_tpu_torch.inference.ensemble import EVAL_PROGRAMS

    cfg = ProfileConfig("PreResNet20", "CIFAR10", "fp32", 2, BATCH)
    passes = bma_passes()
    res = profile_prediction(cfg, splits, 10, device=device)
    # the latency mode times each eager call (logits_all), by rule: no BMA program
    check(EVAL_PROGRAMS["latency"] == "eager" and bma_passes() == passes,
          f"latency mode: BMA passes {passes} -> {bma_passes()}")
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
          f"ms per batch after burn-in (eager calls, by rule); metrics equal to the plain "
          f"Prediction's (its BMA program)",
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
    weight gradient of it, in the layout the model runs it."""
    import torch.nn.functional as F

    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.data.arrays import device_tensor
    from ursabench_tpu_torch.data.transforms import normalize
    from ursabench_tpu_torch.kernels.conv1x1 import conv1x1_mm, conv1x1_wgrad

    bf16 = torch.bfloat16
    m = models.get_model("TVResNet50").build(1000, dtype=bf16).to(device)
    m.init_parameters(torch.Generator().manual_seed(0))
    conv = m.layer1[1].conv1
    seen = {}
    hook = conv.register_forward_hook(
        lambda mod, inp, out: seen.update(x=inp[0].detach(), y=out.detach()))
    x = normalize(device_tensor(test.images[:BATCH], device), test.spec)
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
    fmt = conv.memory_format(inp)  # the layout the model runs this conv in
    F.conv2d(inp.to(memory_format=fmt), wb.to(memory_format=fmt)).backward(
        g.to(memory_format=fmt))
    dw = conv1x1_wgrad(rows, g.permute(0, 2, 3, 1).reshape(-1, 64).contiguous())
    torch.cuda.synchronize()
    e_mm = bf16_close(y, out.permute(0, 2, 3, 1).reshape(-1, 64), 2)
    e_wg = bf16_close(dw, wb.grad.reshape(64, 256).T, 2)
    print(f"  model check, TVResNet-50 layer1[1].conv1 on rows {tuple(rows.shape)}: K3a vs "
          f"cuDNN max abs err {e_mm:.3g}, K3b vs autograd {e_wg:.3g} (within 2 bf16 ulps "
          f"+ 1e-3 max)", flush=True)


def conv_wgrad_check(device) -> None:
    """Every bf16 conv's weight gradient in TVResNet-50 (a batch of 128 at
    224^2) and in WideResNet-28x10 (128 at 32^2), each through the layer's
    own forward, in the memory format the layer runs it in, against float32's
    from the same bf16 input and output gradient, within 2 bf16 ulps plus
    1e-3 of its largest magnitude."""
    import torch.nn.functional as F

    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.models.common import Conv2d

    bf16 = torch.bfloat16
    for name, classes, side in (("TVResNet50", 1000, 224), ("WideResNet28x10", 100, 32)):
        m = models.get_model(name).build(classes, dtype=bf16).to(device).train()
        m.init_parameters(torch.Generator().manual_seed(0))
        seen = []
        hooks = [c.register_forward_hook(lambda c, i, o, n=n: seen.append((n, c, i[0].detach())))
                 for n, c in m.named_modules() if isinstance(c, Conv2d)]
        gen = torch.Generator(device=device).manual_seed(2)
        with torch.no_grad():
            m(torch.randn(BATCH, 3, side, side, generator=gen, device=device))
        for h in hooks:
            h.remove()
        worst, formats = (0.0, ""), {"channels_last": 0, "nchw": 0}
        for n, conv, x in seen:
            conv.weight.grad = None
            x = x.detach()
            out = conv(x)
            g = torch.empty_like(out).copy_(
                torch.randn(out.shape, generator=gen, device=device, dtype=bf16))
            out.backward(g)
            ran = conv.memory_format(x)
            formats["channels_last" if ran == torch.channels_last else "nchw"] += 1
            xb = x.to(bf16).float().contiguous()
            want = torch.nn.grad.conv2d_weight(xb, conv.weight.shape, g.float().contiguous(),
                                               conv.stride, conv.padding).to(bf16)
            got = conv.weight.grad.to(bf16)
            bound = 2 * bf16_ulp(want) + 1e-3 * float(want.float().abs().max())
            ratio = float(((got.float() - want.float()).abs() / bound).max())
            worst = max(worst, (ratio, n))
            bf16_close(got, want, 2)
        print(f"  bf16 conv weight gradients, {name} at ({BATCH}, 3, {side}, {side}): "
              f"{len(seen)} convs ({formats}) within 2 bf16 ulps + 1e-3 max of float32's, the "
              f"largest at {worst[0]:.3f}x the bound ({worst[1]})", flush=True)
        del m, seen
        torch.cuda.empty_cache()


def imagenet_phase(device) -> dict:
    """TVResNet-50 bf16 SGHMC + BMA at 224^2 (profiling/imagenet_train.run),
    then the K3 check on the model's own layer."""
    from ursabench_tpu_torch import models
    from ursabench_tpu_torch.data.arrays import device_tensor
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
    x = normalize(device_tensor(test.images[:BATCH], device), test.spec)
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
    conv_wgrad_check(device)
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
    from ursabench_tpu_torch.data.arrays import device_tensor
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
    twin = models.dropout_twin("WideResNet28x10")
    check(sum(p.numel() for p in build().parameters()) == WRN_FLAT, "WRN parameter count")
    x = normalize(device_tensor(test.images[:BATCH], device), test.spec)
    x = x.permute(0, 3, 1, 2).contiguous()

    sghmc_update_flat.launches = 0
    rows, k1_after = {}, {}
    for name, (kw, sample_kw, members, epochs, chains) in SAMPLERS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        module = (twin.build(WRN_CLASSES, dtype=torch.bfloat16) if name == "MCdropout"
                  else build())
        sampler = getattr(inference, name)(model=module, train=train, seed=0, device=device,
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
        passes = bma_passes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.update_statistics(ens, output_performance=False)
        torch.cuda.synchronize()
        bma_s = time.perf_counter() - t0
        bma = _bma_ran(ens, test, False, passes, 1)
        refresh = getattr(sampler, "_bn_refresh", None)
        if refresh is not None:  # SWA and SWAG: one refresh program, one capture
            check(refresh.path == "graph" and refresh.captures == 1,
                  f"{name}: the refresh program ran {refresh.path} with {refresh.captures} "
                  "captures")
            bma += f"; refresh program graph, {refresh.captures} capture over its draws"
        metrics = task.get_performance_metrics()
        err = metrics["error_rate"]
        for k, val in metrics.items():
            nan_by_design = k.startswith("misclass") and err in (0.0, 1.0)
            check(math.isfinite(val) or nan_by_design, f"{name}: metric {k} = {val}")
        if name == "DeepEnsemble":  # the BMA pass against plain per-member modules
            want = reference_probs(lambda: build().to(device), ens, x).cpu().numpy()
            diff = float(np.abs(task.ensemble_proba[:BATCH] - want).max())
            check(diff < 1e-2, f"DeepEnsemble BMA differs from plain modules by {diff}")
            # a device-bound pass, graphed against its eager steps (medians of 3)
            bprog = tasks.base.bma_program(ens, test, False)
            g, e = (test.n / _pass_times(bprog, eager)["s"] for eager in (False, True))
            bma += f"; graphed {g:.0f} img/s against eager {e:.0f} ({g / e:.3f}x, medians of 3)"
        if name == "MCdropout":
            a, b = ens.logits_all(x, 0), ens.logits_all(x, 0)
            check(torch.equal(a, b), "MCdropout: one seed gave different logits")
            check(not torch.allclose(a[0], a[1]), "MCdropout: two members agree")
        # every sampler's epochs through its program (the dropout twin's too),
        # one capture, kept across update_hyp and a second sample() (SGD's)
        prog = sampler._program
        check(sampler.step_program == "graph" and prog is not None and prog.path == "graph",
              f"{name}: step_program {sampler.step_program}, program {prog}")
        if name == "SGD":
            sampler.update_hyp(SGD_HYP)
            sampler.sample(**sample_kw)
            check(sampler._program is prog and sampler.epochs_run == epochs,
                  "SGD: update_hyp and a second sample() rebuilt the program")
        graph_over_eager = None
        if name == "MCdropout":  # the device-bound dropout step: an epoch graphed and eager
            pair = _graph_and_eager(sampler)
            g, e = (WRN_STEPS / pair[path]["wall_s"] for path in ("graph", "eager"))
            graph_over_eager = g / e
            bma += (f"; one epoch from one state graphed {g:.2f} steps/s against eager {e:.2f} "
                    f"({graph_over_eager:.3f}x), {len(prog.dropout.masks)} masks drawn before "
                    "each replay")
        captures = prog.captures
        check(captures == 1, f"{name}: {captures} captures")
        steps = epochs * WRN_STEPS
        rows[name] = {"members": members, "epochs": epochs, "chains": chains, "steps": steps,
                      "sample_s": sample_s, "step_forwards_per_s": steps * chains / sample_s,
                      "bma_s": bma_s, "bma_img_per_s": test.n / bma_s, "error_rate": err,
                      "epoch_losses": losses.tolist(), "step_program": sampler.step_program,
                      "captures": captures, "graph_over_eager": graph_over_eager}
        print(f"  {name}: step_program {sampler.step_program} (captures {captures}"
              f"{', across update_hyp and a second sample()' if name == 'SGD' else ''}); "
              f"{members} members, {epochs} epochs x {chains} chain(s) of "
              f"{WRN_STEPS} steps in {sample_s:.2f} s, {steps * chains / sample_s:.2f} "
              f"step-forwards/s over sample(); BMA {test.n / bma_s:.0f} img/s ({bma_s:.2f} s; "
              f"{bma}); "
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
    return {"launches": launches, "rows": rows, "k1": k1, "mcdropout": mcdropout_check(device)}


def mcdropout_check(device) -> dict:
    """MC dropout on MLP200MNIST (the registry's twin, rate 0.2) over
    MCD_CHECK_N synthetic MNIST images at batch 128, under deterministic cuDNN: a
    warm-up epoch (the capture), then one epoch through the program (each
    step's two keep masks drawn into static buffers before its replay) and
    one through ``train_steps`` from the same state and draws: bit-equal;
    steps/s and host us a step of each, and the host's us a step in the
    mask draws alone."""
    from ursabench_tpu_torch import data, inference, models

    splits, c = data.loaders("MNIST", None, batch_size=BATCH, use_validation=False,
                             synthetic_n_train=MCD_CHECK_N, synthetic_n_test=MNIST_TEST)
    s = inference.MCdropout(MCD_HYP, model=models.get_model("MLP200MNIST").build(c),
                            train=splits["train"], seed=0, device=device,
                            model_name="MLP200MNIST")
    steps = s.train.num_batches
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        s._run_epoch()
        prog = s._program
        runs = _graph_and_eager(s)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = _max_diff(runs["graph"]["state"], runs["eager"]["state"])
    check(s.step_program == "graph" and prog.path == "graph" and prog.captures == 1
          and s._program is prog and len(prog.dropout.masks) == 2,
          f"MCdropout MLP200: program {prog.path}, {prog.captures} captures, "
          f"{len(prog.dropout.masks)} masks")
    check(diff == 0.0, f"MCdropout MLP200: the graphed epoch differs from the eager one by "
                       f"{diff:.3g} under deterministic cuDNN")
    check(all(math.isfinite(float(v)) for v in s.epoch_losses), "MCdropout MLP200: losses")
    seeds = [int(x) for x in torch.randint(0, 2 ** 62, (1,))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        prog.dropout.draw(seeds, i)
    draw_us = (time.perf_counter() - t0) / steps * 1e6
    torch.cuda.synchronize()
    out = {"steps": steps, "max_abs_diff": diff, "capture_ms": prog.capture_ms,
           "pool_bytes": prog.pool_bytes, "draw_us_per_step": draw_us}
    for path in ("graph", "eager"):
        out[path] = {"steps_per_s": steps / runs[path]["wall_s"],
                     "call_us_per_step": runs[path]["host_s"] / steps * 1e6}
    g, e = out["graph"], out["eager"]
    print(f"  MCdropout MLP200MNIST, {MCD_CHECK_N} images, batch {BATCH}: one epoch of {steps} "
          f"steps graphed {g['steps_per_s']:.1f} steps/s against eager {e['steps_per_s']:.1f} "
          f"({g['steps_per_s'] / e['steps_per_s']:.2f}x), bit-equal under deterministic cuDNN; "
          f"host us a step graphed {runs['graph']['replay_gap_us'][0]:.1f} between replays "
          f"(median {runs['graph']['replay_gap_us'][1]:.1f}), of it {draw_us:.1f} drawing "
          f"the {len(prog.dropout.masks)} masks; eager {e['call_us_per_step']:.1f}; one capture "
          f"({prog.capture_ms:.1f} ms)", flush=True)
    return out


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
                         "step_program": sampler.step_program,
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
    """K1 once a step over ``runs``' samplers; prints their step programs."""
    steps = sum(r["epochs"] * r["batches"] for r in runs)
    check(launches == steps, f"{name}: K1 launched {launches} times for {steps} steps "
          f"(all chains of a step in one launch)")
    print(f"  {name}: step_program {', '.join(r['step_program'] for r in runs)}", flush=True)
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


def _data_stage_miss_hit(argv, device) -> dict:
    """The runner's data stage for ``argv`` (its train and test splits, then
    its OOD pairings, loaded as ``experiment.main`` loads them), twice into
    a fresh synthetic cache of its own: a miss, which generates and writes
    every set, then a hit, which maps them. Beside each, the move of every
    split it loaded to the card (``device_tensors``, as the samplers and
    tasks make it), which on a hit pages the mapped sets in."""
    import os
    import shutil

    from ursabench_tpu_torch import data, experiment, models

    args = experiment.build_parser().parse_args(argv)
    cfg = models.get_model(args.model)
    cache, saved = os.path.abspath(f"{SYNTH_CACHE}_config4"), os.environ.get("URSA_SYNTH_CACHE")
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["URSA_SYNTH_CACHE"] = cache
    out = {}
    try:
        for kind in ("miss", "hit"):
            t0 = time.perf_counter()
            splits, _ = data.loaders(
                args.dataset, args.data_path, args.batch_size, args.num_workers,
                transform_train=cfg.transform_train, transform_test=cfg.transform_test,
                shuffle_train=True, use_validation=args.use_val, val_size=args.validation,
                split_classes=args.split_classes, seed=args.seed,
                synthetic_n_train=args.synthetic_n_train,
                synthetic_n_test=args.synthetic_n_test)
            ood = experiment._load_ood(args, cfg)
            out[kind] = time.perf_counter() - t0
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            moved = [split.device_tensors(device)
                     for split in [*splits.values(), *(o["test"] for o in ood)]]
            torch.cuda.synchronize(device)
            out[f"{kind}_to_card"] = time.perf_counter() - t0
            del moved
        out["entries"] = len(os.listdir(cache)) // 2
    finally:
        if saved is None:
            del os.environ["URSA_SYNTH_CACHE"]
        else:
            os.environ["URSA_SYNTH_CACHE"] = saved
    check(out["entries"] == 6, f"config 4's data stage cached {out['entries']} sets, not 6")
    print(f"  config 4's data stage ({args.dataset} {args.synthetic_n_train} / "
          f"{args.synthetic_n_test} images, STL10 and SVHN as its OOD pairings; "
          f"{out['entries']} synthetic sets): cache miss {out['miss']:.3f} s, hit "
          f"{out['hit']:.3f} s; its splits to the card after the miss "
          f"{out['miss_to_card']:.3f} s, after the hit {out['hit_to_card']:.3f} s (the "
          "hit's page-in)", flush=True)
    return out


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
    out["data_stage"] = _data_stage_miss_hit(argv, device)
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
    check(solo.step_program == "graph" and solo._program.captures == 1,
          f"config 5: the solo run's step_program {solo.step_program}")
    solo_rate = epochs * train.num_batches / solo_s
    rates = [forwards / r["sample"] for r in rounds]
    print(f"  config 5 (PreResNet-20 / CIFAR-10 {train.n} train, {test.n} test; batched BO "
          f"{HP_BO}): {bo_s:.1f} s, K1 {launches} launches = {steps} sweep steps (4 configs "
          f"a launch); sweep step-forwards/s {', '.join(f'{x:.1f}' for x in rates)} vs one "
          f"config solo {solo_rate:.1f} steps/s ({solo_s:.2f} s with set-up; step_program "
          f"{solo.step_program}); best ll "
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
        check(sweep.sampler.step_program == "graph",
              f"sweep {method}: step_program {sweep.sampler.step_program}")
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
        check(sampler.step_program == "graph" and sampler._program.captures == 1,
              f"{name} {method}: step_program {sampler.step_program}")
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
        print(f"  {name} / {dataset} {method} x{sampler.chains} chain(s), step_program "
              f"{sampler.step_program}: {members} members, "
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
    print(f"  sweep vs solo (MLP200MNIST, SGD and noise-off SGHMC, 2 configs; step_program "
          f"graph): largest "
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


def _program_stats(name, sampler) -> dict:
    """``sampler``'s potential programs (HMC's or PCA-ESS's) after its
    draws: step_program "graph", each program on the graph path, captured
    once across every draw (one a variant and row count) once it ran past
    its WARMUP_STEPS eager steps (a program that ran no more, such as the
    first CE sums of a chain whose split is one batch, has no capture);
    each one's captures, capture ms, pool MB and steps."""
    from ursabench_tpu_torch.inference.engine import WARMUP_STEPS

    progs = sampler._programs
    check(sampler.step_program == "graph" and bool(progs)
          and all(p.path == "graph" and p.captures == int(p.steps_run > WARMUP_STEPS)
                  for p in progs.values()),
          f"{name}: step_program {sampler.step_program}, programs (path, captures, steps) "
          f"{ {k: (p.path, p.captures, p.steps_run) for k, p in progs.items()} }")
    return {str(k): {"captures": p.captures, "capture_ms": p.capture_ms or 0.0,
                     "pool_mb": (p.pool_bytes or 0) / 1e6, "replays": p.steps_run}
            for k, p in progs.items()}


def _program_line(stats: dict) -> str:
    return "; ".join(f"{k} {v['captures']} capture ({v['capture_ms']:.1f} ms, a pool of "
                     f"{v['pool_mb']:.1f} MB), {v['replays']} steps"
                     for k, v in stats.items())


def _warm_hmc(h) -> None:
    """An untimed draw of ``h``, then first CE sums until its CE-sum
    program is captured too (a program captures at its fourth step, and
    the first CE sums take one step a batch, once a chain under scan)."""
    h.sample(num_samples=1)
    ce = h.potential_program(False, h._resolved_chain_strategy == "vmap")
    while ce.path == "graph" and not ce.captures:
        h._initial_ce_sums(h._theta0.clone())


def _hmc_twins(name, make, draws: int) -> dict:
    """HMC graphed against its eager twin under deterministic cuDNN: two
    samplers from ``make()`` (one seed and init), the second with its
    programs hidden (the plain potentials), ``draws`` draws each with the
    generator reseeded to one value; the graphed one after ``_warm_hmc``
    (both its programs captured). The ensembles and accept rates must be
    equal bit for bit. (Their rates and busy shares were recorded in
    PERF.md by the runs that added the programs; the check alone stays.)"""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out, runs = {}, {}
    try:
        for path in ("graph", "eager"):
            h = make()
            if path == "eager":
                h.potential_program = lambda grad, batched: None
            else:
                _warm_hmc(h)
            h._gen.manual_seed(7)
            runs[path] = h.sample(num_samples=draws), h.accept_rate
            if path == "graph":
                out["programs"] = _program_stats(f"{name} twin", h)
            del h
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (got, got_acc), (want, want_acc) = runs["graph"], runs["eager"]
    diff = max(float((got.state[k].double() - v.double()).abs().max())
               for k, v in want.state.items())
    check(diff == 0.0 and got_acc == want_acc,
          f"{name}: the graphed draws {diff:.3g} from the eager twin's (accept {got_acc} / "
          f"{want_acc}), deterministic cuDNN")
    out.update(max_abs_diff=diff, draws=draws)
    return out


def _twin_line(t: dict) -> str:
    return (f"graphed vs eager twin, {t['draws']} draw(s) from one state and draws under "
            f"deterministic cuDNN, bit-equal (largest difference {t['max_abs_diff']:.3g}); "
            f"programs: {_program_line(t['programs'])}")


def hmc_tuned_run(device) -> dict:
    """(a) HMC on MLP200MNIST at the reference's tuned values over 60,000
    synthetic MNIST images (float32, grad_batch 4096: 15 replays a
    potential), TF32 allowed around it (HMC turns it off in its potential):
    a cold start from the init, then the cut chain from a 1-epoch SGD warm
    start, Prediction on its kept draws, and its first draw's float32 log
    ratio against float64; both runs' potentials through their programs,
    one capture each; then HE_TWIN_DRAWS draws from the warm start graphed
    against the eager twin (``_hmc_twins``)."""
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
    programs = {"cold": _program_stats("HMC cold", cold), "warm": _program_stats("HMC", hmc)}
    warm = hmc._theta0

    def make():
        h = inference.HMC({**tuned, "num_samples": HE_TWIN_DRAWS, "burn": 0}, model=build(),
                          train=splits["train"], seed=0, device=device)
        h._theta0 = warm.clone()
        return h

    twins = _hmc_twins("HMC MLP200MNIST", make, HE_TWIN_DRAWS)
    grads = HE_DRAWS * (hmc.L + 1)
    out = {"accept_rate": hmc.accept_rate, "cold_accept_rate": cold.accept_rate,
           "cold_log_ratios": cold_ratios, "sample_s": sample_s,
           "s_per_draw": sample_s / HE_DRAWS, "grads_per_s": grads / sample_s,
           "log_ratio": float(log_ratio), "log_ratio_f64": ratio64, "log_ratio_err": ratio_err,
           "ce_diff_err_vs_f64_model": ce_err, "metrics": metrics,
           "warm_sgd_losses": [float(x) for x in sgd.epoch_losses],
           "programs": programs, "twins": twins}
    print(f"  (a) HMC MLP200MNIST / MNIST {HE_MNIST_TRAIN}, tuned step {hmc.step_size:.4g}, "
          f"L {hmc.L}, tau {hmc.tau:g}, mass {hmc.mass:.4g}: cold start accept rate "
          f"{cold.accept_rate:.3f} over {HE_COLD_DRAWS} draws (log ratios "
          f"{[round(r, 3) for r in cold_ratios]}); from the SGD warm start (loss "
          f"{out['warm_sgd_losses'][-1]:.4f}) {HE_DRAWS} draws in {sample_s:.2f} s, accept rate "
          f"{hmc.accept_rate:.3f}, {sample_s / HE_DRAWS:.4f} s/draw, {grads / sample_s:.1f} "
          f"full-batch gradients/s; first log ratio {float(log_ratio):.6f}, float64 "
          f"{ratio64:.6f} (|diff| {ratio_err:.3g}), CE-sum difference vs a float64 model "
          f"{ce_err:.3g}; {ens.num_members} members: {json.dumps(metrics)}; step_program "
          f"{hmc.step_program}, programs: {_program_line(programs['warm'])}", flush=True)
    print(f"  (a) {_twin_line(twins)}", flush=True)
    return out


def hmc_conv_run(device) -> dict:
    """(b) HMC on PreResNet-20 at full width and depth, 2 chains (in turn:
    "auto" picks scan), over 2,048 synthetic CIFAR-10 images: eval-mode
    BatchNorm and cuDNN convolutions in the potential, one replay a
    potential (grad_batch 4096 > 2,048); members = kept draws x 2; one
    capture a program; then HE_CONV_TWIN_DRAWS draws graphed against the
    eager twin (``_hmc_twins``)."""
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
    programs = _program_stats("HMC PreResNet-20", hmc)
    accept = hmc.accept_rate
    del hmc, ens  # its graphs' pools, before the twins capture theirs
    twins = _hmc_twins("HMC PreResNet-20", lambda: inference.HMC(
        {**HE_CONV_HYP, "num_samples": HE_CONV_TWIN_DRAWS}, model=cfg.build(c),
        train=splits["train"], seed=1, device=device, chains=HE_CONV_CHAINS),
        HE_CONV_TWIN_DRAWS)
    grads = HE_CONV_HYP["num_samples"] * HE_CONV_CHAINS * (HE_CONV_HYP["L"] + 1)
    print(f"  (b) HMC PreResNet-20 x{HE_CONV_CHAINS} chains, {HE_CONV_TRAIN} images, L "
          f"{HE_CONV_HYP['L']}: {kept * HE_CONV_CHAINS} members in {sample_s:.2f} s, "
          f"{grads / sample_s:.1f} full-batch gradients/s, accept rate {accept:.3f}; "
          f"{json.dumps(metrics)}; programs: {_program_line(programs)}", flush=True)
    print(f"  (b) {_twin_line(twins)}", flush=True)
    return {"sample_s": sample_s, "members": kept * HE_CONV_CHAINS, "accept_rate": accept,
            "grads_per_s": grads / sample_s, "metrics": metrics, "programs": programs,
            "twins": twins}


def _pca_twin(pca) -> dict:
    """One draw of ``pca``'s chains from its current state graphed against
    its eager twin under deterministic cuDNN: density programs captured in
    that mode (by a warm-up draw from the same state), then the draw
    through them, then with them hidden (the plain densities), each from
    the same state and streams: the points, log densities and bracket
    counts bit for bit. The sampler's own programs, state and bracket
    record are put back after."""
    gens = [g.get_state() for g in pca._gens]
    theta, lp, done = pca.current_theta.clone(), pca.current_lnpdf.clone(), len(pca.bracket_iters)
    kept, deterministic = pca._programs, torch.backends.cudnn.deterministic

    def restore():
        for g, st in zip(pca._gens, gens):
            g.set_state(st)
        pca.current_theta, pca.current_lnpdf = theta.clone(), lp.clone()

    out, runs = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        pca._programs = {}
        restore()
        pca.sample_iterative(update_bn=False)  # the programs' warm-up steps and captures
        for path in ("graph", "eager"):
            restore()
            if path == "eager":
                pca.density_program = lambda rows: None
            pca.sample_iterative(update_bn=False)
            runs[path] = (pca.current_theta.clone(), pca.current_lnpdf.clone(),
                          pca.bracket_iters[-1])
        del pca.density_program
        out["programs"] = _program_stats("PCA-ESS twin", pca)
    finally:
        pca.__dict__.pop("density_program", None)
        torch.backends.cudnn.deterministic = deterministic
        pca._programs = kept
        restore()
        del pca.bracket_iters[done:]
    (gt, gl, gi), (et, el, ei) = runs["graph"], runs["eager"]
    diff = max(float((gt - et).abs().max()), float((gl - el).abs().max()))
    check(diff == 0.0 and gi == ei,
          f"PCA-ESS: the graphed draw {diff:.3g} from the eager twin's, brackets {gi} / {ei}, "
          "deterministic cuDNN")
    out.update(max_abs_diff=diff, draws=1, brackets=gi)
    return out


def pca_wrn_run(device) -> dict:
    """(c) The PCA-subspace ESS sampler on WideResNet-28x10 bf16 at full
    width and depth over the samplers phase's synthetic CIFAR-100 cut, 2
    chains (in turn: "auto" picks scan), 3 draws: the SWA's trained
    BatchNorm buffers untouched by every log-density call, every density
    through its program (one capture across the draws), Prediction finite;
    then one draw graphed against the eager twin (``_pca_twin``)."""
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
    programs, calls = _program_stats("PCA-ESS", pca), state["calls"]
    twin = _pca_twin(pca)
    out = {"rank": pca.subspace.rank, "bracket_iters": pca.bracket_iters,
           "lnpdf_calls": calls, "sample_s": sample_s, "swa_s": state["swa_s"],
           "ess_s_per_draw": ess_s / draws, "metrics": metrics, "programs": programs,
           "twin": twin}
    print(f"  (c) PCA-ESS WRN-28x10 bf16 x{HE_PCA_CHAINS} chains: SWA {pca.swa.epochs_run} "
          f"epochs in {state['swa_s']:.2f} s, subspace rank {pca.subspace.rank}; {draws} draws: "
          f"bracket proposals per draw and chain {pca.bracket_iters}, {calls} "
          f"full-data log densities, {ess_s / draws:.2f} s a draw (both chains, the last with "
          f"its BatchNorm refresh); SWA's BatchNorm buffers unchanged; {json.dumps(metrics)}; "
          f"programs: {_program_line(programs)}", flush=True)
    print(f"  (c) {_twin_line(twin)} (brackets {twin['brackets']})", flush=True)
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
    split = {m: _time_split(device, m) for m in ("MCdropout", "SGD")}
    return {"seconds": seconds, "launches": launches, "times": timer, "split": split}


def _time_split(device, method: str) -> dict:
    """One more ``cli time`` trial of ``method`` (its tuned values, the
    burn-in zeroed, S=3) with the CUDA-synchronized seconds of the
    sampler's set-up, of each epoch it trains, and of the harvest (the rest
    of ``sample()``); the epochs and steps must be the protocol's: MCdropout
    1 + 1 + 1 epochs, SGD epochs + 1 = 1, though the CPU baseline
    (benchmarks/torch_cpu_methods.py:284-297) trains none."""
    from ursabench_tpu_torch import data, inference, models, time_script

    cfg = models.get_model("MLP200MNIST")
    splits, c = data.loaders("MNIST", None, BATCH, transform_train=cfg.transform_train,
                             transform_test=cfg.transform_test, use_validation=False, seed=1,
                             synthetic_n_train=HE_TIME_TRAIN, synthetic_n_test=HE_TIME_TEST)
    train = splits["train"]
    hyp = time_script.normalize_burnin(method, time_script.load_method_hyp(None, method), 3)
    build = models.dropout_twin("MLP200MNIST") if method == "MCdropout" else cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler = inference.get_inference(method)(hyperparameters=hyp, model=build.build(c),
                                              train=train, seed=1, device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    epochs, run_epoch = [], sampler._run_epoch

    def timed_epoch(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = run_epoch(*args, **kw)
        torch.cuda.synchronize()
        epochs.append(time.perf_counter() - t)
        return loss

    sampler._run_epoch = timed_epoch
    t0 = time.perf_counter()
    ens = sampler.sample()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    want = 3 if method == "MCdropout" else 1  # epochs, and members
    check(len(epochs) == want and ens.num_members == want,
          f"cli time split: {method} trained {len(epochs)} epochs, {ens.num_members} members")
    steps = len(epochs) * train.num_batches
    print(f"    {method} split: set-up {setup:.3f} s, {len(epochs)} epoch(s) of "
          f"{train.num_batches} steps ({steps} steps) {sum(epochs):.3f} s "
          f"({', '.join(f'{e:.3f}' for e in epochs)}), harvest {total - sum(epochs):.3f} s; "
          "the torch-CPU baseline trains no step", flush=True)
    return {"setup_s": setup, "epochs_s": epochs, "harvest_s": total - sum(epochs),
            "steps": steps}


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
    prog = sampler._program
    sampler.train = stream  # the split is taken at each call: the program stays
    check(sampler.step_program == "graph" and prog.path == "graph" and prog.captures == 1
          and sampler.epoch_program() is prog,
          f"a streamed sampler's step_program {sampler.step_program}, its program "
          f"{prog.path} with {prog.captures} captures")
    return sampler, stream, checked.checked


def _stream_pair(sampler, stream) -> dict:
    """One epoch of a streamed ``sampler`` through its program, then, from a
    snapshot of the state before it, one through ``stream_steps`` on a
    second split of the same seed at the same epoch: each timed
    (``_path_epoch``) with its stream's counters, and the largest difference
    of the two states after them."""
    from ursabench_tpu_torch.data.native import HostStreamingSplit

    twin = HostStreamingSplit(stream.images, stream.labels, stream.batch_size, stream.spec,
                              seed=stream.seed, chunk_batches=stream.chunk_batches)
    twin.epochs_started = stream.epochs_started
    snap = _snapshot(sampler)
    runs = {}
    for path, split in (("graph", stream), ("eager", twin)):
        _restore(sampler, snap)
        sampler.train = split
        before = dict(split.stats)
        runs[path] = _path_epoch(sampler, path)
        runs[path]["stats"] = {k: v - before[k] for k, v in split.stats.items()}
    sampler.train = stream
    runs["max_abs_diff"] = _max_diff(runs["graph"].pop("state"), runs["eager"].pop("state"))
    return runs


def _busy_stream_sampler(device, train, chunk):
    """SGHMC on PreResNet-20 over a uint8 stream of ``train``'s first 2,048
    images (16 steps, ``chunk`` batches a transfer), for ``_busy_shares``."""
    from ursabench_tpu_torch import inference, models
    from ursabench_tpu_torch.data.native import HostStreamingSplit

    n = 16 * BATCH
    stream = HostStreamingSplit(train.images[:n], train.labels[:n], BATCH, train.spec, seed=1,
                                chunk_batches=chunk)
    return inference.SGHMC(HYP, model=models.get_model("PreResNet20").build(10), train=stream,
                           seed=1, device=device)


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
    chain): resident, streamed (M=1) and chunked (M=16), each through its
    program: a warm-up epoch each (the capture; every streamed transfer
    checked byte for byte), then one timed graphed epoch each in the order
    ``ST_ORDER``, a streamed one followed by an epoch through
    ``stream_steps`` from the same state on a second split of the same seed
    (``_stream_pair``); each streamed program captured once across its
    epochs. Then, over streams of 2,048 images: a streamed and a chunked
    program built and captured under deterministic cuDNN, each epoch
    bit-equal to ``stream_steps``' from the same state (required), and the
    busy share of a streamed and a chunked step, graphed and eager, in the
    default mode; float32-mode batches against gather_normalize."""
    from ursabench_tpu_torch import inference, models
    from ursabench_tpu_torch.data import native
    from ursabench_tpu_torch.inference.engine import STREAM_AHEAD
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    train = splits["train"]
    cfg = models.get_model("PreResNet20")
    sghmc_update_flat.launches = 0
    resident = inference.SGHMC(HYP, model=cfg.build(10), train=train, seed=0, device=device)
    resident._run_epoch()
    modes = {"resident": (resident, None, 0)}
    for name, chunk in (("streamed", 1), ("chunked", STREAM_CHUNK)):
        modes[name] = _stream_sampler(device, train, cfg.build(10), chunk)
    runs = {}
    for name in ST_ORDER:
        sampler, stream, _ = modes[name]
        runs[name] = ({"graph": _path_epoch(sampler, "graph")} if stream is None
                      else _stream_pair(sampler, stream))
    small = {"streamed": 1, "chunked": STREAM_CHUNK}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:  # programs captured in that mode, their first epoch against stream_steps'
        det = {}
        for name, chunk in small.items():
            s = _busy_stream_sampler(device, train, chunk)
            det[name] = _stream_pair(s, s.train)["max_abs_diff"]
            check(det[name] == 0.0 and s._program.captures == 1,
                  f"stream (a) {name}: the graphed epoch differs from stream_steps' by "
                  f"{det[name]:.3g} under deterministic cuDNN ({s._program.captures} captures)")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    busy = {name: _busy_shares(device, _busy_stream_sampler(device, train, chunk))
            for name, chunk in small.items()}
    # the warm-up and the graphed epoch of each mode, the streamed modes' eager twin
    epochs = {"resident": 2, "streamed": 3, "chunked": 3}
    steps = sum(epochs[k] * m[0].train.num_batches for k, m in modes.items())
    steps += sum(2 * 16 + b["steps_run"] for b in busy.values())
    launches = sghmc_update_flat.launches
    check(launches == steps, f"stream (a): K1 launched {launches} times for {steps} steps")
    out = {"launches": launches}
    for name, (sampler, stream, checked) in modes.items():
        losses = [float(v) for v in sampler.epoch_losses]
        check(len(losses) == epochs[name] and all(map(math.isfinite, losses)),
              f"{name}: losses {losses}")
        nb, prog, r = sampler.train.num_batches, sampler._program, runs[name]
        check(prog.path == "graph" and prog.captures == 1,
              f"stream (a) {name}: the program ran {prog.path} with {prog.captures} captures")
        row = {"steps": nb, "checked_transfers": checked, "losses": losses,
               "captures": prog.captures, "capture_ms": prog.capture_ms,
               "pool_bytes": prog.pool_bytes}
        for path in ("graph", "eager"):
            if path in r:
                row[path] = {"steps_per_sec": nb / r[path]["wall_s"],
                             "call_us_per_step": r[path]["host_s"] / nb * 1e6,
                             "stats": r[path].get("stats")}
        row["graph"]["replay_gap_us"] = r["graph"]["replay_gap_us"]
        out[name] = row
        if stream is None:
            continue
        row.update(default_max_abs_diff=r["max_abs_diff"], deterministic_max_abs_diff=det[name],
                   busy=busy[name])
        g, e, b = row["graph"], row["eager"], busy[name]
        print(f"  {name} (M={stream.chunk_batches}): graphed {g['steps_per_sec']:.1f} steps/s, "
              f"stream_steps {e['steps_per_sec']:.1f} ({g['steps_per_sec'] / e['steps_per_sec']:.2f}x"
              f") over {nb} steps from one state and one stream epoch (largest difference "
              f"{r['max_abs_diff']:.3g}; 0 under deterministic cuDNN over 16 steps); host us a "
              f"step: graphed {g['replay_gap_us'][0]:.1f} between replays (median "
              f"{g['replay_gap_us'][1]:.1f}, the host at most {STREAM_AHEAD} transfers ahead; the "
              f"call {g['call_us_per_step']:.1f}), stream_steps {e['call_us_per_step']:.1f}; one "
              f"capture ({prog.capture_ms:.1f} ms, a pool of {prog.pool_bytes / 1e6:.1f} MB) "
              f"across {len(losses)} epochs and a swapped split; 16-step epochs (graphed / eager): "
              f"{b['graph']['untraced_ms_per_step']:.3f} / {b['eager']['untraced_ms_per_step']:.3f}"
              f" ms a step untraced, busy {b['graph']['busy_pct']:.1f}% / "
              f"{b['eager']['busy_pct']:.1f}%; {checked} transfers of the warm-up epoch "
              f"byte-equal to the host's gather; graphed: {_stream_line(g['stats'], nb)}",
              flush=True)
    res = out["resident"]["graph"]["steps_per_sec"]
    for name in ("streamed", "chunked"):
        out[f"{name}_pct_of_in_hbm"] = 100 * out[name]["graph"]["steps_per_sec"] / res
        out[f"{name}_eager_pct_of_in_hbm"] = 100 * out[name]["eager"]["steps_per_sec"] / res

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
    print(f"  PreResNet-20 / CIFAR-10 bs{BATCH} fp32 SGHMC, graphed steps/s in the order "
          f"{' '.join(name[0].upper() for name in ST_ORDER)}: resident {res:.1f}, streamed "
          f"{out['streamed']['graph']['steps_per_sec']:.1f}, chunked (M={STREAM_CHUNK}) "
          f"{out['chunked']['graph']['steps_per_sec']:.1f}; streamed_pct_of_in_hbm "
          f"{out['streamed_pct_of_in_hbm']:.1f}, chunked {out['chunked_pct_of_in_hbm']:.1f} "
          f"(stream_steps: {out['streamed_eager_pct_of_in_hbm']:.1f}, "
          f"{out['chunked_eager_pct_of_in_hbm']:.1f}); K1 {launches} launches = {steps} "
          "steps; 3 float32-mode batches equal to gather_normalize", flush=True)
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
    prog = sampler._program
    check(prog.path == "graph" and prog.captures == 1,
          f"stream (b): the program ran {prog.path} with {prog.captures} captures")
    captures, pool_bytes = prog.captures, prog.pool_bytes
    capture = f"one capture ({prog.capture_ms:.1f} ms, a pool of {pool_bytes / 1e9:.2f} GB)"
    losses = [float(v) for v in sampler.epoch_losses]
    check(len(losses) == 3 and all(map(math.isfinite, losses)), f"stream (b): losses {losses}")
    times = device_times(prof)
    copy_us = sum(us for k, (_, us) in times.items() if k.startswith("Memcpy HtoD"))
    kernel_us = sum(us for k, (_, us) in times.items() if not k.startswith("Mem"))
    busy = kernel_us / 1e3 / steps / ms * 100
    slot_bytes = delta["bytes"] / delta["transfers"]
    prof_gbs = slot_bytes * steps / copy_us / 1e3 if copy_us else float("nan")
    del sampler, stream, train, images, prog
    os.remove(path)
    out = {"n": ST_IMAGENET_N, "steps": steps, "steps_per_sec": 1e3 / ms,
           "resident_steps_per_sec": resident_sps, "pct_of_resident": 1e3 / ms / resident_sps * 100,
           "stats": delta, "device_busy_pct": busy,
           "kernel_ms_per_step": kernel_us / 1e3 / steps, "copy_ms_per_step": copy_us / 1e3 / steps,
           "profiled_h2d_gb_per_s": prof_gbs,
           "losses": losses, "launches": launches, "memmap_seconds": data_s,
           "captures": captures, "pool_bytes": pool_bytes}
    print(f"  TVResNet-50 bf16 224^2 bs{BATCH} SGHMC from a {ST_IMAGENET_N}-image uint8 memmap: "
          f"streamed, graphed ({capture}), {1e3 / ms:.2f} steps/s beside the resident slice's "
          f"{resident_sps:.2f} "
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
    """(d) PreResNet-20, S=6, batch 128: the fp32 BMA engine exported,
    saved, loaded and held against the eager engine (bf16's export is
    checked on the CPU, by tests/test_torch_export.py)."""
    from ursabench_tpu_torch.profiling import export as E
    from ursabench_tpu_torch.profiling import latency as L
    from ursabench_tpu_torch.profiling.hw import event_ms

    ens = L.random_ensemble("PreResNet20", 10, LATENCY_S, device)
    out = {}
    for prec, tol in (("fp32", 1e-5),):
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
    check(s.step_program == "graph", f"chains: step_program {s.step_program}")
    return s


def _ch_epoch(sampler, launches: list, eager: bool = False) -> float:
    """ms of one epoch of ``sampler`` (CUDA events), graphed or, with
    ``eager``, step by step; K1's launches in it appended to ``launches``
    and checked against its steps."""
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat
    from ursabench_tpu_torch.profiling.hw import event_ms

    sghmc_update_flat.launches = 0
    ms = event_ms((lambda: _eager_epoch(sampler)) if eager else sampler._run_epoch, 1)
    steps = sampler.train.num_batches
    check(sghmc_update_flat.launches == steps,
          f"chains: K1 launched {sghmc_update_flat.launches} times in an epoch of {steps} "
          f"steps ({sampler._resolved_chain_strategy}, {sampler.chains} chains)")
    launches.append(sghmc_update_flat.launches)
    return ms


def _ch_peak(sampler, launches: list, eager: bool = False):
    """An epoch of ``sampler`` (``_ch_epoch``), graphed or eager: (peak GB
    allocated during it, GB it added over what was allocated before it,
    its ms)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = _ch_epoch(sampler, launches, eager)
    peak = torch.cuda.max_memory_allocated()
    return peak / 1e9, (peak - base) / 1e9, ms


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
    """The timed rows of one model: at each C, a graphed warm-up epoch of
    each strategy (its peak memory), then a graphed epoch and, at a C of
    CH_EAGER_CHAINS, an eager one timed in the turns CH_ORDER (the eager
    one's peak memory too); a C
    whose vmap run would not fit beside what is allocated (C times the
    one-chain vmap epoch's working memory) is skipped."""
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
        samplers, peak, peak_eager = {}, {}, {}
        ms, ms_eager = {"scan": [], "vmap": []}, {"scan": [], "vmap": []}
        try:
            for strategy in ("scan", "vmap"):
                samplers[strategy] = _ch_sampler(device, name, split, c, dtype, chains, strategy)
                peak[strategy] = _ch_peak(samplers[strategy], launches)[:2]
            for strategy in CH_ORDER:
                ms[strategy].append(_ch_epoch(samplers[strategy], launches))
                if chains in CH_EAGER_CHAINS:
                    peak_eager[strategy], _, eager_ms = _ch_peak(samplers[strategy], launches,
                                                                 eager=True)
                    ms_eager[strategy].append(eager_ms)
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
        sf_eager = {k: [chains * steps * 1e3 / v for v in ms_eager[k]] for k in ms_eager}
        mean = {k: sum(v) / len(v) for k, v in sf.items()}
        mean_eager = {k: sum(v) / len(v) if v else float("nan") for k, v in sf_eager.items()}
        rows.append({"model": name, "dtype": dtype, "chains": chains, "steps": steps,
                     "images": n, "ms": ms, "step_forwards_per_s": sf,
                     "per_chain": {k: v / chains for k, v in mean.items()},
                     "vmap_over_scan": mean["vmap"] / mean["scan"],
                     "peak_gb": {k: v[0] for k, v in peak.items()},
                     "epoch_gb": {k: v[1] for k, v in peak.items()},
                     "ms_eager": ms_eager, "step_forwards_per_s_eager": sf_eager,
                     "vmap_over_scan_eager": mean_eager["vmap"] / mean_eager["scan"],
                     "graph_over_eager": {k: mean[k] / mean_eager[k] for k in mean},
                     "peak_gb_eager": peak_eager,
                     "pool_gb": {k: v._program.pool_bytes / 1e9 for k, v in samplers.items()}})
        del samplers
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def _ch_hmc(device) -> dict:
    """HMC x CH_ROWS chains on MLP200MNIST over 10,240 images, in the turns
    CH_ORDER from the same seed after ``_warm_hmc`` (the captures, untimed):
    gradients/s, s a draw, the accept rate;
    vmap's draws against scan's (the same accepts); each strategy's
    potentials through its programs (the chains in turn share one; one
    batched program under vmap), one capture each."""
    from ursabench_tpu_torch import inference, models

    split, c = _ch_split("MLP200MNIST", "MNIST", 10240)
    hmcs = {k: inference.HMC(CH_HMC, model=models.get_model("MLP200MNIST").build(c),
                             train=split, seed=1, device=device, chains=CH_ROWS,
                             chain_strategy=k) for k in ("scan", "vmap")}
    secs, runs = {"scan": [], "vmap": []}, {}
    for h in hmcs.values():
        _warm_hmc(h)
    for k in CH_ORDER:
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
            "accept_rate": runs["scan"][1], "rel_diff": worst,
            "programs": {k: _program_stats(f"chains: HMC {k}", h) for k, h in hmcs.items()}}


def _ch_pca(device) -> dict:
    """PCA-ESS x CH_ROWS chains on PreResNet-20 over 2,048 images: the SWA
    phase and a first draw, then one check draw in turn and in lock step from
    the same state and streams (the same points and bracket counts), then
    draws timed in the turns CH_ORDER (in turn, lock step); every density
    through its program, one capture each across the draws (``lnpdf``'s and
    one a row count of ``lnpdf_chains``)."""
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
    for k in CH_ORDER:
        pca._resolved_chain_strategy = k
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca.sample_iterative(update_bn=False)
        torch.cuda.synchronize()
        secs[k].append(time.perf_counter() - t0)
        props[k].append(pca.bracket_iters[-1])
    return {"s_per_draw": secs, "proposals": props, "check_brackets": check_draw["scan"][1],
            "rel_diff": worst, "programs": _program_stats("chains: PCA-ESS", pca)}


def _ch_sweep(device, launches: list) -> dict:
    """MethodSweep of CH_ROWS SGHMC configs (lr CH_SWEEP_LR) on PreResNet-20
    over 2,048 images: a warm-up epoch of each strategy, then epochs timed
    in the turns CH_ORDER; sweep step-forwards/s."""
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
    for k in CH_ORDER:
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
    print(f"  chains table (SGHMC, batch 128, step_program graph, one graphed epoch a run and "
          f"an eager one at C in {CH_EAGER_CHAINS}, turns {' '.join(CH_ORDER)}; "
          "step-forwards/s aggregate, per chain, "
          "vmap/scan, graphed/eager, peak GB allocated, the graph's pool):", flush=True)
    for r in out["rows"]:
        if r.get("skipped"):
            continue
        sf, se, ge = r["step_forwards_per_s"], r["step_forwards_per_s_eager"], r["graph_over_eager"]
        eager = (f"eager scan {fmt(se['scan'])}, vmap {fmt(se['vmap'])}; " if se["scan"]
                 else "eager not timed at this C; ")
        ratios = (f"vmap/scan {r['vmap_over_scan']:.3f} graphed, "
                  f"{r['vmap_over_scan_eager']:.3f} eager; graphed/eager scan {ge['scan']:.3f}, "
                  f"vmap {ge['vmap']:.3f}; " if se["scan"]
                  else f"vmap/scan {r['vmap_over_scan']:.3f} graphed; ")
        eager_peak = (f", {r['peak_gb_eager']['scan']:.2f} / {r['peak_gb_eager']['vmap']:.2f} "
                      "eager" if se["scan"] else "")
        print(f"    {r['model']} {r['dtype']} C={r['chains']} ({r['steps']} steps of "
              f"{r['images']} images): graphed scan {fmt(sf['scan'])}, vmap {fmt(sf['vmap'])}; "
              f"{eager}per chain (graphed) "
              f"{r['per_chain']['scan']:.1f} / {r['per_chain']['vmap']:.1f}; {ratios}peak "
              f"{r['peak_gb']['scan']:.2f} / {r['peak_gb']['vmap']:.2f} GB graphed (the epoch's "
              f"own {r['epoch_gb']['scan']:.2f} / {r['epoch_gb']['vmap']:.2f}){eager_peak}; the "
              f"graph's pool {r['pool_gb']['scan']:.2f} / {r['pool_gb']['vmap']:.2f} GB",
              flush=True)
    h, p, w = out["hmc"], out["pca"], out["sweep"]
    print(f"    HMC MLP200MNIST x{CH_ROWS} chains, 10,240 images, L {CH_HMC['L']}: gradients/s "
          f"scan {fmt(h['grads_per_s']['scan'])}, vmap {fmt(h['grads_per_s']['vmap'])}; s a "
          f"draw scan {fmt(h['s_per_draw']['scan'], 4)}, vmap {fmt(h['s_per_draw']['vmap'], 4)}; "
          f"accept rate {h['accept_rate']:.3f} (both); draws {h['rel_diff']:.2e} apart; "
          f"programs: " + "; ".join(f"{k} {_program_line(v)}" for k, v in h["programs"].items()),
          flush=True)
    print(f"    PCA-ESS PreResNet-20 x{CH_ROWS} chains, 2,048 images: s a draw in turn "
          f"{fmt(p['s_per_draw']['scan'], 3)}, lock step {fmt(p['s_per_draw']['vmap'], 3)}; "
          f"proposals a draw by chain {p['proposals']['scan']} / {p['proposals']['vmap']}; "
          f"check draw: brackets {p['check_brackets']} in both, points {p['rel_diff']:.2e} "
          f"apart; programs by row count (None: lnpdf): {_program_line(p['programs'])}",
          flush=True)
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


def _mesh_work(device, chain_mesh, data_mesh, tmp: str) -> dict:
    """What the mesh phase runs on a rank, or in one process with both
    meshes None: PreResNet-20 SGHMC x2 chains (one draw after one epoch)
    and its Prediction, sharded and gathered; MLP200MNIST SGHMC x1 chain;
    HMC on MLP200MNIST; one HMC and one PCA-ESS chain replicated over the
    chain mesh; PreResNet-20 SGHMC x2 checkpointed and resumed;
    on the ranks, PCA-ESS and the streamed epochs over the data mesh. K1's
    launches are counted."""
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
    out["resume"] = _mesh_resume(device, splits["train"], c, chain_mesh, tmp)
    mnist, c = data.loaders("MNIST", None, batch_size=BATCH, use_validation=False,
                            synthetic_n_train=MESH_MLP_TRAIN, synthetic_n_test=BATCH)
    m = inference.SGHMC(MESH_HYP, model=models.get_model("MLP200MNIST").build(c),
                        train=mnist["train"], seed=1, device=device, mesh=data_mesh)
    m.sample()
    out["mlp"] = m._state.params.cpu()
    out["hmc"] = _mesh_hmc(device, mnist["train"], c, chain_mesh, data_mesh)
    out["replicated"] = _mesh_replicated(device, mnist["train"], c, chain_mesh)
    if data_mesh is not None:
        out["pca"] = _mesh_pca(device, data_mesh)
        out["stream"] = _mesh_stream(device, data_mesh)
        out["twins"] = _mesh_twins(device, chain_mesh, data_mesh)
    _sync(device)
    out.update(k1=sghmc_update_flat.launches, seconds=time.perf_counter() - t0)
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _flat_members(ens) -> torch.Tensor:
    """An ensemble's members (gathered) as the rows of one float64 matrix."""
    state = ens.gather().state
    n = next(iter(state.values())).shape[0]
    return torch.cat([v.reshape(n, -1).double().cpu() for v in state.values()], 1)


def _mesh_hmc(device, train, c, chain_mesh, data_mesh) -> dict:
    """HMC on MLP200MNIST: on the data mesh (or one process) one chain's CE
    sum and gradient at its init and its MESH_HMC draws; on the chain mesh
    (or one process) two chains under scan."""
    from ursabench_tpu_torch import inference, models

    def hmc(chains, mesh):
        return inference.HMC(MESH_HMC, model=models.get_model("MLP200MNIST").build(c),
                             train=train, seed=2, chains=chains, device=device,
                             chain_strategy="scan", mesh=mesh)

    from ursabench_tpu_torch.inference.engine import WARMUP_STEPS

    one = hmc(1, data_mesh)
    theta = one._theta0[0].clone()
    ce = one._ce_sum(theta, grad=True)
    out = {"ce": float(ce), "grad": one._grads.detach().cpu().clone(),
           "batches": tuple(one._batches.shape)}
    for _ in range(WARMUP_STEPS + 2):  # its warm-up steps, the capture and a replay
        ce_graph = one._ce(theta, grad=True)
    out["graph_equal"] = (torch.equal(ce_graph, ce)
                          and bool((one._grads.cpu() == out["grad"]).all()))
    out["one_chain"] = _flat_members(one.sample())
    out["programs"] = _captures(one._programs)
    two = hmc(2, chain_mesh)
    out["two_chains"] = _flat_members(two.sample())
    out["accept"] = (one.accept_rate, two.accept_rate)
    return out


def _captures(programs: dict) -> dict:
    """Each program's (path, captures, steps run, segments), by key."""
    return {str(k): (p.path, p.captures, p.steps_run, p.segments) for k, p in programs.items()}


def _captured_once(programs: dict) -> bool:
    """Whether every program of ``_captures`` is graphed and captured once,
    or not at all where it ran no more than its warm-up steps."""
    from ursabench_tpu_torch.inference.engine import WARMUP_STEPS

    return all(path == "graph" and captures == int(steps > WARMUP_STEPS)
               for path, captures, steps, _ in programs.values())


def _mesh_replicated(device, train, c, chain_mesh) -> dict:
    """One HMC chain and one PCA-ESS chain on MLP200MNIST on the chain mesh
    (or in one process), whose chain axis does not divide them: both ranks
    hold the whole chain, as the JAX package runs one chain unplaced."""
    from ursabench_tpu_torch import inference, models

    hmc = inference.HMC(MESH_HMC, model=models.get_model("MLP200MNIST").build(c), train=train,
                        seed=5, device=device, mesh=chain_mesh)
    pca = inference.PCASubspaceSampler(MESH_PCA, model=models.get_model("MLP200MNIST").build(c),
                                       train=train, seed=6, device=device, mesh=chain_mesh)
    return {"flags": (hmc.replicated, pca.replicated, list(hmc.chain_ids)),
            "hmc": _flat_members(hmc.sample()), "hmc_accept": hmc.accept_rate,
            "pca": _flat_members(pca.sample()), "pca_theta": pca.current_theta.cpu()}


@torch.no_grad()
def _local_bn_lnpdf(sampler, theta, halves: int) -> float:
    """The PCA-ESS log density of ``sampler`` at ``theta`` with each batch
    split in ``halves`` by hand, on this process alone: each part's
    train-mode forward with its own batch statistics, the cross entropy
    masked as the sampler masks it (the oracle of a data mesh's local
    BatchNorm)."""
    import torch.nn.functional as F

    from ursabench_tpu_torch.data.transforms import normalize
    from ursabench_tpu_torch.inference.engine import _sharded_batches

    swa, train = sampler.swa, sampler.train
    module = swa._eval_module
    swa._eval_params.copy_(sampler.subspace(theta))
    module.train()
    batches = _sharded_batches(train.n, train.batch_size, None, swa._images.device)
    part = train.batch_size // halves
    total = torch.zeros((), dtype=torch.float64, device=swa._images.device)
    for b in batches:
        valid, b = (b >= 0).to(torch.float32), b.clamp_min(0)
        for h in range(halves):
            rows = slice(h * part, (h + 1) * part)
            x = normalize(swa._images.index_select(0, b[rows]), train.spec)
            ce = F.cross_entropy(module(x.permute(0, 3, 1, 2).contiguous()).float(),
                                 swa._labels.index_select(0, b[rows]), reduction="none")
            total += torch.sum(ce * valid[rows]).double()
    return float(-total / sampler.temperature)


def _mesh_pca(device, data_mesh) -> dict:
    """PCA-ESS on PreResNet-20 over MESH_PCA_TRAIN CIFAR-10 images on the
    data mesh: the SWA phase data-parallel, MESH_PCA's draws, the log
    density at the last draw against the local-BN oracle, Prediction."""
    from ursabench_tpu_torch import data, inference, models
    from ursabench_tpu_torch.data.transforms import CIFAR_TEST, CIFAR_TRAIN

    splits, c = data.loaders("CIFAR10", None, batch_size=BATCH, use_validation=False,
                             transform_train=CIFAR_TRAIN, transform_test=CIFAR_TEST,
                             synthetic_n_train=MESH_PCA_TRAIN, synthetic_n_test=2 * BATCH)
    t0 = time.perf_counter()
    p = inference.PCASubspaceSampler(MESH_PCA, model=models.get_model("PreResNet20").build(c),
                                     train=splits["train"], seed=3, device=device,
                                     mesh=data_mesh)
    ens = p.sample()
    theta = p.current_theta[0]
    got_t = p.lnpdf(theta)
    got = float(got_t)
    graph_equal = torch.equal(got_t, p._plain_lnpdf(theta))
    want = _local_bn_lnpdf(p, theta, data_mesh.shape["data"])
    whole = _local_bn_lnpdf(p, theta, 1)
    programs = {**_captures(p._programs),
                "swa": _captures({"epoch": p.swa._program})["epoch"]}
    return {"lnpdf": got, "oracle": want, "whole": whole, "proposals": p.bracket_iters,
            "graph_equal": graph_equal, "programs": programs,
            "swa_epochs": p.swa.epochs_run, "metrics": _mesh_metrics(ens, splits["test"], c),
            "seconds": time.perf_counter() - t0}


def _mesh_stream(device, data_mesh) -> dict:
    """PreResNet-20 SGHMC over MESH_STREAM_TRAIN CIFAR-10 images on the data
    mesh (crops, flips, the noise on): one epoch streamed from this rank's
    rows per batch and in chunks of STREAM_CHUNK, each against the resident
    sharded epoch driven by the stream's permutation with the same crops,
    flips and noise seeds; each rank's bytes a step."""
    from ursabench_tpu_torch import data, inference, models
    from ursabench_tpu_torch.data import native
    from ursabench_tpu_torch.data.transforms import CIFAR_TRAIN, draw_augment
    from ursabench_tpu_torch.inference import engine

    splits, c = data.loaders("CIFAR10", None, batch_size=BATCH, use_validation=False,
                             transform_train=CIFAR_TRAIN, synthetic_n_train=MESH_STREAM_TRAIN,
                             synthetic_n_test=BATCH)
    train = splits["train"]

    def sampler(split):
        return inference.SGHMC(MESH_HYP, model=models.get_model("PreResNet20").build(c),
                               train=split, seed=4, device=device, mesh=data_mesh)

    b = sampler(train)
    nb = train.n // BATCH
    idx = torch.from_numpy(native.permutation(train.n, 7)).view(nb, BATCH).to(device)
    engine.train_steps(
        b._state, b._images, b._labels, idx, spec=train.spec, epoch=0,
        noise_on=b._noise_gate.fill_(1.0), hyp=b._hyp, lr_fn=b._LR_FN, update_fn=b._UPDATE_FN,
        seeds=torch.randint(0, 2 ** 63 - 1, (nb,), generator=b._noise_gen).tolist(),
        aug=draw_augment(b._data_gens[0], (nb, BATCH), train.spec), mesh=data_mesh)
    want = [b._state.params, b._state.momentum, *b.module.buffers()]
    out = {}
    for m in (1, STREAM_CHUNK):
        runs = {}
        for path in ("graph", "eager"):  # the program, then stream_steps
            stream = native.HostStreamingSplit(train.images, train.labels, BATCH, train.spec,
                                               seed=7, chunk_batches=m, mesh=data_mesh)
            a = sampler(stream)
            if path == "eager":
                a.epoch_program = lambda: None
            _sync(device)
            t0 = time.perf_counter()
            a._run_epoch(noise_on=True)
            _sync(device)
            runs[path] = (a, stream, time.perf_counter() - t0)
        (a, stream, sec), (e, _, _) = runs["graph"], runs["eager"]
        state = [a._state.params, a._state.momentum, *a.module.buffers()]
        out[m] = {"equal": all(torch.equal(x, y) for x, y in zip(state, want)),
                  "eager_equal": all(torch.equal(x, y) for x, y in zip(
                      state, [e._state.params, e._state.momentum, *e.module.buffers()])),
                  "programs": _captures({"stream": a._program}),
                  "bytes_per_step": stream.stats["bytes"] / nb, "steps": nb,
                  "seconds": sec, "params": a._state.params.cpu()}
    out["batch_bytes"] = BATCH * (int(np.prod(train.images.shape[1:])) + 4)
    return out


def _mesh_twins(device, chain_mesh, data_mesh) -> dict:
    """On a rank: PreResNet-20 SGHMC over MESH_TWIN_TRAIN CIFAR-10 images
    (crops, flips, the noise on) on the chain mesh (x2 chains, one a rank)
    and on the data mesh (x1), through its epoch program and through its
    eager twin (``train_steps``, the program hidden), MESH_TWIN_EPOCHS
    epochs each from one seed: bit for bit under deterministic cuDNN; one
    capture a program; the last epoch's steps/s and its ``dist.all_reduce``
    calls a step."""
    import torch.distributed as dist

    from ursabench_tpu_torch import data, inference, models
    from ursabench_tpu_torch.data.transforms import CIFAR_TRAIN

    splits, c = data.loaders("CIFAR10", None, batch_size=BATCH, use_validation=False,
                             transform_train=CIFAR_TRAIN, synthetic_n_train=MESH_TWIN_TRAIN,
                             synthetic_n_test=BATCH)
    train = splits["train"]
    out = {}
    for name, mesh, chains in (("chain", chain_mesh, 2), ("data", data_mesh, 1)):
        runs = {}
        for path in ("graph", "eager"):
            s = inference.SGHMC(MESH_HYP, model=models.get_model("PreResNet20").build(c),
                                train=train, seed=9, chains=chains, device=device,
                                chain_strategy="scan", mesh=mesh)
            if path == "eager":
                s.epoch_program = lambda: None
            for _ in range(MESH_TWIN_EPOCHS - 1):
                s._run_epoch(noise_on=True)
            calls, all_reduce = [], dist.all_reduce

            def counted(tensor, *a, **kw):
                calls.append(tensor.numel())
                return all_reduce(tensor, *a, **kw)

            dist.all_reduce = counted
            try:
                _sync(device)
                t0 = time.perf_counter()
                s._run_epoch(noise_on=True)
                _sync(device)
                sec = time.perf_counter() - t0
            finally:
                dist.all_reduce = all_reduce
            runs[path] = s
            out.setdefault(name, {})[path] = {
                "steps_per_s": train.num_batches / sec,
                "all_reduces_a_step": len(calls) / train.num_batches}
        g, e = runs["graph"], runs["eager"]
        out[name].update(
            equal=all(torch.equal(x, y) for x, y in zip(
                [g._state.params, g._state.momentum, *g.module.buffers(), *g.epoch_losses],
                [e._state.params, e._state.momentum, *e.module.buffers(), *e.epoch_losses])),
            programs=_captures({"epoch": g._program}), steps=g._state.step,
            step_program=g.step_program)
    return out


def _mesh_resume(device, train, c, chain_mesh, tmp: str) -> dict:
    """PreResNet-20 SGHMC x2 (chain mesh or one process), MESH_CKPT_HYP:
    two draws uninterrupted; one draw (2 epochs) checkpointed every 2
    epochs to ``tmp/ck.npz``, then a new sampler resumed from it and its
    second draw; the file as rank 0 wrote it."""
    from ursabench_tpu_torch import inference, models
    from ursabench_tpu_torch.utils_checkpoint import load_pytree

    def make():
        return inference.SGHMC(MESH_CKPT_HYP, model=models.get_model("PreResNet20").build(c),
                               train=train, seed=6, chains=2, device=device,
                               chain_strategy="scan", mesh=chain_mesh)

    path = f"{tmp}/ck.npz"
    full = make()
    want = [full.sample_iterative() for _ in range(2)][1]
    part = make()
    part.enable_auto_checkpoint(path, 2, resume=False)
    part.sample_iterative()
    res = make()
    resumed = res.enable_auto_checkpoint(path, 2)
    got = res.sample_iterative()
    return {"resumed": resumed and res.epochs_run == 3,
            "equal": all(torch.equal(got[k], want[k]) for k in want),
            "file": load_pytree(path) if chain_mesh is None or chain_mesh.rank == 0 else None}


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
        res = _mesh_work(torch.device("cuda"), chain_mesh, data_mesh, out)
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
    the group made): as it is, with ``--stream``, and twice with
    ``--checkpoint_path`` (the second run resumes)."""
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
        for name, extra in MESH_TORCHRUN.items():
            for _ in range(2 if name == "checkpoint" else 1):
                if cli.main(["run", *MESH_RUN, "--mesh", "auto", *extra, "--save_path",
                             f"{MESH_OUT}/torchrun_{name}"]):
                    return 1
        return 0
    finally:
        dist.destroy_process_group()


def _gloo_world3() -> int:
    """Under torchrun, one of MESH_WORLD3 ranks sharing the card: gloo on
    CUDA tensors (NCCL refuses ranks that share a device; the runner's
    ``initialize()`` then finds the group made), then ``cli run
    --mesh chain --chains 2``, which lays (2, 1) over ranks 0-1 and leaves
    rank 2 idle, each rank saving under its own directory; prints the
    rank's files and K1 launches."""
    import os

    import torch.distributed as dist

    from ursabench_tpu_torch import cli, parallel
    from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat

    torch.backends.cudnn.allow_tf32 = False  # as in main(): the run it is compared with
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.initialize(backend="gloo")
    me = dist.get_rank()
    save = f"{MESH_OUT}/world3_rank{me}"
    os.makedirs(save)
    try:
        code = cli.main(["run", *MESH_RUN3, "--save_path", f"{save}/run"])
        print(json.dumps({"gloo_world3": {
            "rank": me, "world": dist.get_world_size(), "backend": dist.get_backend(),
            "code": code, "files": sorted(os.listdir(save)),
            "k1": sghmc_update_flat.launches}}), flush=True)
        return code
    finally:
        dist.destroy_process_group()


def _torchrun(args: list, nproc: int = 1) -> str:
    """``torchrun --standalone --nproc_per_node nproc args``: its stdout, or
    a failed check."""
    import subprocess

    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", str(nproc), *args], capture_output=True,
                         text=True, timeout=MESH_TIMEOUT)
    check(out.returncode == 0, f"torchrun {args} failed: {out.stderr[-3000:]}")
    return out.stdout


def _rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return _rel(a.double().reshape(-1), b.double().reshape(-1))


def _file_gap(a: dict, b: dict, path: str = "") -> float:
    """The largest relative gap between two checkpoint files' float arrays;
    their keys, shapes and every other array (generators, counters) equal,
    or a failed check."""
    check(sorted(a) == sorted(b), f"mesh: checkpoint keys {sorted(a)} != {sorted(b)}")
    gap = 0.0
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            gap = max(gap, _file_gap(x, y, f"{path}{k}/"))
            continue
        check(x.shape == y.shape and x.dtype == y.dtype, f"mesh: checkpoint {path}{k} differs")
        if x.dtype.kind == "f":
            gap = max(gap, _rel_gap(torch.from_numpy(x), torch.from_numpy(y)))
        else:
            check(np.array_equal(x, y), f"mesh: checkpoint {path}{k} differs")
    return gap


def _mesh_checks(ranks: list, one: dict) -> dict:
    """The two ranks against one process and against each other; returns
    what the phase prints."""
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
    # HMC: the potential on (1, 2), its draws, and two chains on (2, 1)
    h, h1 = [r["hmc"] for r in ranks], one["hmc"]
    ce_gap = abs(h[0]["ce"] - h1["ce"]) / abs(h1["ce"])
    grad_gap = _rel_gap(h[0]["grad"], h1["grad"])
    check(ce_gap <= MESH_POTENTIAL and grad_gap <= MESH_POTENTIAL,
          f"mesh: HMC's potential on (1, 2) {ce_gap:.3g} / gradient {grad_gap:.3g} from one "
          f"process (limit {MESH_POTENTIAL})")
    check(h[0]["batches"] == (1, MESH_MLP_TRAIN // 2) and h1["batches"] == (1, MESH_MLP_TRAIN),
          f"mesh: HMC batches {h[0]['batches']} / {h1['batches']}")
    flags = [[bool((t[i + 1] != t[i]).any()) for i in range(t.shape[0] - 1)]
             for t in (h[0]["one_chain"], h1["one_chain"])]
    check(flags[0] == flags[1] and h[0]["accept"][0] == h1["accept"][0],
          f"mesh: HMC accepts on (1, 2) {flags[0]} vs one process {flags[1]}")
    hmc_gap = float(((h[0]["one_chain"] - h1["one_chain"]).abs()
                     - (1e-5 + 2e-4 * h1["one_chain"].abs())).max())
    check(hmc_gap <= 0 and torch.equal(h[0]["one_chain"], h[1]["one_chain"]),
          f"mesh: HMC draws on (1, 2) outside rtol 2e-4, atol 1e-5 of one process (by "
          f"{hmc_gap:.3g}) or replicas differ")
    hmc2_gap = _rel_gap(h[0]["two_chains"], h1["two_chains"])
    check(hmc2_gap <= MESH_PRR_GAP and h[0]["accept"][1] == h1["accept"][1],
          f"mesh: HMC x2 on (2, 1) {hmc2_gap:.3g} from one process")
    # PCA-ESS on (1, 2) against the local-BN oracle
    pca = ranks[0]["pca"]
    oracle_gap = abs(pca["lnpdf"] - pca["oracle"]) / abs(pca["oracle"])
    check(oracle_gap <= MESH_ORACLE and ranks[1]["pca"]["lnpdf"] == pca["lnpdf"],
          f"mesh: PCA-ESS log density on (1, 2) {pca['lnpdf']} vs local-BN oracle "
          f"{pca['oracle']} ({oracle_gap:.3g})")
    _metrics_finite("mesh PCA-ESS", pca["metrics"])
    # streamed epochs on (1, 2)
    for m in (1, STREAM_CHUNK):
        st = [r["stream"][m] for r in ranks]
        check(all(x["equal"] for x in st) and torch.equal(st[0]["params"], st[1]["params"]),
              f"mesh: streamed epoch (M={m}) on (1, 2) differs from the resident sharded "
              "epoch or between replicas")
        check(all(x["bytes_per_step"] == ranks[0]["stream"]["batch_bytes"] / 2 for x in st),
              f"mesh: streamed bytes a step {[x['bytes_per_step'] for x in st]}, not half a "
              f"batch's {ranks[0]['stream']['batch_bytes']}")
    # every sharded program on the ranks against its eager twin, bit for bit under
    # deterministic cuDNN, captured once; a data mesh's step all-reduces the
    # gradient buffer and one packed float32 buffer between its two replays
    for rank, r in enumerate(ranks):
        for name, segments, calls in (("chain", 1, (0.0, 0.0)), ("data", 2, (2.0, 3.0))):
            t = r["twins"][name]
            check(t["equal"] and t["step_program"] == "graph"
                  and _captured_once(t["programs"])
                  and t["programs"]["epoch"][3] == segments
                  and t["steps"] == MESH_TWIN_EPOCHS * MESH_TWIN_TRAIN // BATCH,
                  f"mesh: rank {rank}'s graphed PreResNet-20 epoch on the {name} mesh against "
                  f"its eager twin: equal {t['equal']}, programs {t['programs']}")
            got = (t["graph"]["all_reduces_a_step"], t["eager"]["all_reduces_a_step"])
            check(got == calls, f"mesh: rank {rank}'s {name} mesh all-reduces a step "
                                f"(graphed, eager) {got}, expected {calls}")
        for m in (1, STREAM_CHUNK):
            st = r["stream"][m]
            check(st["eager_equal"] and _captured_once(st["programs"])
                  and st["programs"]["stream"][3] == 2,
                  f"mesh: rank {rank}'s streamed program (M={m}) against stream_steps: "
                  f"{st['eager_equal']}, {st['programs']}")
        check(r["pca"]["graph_equal"] and _captured_once(r["pca"]["programs"])
              and r["pca"]["programs"]["swa"][3] == 2,
              f"mesh: rank {rank}'s PCA-ESS density program on (1, 2) against _plain_lnpdf: "
              f"{r['pca']['graph_equal']}, {r['pca']['programs']}")
    for r in ranks + [one]:
        check(r["hmc"]["graph_equal"] and _captured_once(r["hmc"]["programs"]),
              f"mesh: HMC's potential program against _ce_sum: {r['hmc']['graph_equal']}, "
              f"{r['hmc']['programs']}")
    # checkpoints on (2, 1)
    for r in ranks + [one]:
        check(r["resume"]["resumed"] and r["resume"]["equal"],
              f"mesh: SGHMC x2 resume {r['resume']['resumed']} / {r['resume']['equal']}")
    file_gap = _file_gap(ranks[0]["resume"]["file"], one["resume"]["file"])
    check(file_gap <= MESH_PRR_GAP, f"mesh: the (2, 1) checkpoint {file_gap:.3g} from one "
                                    "process's")
    # one HMC and one PCA-ESS chain replicated over (2, 1): one process's, bit for bit
    rep = one["replicated"]
    for r in ranks:
        got = r["replicated"]
        check(got["flags"] == (True, True, [0]) and rep["flags"] == (False, False, [0]),
              f"mesh: replicated flags {got['flags']} / {rep['flags']}")
        check(torch.equal(got["hmc"], rep["hmc"]) and got["hmc_accept"] == rep["hmc_accept"],
              f"mesh: HMC x1 on (2, 1) {_rel_gap(got['hmc'], rep['hmc']):.3g} from one "
              f"process, accept {got['hmc_accept']} / {rep['hmc_accept']}")
        check(torch.equal(got["pca"], rep["pca"]) and torch.equal(got["pca_theta"],
                                                                    rep["pca_theta"]),
              f"mesh: PCA-ESS x1 on (2, 1) {_rel_gap(got['pca'], rep['pca']):.3g} from one "
              "process")
    return {"gap": gap, "metrics_max_abs": worst, "hmc_ce_gap": ce_gap,
            "hmc_grad_gap": grad_gap, "hmc_accepts": flags[0],
            "hmc2_gap": hmc2_gap, "pca": {k: pca[k] for k in ("lnpdf", "oracle", "whole",
                                                              "proposals", "seconds")},
            "oracle_gap": oracle_gap, "file_gap": file_gap,
            "replicated_accept": rep["hmc_accept"],
            "twins": [{name: {path: r["twins"][name][path]["steps_per_s"]
                              for path in ("graph", "eager")} for name in ("chain", "data")}
                      for r in ranks],
            "stream": {m: [{k: r["stream"][m][k] for k in ("bytes_per_step", "seconds")}
                           for r in ranks] for m in (1, STREAM_CHUNK)}}


def _world3(runs: list) -> dict:
    """(d) ``_gloo_world3`` under torchrun against ``cli run`` of the same
    arguments in this process (one process: no mesh)."""
    import shutil

    t0 = time.perf_counter()
    for r in range(MESH_WORLD3):
        shutil.rmtree(f"{MESH_OUT}/world3_rank{r}", ignore_errors=True)
    stdout = _torchrun([__file__, "--gloo_world3"], MESH_WORLD3)
    lines = sorted((json.loads(line)["gloo_world3"] for line in stdout.splitlines()
                    if line.startswith('{"gloo_world3"')), key=lambda g: g["rank"])
    check([g["rank"] for g in lines] == list(range(MESH_WORLD3))
          and all(g["code"] == 0 and g["backend"] == "gloo" for g in lines),
          f"mesh: three ranks under torchrun: {lines}")
    check(lines[0]["files"] == ["run_tests.npz", "runresults.csv"]
          and all(g["files"] == [] for g in lines[1:]),
          f"mesh: files written by the three ranks {[g['files'] for g in lines]}")
    check(f"rank {MESH_WORLD3 - 1} idles" in stdout, "mesh: rank 2 did not say it idles")
    steps = 3 * MESH_MLP_TRAIN // BATCH  # 3 epochs, a chain a rank
    check([g["k1"] for g in lines] == [steps, steps, 0],
          f"mesh: K1 launches of the three ranks {[g['k1'] for g in lines]}, expected "
          f"[{steps}, {steps}, 0]")
    world3_s = time.perf_counter() - t0
    _, n = _run_cli(MESH_RUN3 + ["--save_path", f"{MESH_OUT}/world3_one"], runs)
    worst = {}
    with np.load(f"{MESH_OUT}/world3_rank0/run_tests.npz") as f1, \
            np.load(f"{MESH_OUT}/world3_one_tests.npz") as f2:
        check(sorted(f1.files) == sorted(f2.files), "mesh: three ranks' result keys differ")
        for k in f1.files:
            d = float(abs(f1[k] - f2[k]))
            limit = 2e-3 if "model_uncertainty_au" in k else 1e-5 + 2e-4 * abs(float(f2[k]))
            check(np.isfinite(f1[k]).all() and d <= limit,
                  f"mesh: three ranks' {k} {float(f1[k])} vs one process {float(f2[k])}")
            worst[k] = d
    top = max(worst, key=worst.get)
    print(f"  (d) {MESH_WORLD3} ranks sharing the card under torchrun --standalone (gloo on "
          f"CUDA tensors): cli run --mesh chain --chains 2 laid (2, 1) over ranks 0-1, rank 2 "
          f"idle, writing nothing; rank 0's {len(worst)} results within the runner's limits "
          f"of one process's (largest difference {worst[top]:.3g}, {top}; "
          f"{sum(d == 0 for d in worst.values())} equal); K1 "
          f"{[g['k1'] for g in lines]}; {world3_s:.1f} s for the three ranks", flush=True)
    return {"seconds": world3_s, "max_diff": worst[top], "launches": n + 2 * steps,
            "k1": [g["k1"] for g in lines]}


def mesh_phase(device, row_len: int) -> dict:
    """The device mesh on the one card: (a) K1 with a global offset; (b) two
    ranks sharing the card as child processes against one process; (c)
    NCCL at a world size of 1 and the runner under torchrun; (d) the runner
    over a mesh of two of three ranks sharing the card."""
    import glob
    import os

    os.makedirs(f"{MESH_OUT}/one", exist_ok=True)
    out = {"k1": k1_offset_check(device, row_len)}

    torch.cuda.empty_cache()  # room for the two ranks' contexts beside this process
    t0 = time.perf_counter()
    ranks = _two_ranks()
    two_s = time.perf_counter() - t0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = _mesh_work(device, None, None, f"{MESH_OUT}/one")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    got = _mesh_checks(ranks, one)
    steps = MESH_TRAIN // BATCH + MESH_MLP_TRAIN // BATCH
    resume_steps = (3 + 2 + 1) * MESH_TRAIN // BATCH  # uninterrupted, killed, resumed
    # resident; per batch and chunked, each graphed and eager
    stream_steps = 5 * MESH_STREAM_TRAIN // BATCH
    twin_steps = 4 * MESH_TWIN_EPOCHS * MESH_TWIN_TRAIN // BATCH  # 2 meshes, graphed and eager
    want = [steps + resume_steps + stream_steps + twin_steps] * 2 + [steps + resume_steps]
    check([r["k1"] for r in ranks] + [one["k1"]] == want,
          f"mesh: K1 launches {[r['k1'] for r in ranks]} / {one['k1']}, expected {want}")
    pca, st = got["pca"], got["stream"]
    print(f"  (b) two processes sharing one card ({ranks[0]['backend']} on CUDA tensors: NCCL "
          f"refuses two ranks on one device), {two_s:.1f} s for both ranks (start-up "
          f"included; not a scaling figure), {ranks[0]['seconds']:.1f} / "
          f"{ranks[1]['seconds']:.1f} s of work, one process {one['seconds']:.1f} s: "
          f"PreResNet-20 x2 chains on (2, 1) {got['gap']:.3g} from one process (limit "
          f"{MESH_PRR_GAP}, TF32 off, cudnn deterministic); Prediction sharded vs gathered "
          f"max |d| {got['metrics_max_abs']:.3g}; MLP200MNIST on (1, 2) within rtol 2e-4 / "
          f"atol 1e-5, replicas bit-equal", flush=True)
    print(f"      HMC on MLP200MNIST: (1, 2) potential {got['hmc_ce_gap']:.3g} / gradient "
          f"{got['hmc_grad_gap']:.3g} from one process (limit {MESH_POTENTIAL}), accepts "
          f"{got['hmc_accepts']} as one process's; x2 on (2, 1) {got['hmc2_gap']:.3g} from "
          f"one process. PCA-ESS on PreResNet-20 (1, 2), SWA on the data mesh: log density "
          f"{pca['lnpdf']:.6f} vs the local-BN oracle {pca['oracle']:.6f} "
          f"({got['oracle_gap']:.3g}; whole-batch statistics {pca['whole']:.6f}), proposals "
          f"{pca['proposals']}, {pca['seconds']:.1f} s", flush=True)
    print(f"      streamed PreResNet-20 on (1, 2) bit-equal to the resident sharded epoch, "
          f"replicas bit-equal: bytes a step a rank "
          + ", ".join(f"M={m} {st[m][0]['bytes_per_step']:.0f} / "
                      f"{st[m][1]['bytes_per_step']:.0f} ({st[m][0]['seconds']:.2f} / "
                      f"{st[m][1]['seconds']:.2f} s an epoch of "
                      f"{MESH_STREAM_TRAIN // BATCH} steps)" for m in st)
          + f", half of a batch's {ranks[0]['stream']['batch_bytes']}; SGHMC x2 on (2, 1) "
          f"killed after 2 epochs and resumed bit-equal, its file {got['file_gap']:.3g} from "
          f"one process's; one HMC chain (accept rate {got['replicated_accept']}) and one "
          f"PCA-ESS chain on MLP200MNIST replicated over (2, 1), bit-equal to one process "
          f"on both ranks; K1 {want} launches (ranks, one process)", flush=True)
    rates = "; ".join(
        f"rank {i}: " + ", ".join(f"{name} mesh {t[name]['graph']:.1f} graphed / "
                                  f"{t[name]['eager']:.1f} eager" for name in t)
        for i, t in enumerate(got["twins"]))
    print(f"      sharded programs on both ranks against their eager twins under deterministic "
          f"cuDNN, bit-equal, each captured once: PreResNet-20 SGHMC over "
          f"{MESH_TWIN_TRAIN} images on (2, 1) x2 chains (one graph a step) and (1, 2) x1 (two "
          f"graphs a step, the gradient buffer and one packed float32 buffer all-reduced "
          f"between them: 2 all-reduces a step against the eager step's 3); the streamed "
          f"program (M=1, {STREAM_CHUNK}) against stream_steps; HMC's (1, 2) potential "
          f"program against _ce_sum; PCA-ESS's (1, 2) density program against _plain_lnpdf, "
          f"its SWA through the cut epoch program. Steps/s of the timed epoch "
          f"({MESH_TWIN_TRAIN // BATCH} steps): {rates} (two processes sharing one card, gloo "
          f"syncing the host at each collective: not a scaling figure)", flush=True)
    out["two_ranks"] = {"seconds": two_s, "k1": [r["k1"] for r in ranks] + [one["k1"]],
                        **{k: v for k, v in got.items() if k != "stream"},
                        "stream": got["stream"]}

    t0 = time.perf_counter()
    for stale in glob.glob(f"{MESH_OUT}/torchrun_ck*"):  # the first run must not resume
        os.remove(stale)
    stdout = _torchrun([__file__, "--nccl_world1"])
    lines = [json.loads(line) for line in stdout.splitlines()
             if line.startswith('{"nccl_world1"')]
    check(len(lines) == 1 and lines[0]["nccl_world1"]["backend"] == "nccl"
          and lines[0]["nccl_world1"]["sum"] == [2.5] * 4, f"mesh: NCCL at world 1: {lines}")
    resumed = re.findall(r"resumed chain at epoch \d+", stdout)
    check(len(resumed) == 1, f"mesh: the second --checkpoint_path run printed {resumed}")
    runs: list = []
    launches = 0
    diffs = {}
    for name in ("plain", "stream"):
        _, n = _run_cli(MESH_RUN + MESH_TORCHRUN[name] + ["--save_path",
                                                        f"{MESH_OUT}/{name}"], runs)
        launches += n
        with np.load(f"{MESH_OUT}/torchrun_{name}_tests.npz") as f1, \
                np.load(f"{MESH_OUT}/{name}_tests.npz") as f2:
            keys = sorted(f1.files)
            check(keys == sorted(f2.files), f"mesh: torchrun keys {keys} != {sorted(f2.files)}")
            check(all(np.isfinite(f1[k]).all() for k in keys),
                  f"mesh: torchrun {name} results not finite")
            diffs[name] = max(float(abs(f1[k] - f2[k])) for k in keys)
        check(diffs[name] == 0, f"mesh: cli run {MESH_TORCHRUN[name]} under torchrun differs "
                                f"from a run without it by {diffs[name]:.3g} (one process, "
                                "one card, the same seed)")
    with np.load(f"{MESH_OUT}/torchrun_checkpoint_tests.npz") as f:
        check(all(np.isfinite(f[k]).all() for k in f.files),
              "mesh: torchrun --checkpoint_path results not finite")
    nccl_s = time.perf_counter() - t0
    print(f"  (c) NCCL at world 1 under torchrun --standalone --nproc_per_node 1: all-reduce "
          f"{lines[0]['nccl_world1']}, then cli run --mesh auto in that process group, as it "
          f"is and with --stream: the {len(keys)} result keys and values of runs without it "
          f"(largest differences {diffs}; a world of 1 builds no mesh); with "
          f"--checkpoint_path twice, the second {resumed[0]}; {nccl_s:.1f} s", flush=True)
    out["nccl"] = {"seconds": nccl_s, "keys": len(keys), "max_diff": diffs}
    out["world3"] = _world3(runs)
    launches += out["world3"]["launches"]
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
    import os
    import shutil

    cache = os.path.abspath(SYNTH_CACHE)  # child processes inherit it
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["URSA_SYNTH_CACHE"] = cache

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
    launches, splits, ens, slice_sampler = phase("slice", slice_phase, device)
    program = phase("graph vs eager", program_phase, device, slice_sampler)
    del slice_sampler
    phase("eval graph vs eager", eval_program_phase, device, splits, ens)
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

    # every BMA pass of this process ran its program as a captured graph
    passes = bma_passes()
    check(passes["eager"] == 0 and passes["graph"] > 0, f"BMA passes by path: {passes}")
    print(f"BMA passes in this process by program path: {json.dumps(passes)}", flush=True)
    kernels = [{
        "name": "sghmc_update", "route": "cuda",
        "source": "ursabench_tpu_torch/csrc/sghmc_update.cu",
        "replaces": "benchmarks/pallas_sgmcmc.py:75",
        "launches": (launches + program["launches"] + imagenet["k1_launches"]
                     + samplers["launches"]
                     + experiment["launches"] + hypopt["launches"] + hmc_ess["launches"]
                     + stream["launches"] + chains["launches"] + mesh["launches"]),
        "max_abs_err": max(kernel["max_abs_err"], samplers["k1"]["max_abs_err"]),
        # the graphed epochs, most of these launches, run the entry that reads
        # its seed from device memory; the eager paths the by-value one
        "ms": kernel["dseed_ms"], "by_value_ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"], "library_ms": None,
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
    children = {"--nccl_world1": "_nccl_world1", "--gloo_world3": "_gloo_world3"}
    if len(sys.argv) == 2 and sys.argv[1] in children:  # the mesh phase's torchrun children
        if not torch.cuda.is_available():
            print("FAILED: torch.cuda.is_available() is False", flush=True)
            sys.exit(1)
        sys.exit(globals()[children[sys.argv[1]]]())
    sys.exit(main())
