"""Sharded SGHMC over the cards of one host, one process a card (NCCL),
against one process on one card: agreement and rate.

    torchrun --standalone --nproc_per_node 4 -m ursabench_tpu_torch.profiling.mesh_check \\
        [--out FILE]

With N ranks, float32 with TF32 off and cuDNN deterministic, over a full
CIFAR-10 epoch of synthetic images (50,000, batch 128, crop and flip: 391
steps):

1. **chain mesh** (N, 1): SGHMC x N chains of PreResNet-20, one chain a
   rank, one noisy epoch; the gathered chains against the N chains in one
   process on rank 0's card, ||a - b|| / ||b|| (each chain keeps its
   global identity, and K1 draws each rank's block of the noise: 0 is the
   expected gap). Then the rate: N chains on N cards against the N chains
   on one card under ``chain_strategy`` "scan" (rank 0's card) and "vmap"
   (rank 1's, at the same time), aggregate step-forwards/s.
2. **data mesh** (1, N): SGHMC x1 chain of MLP200MNIST over 4,096 MNIST
   images, each batch split over the N ranks, one noisy epoch, against one
   process (rtol 2e-4, atol 1e-5: the all-reduced gradient sums in another
   order), the data ranks' replicas bit-equal; then PreResNet-20's rate on
   (1, N) against one card (BatchNorm local to each rank's rows, so this
   is a rate only).

Every rate is taken in ``REPEATS`` windows of whole epochs, each at least
``WINDOW_S`` seconds long (the epoch count set from an untimed epoch, every
rank's longest), from the host clock around the cards' (and, on a mesh,
every rank's) finish; the result gives each window's rate, their median
and their spread, (max - min) / median.

Rank 0 prints the card line of every rank, one JSON line of the results,
and writes it to ``--out``; exits non-zero if a check fails. Needs the
process group that torchrun's variables describe, of two ranks or more, a
card each.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch
import torch.distributed as dist

HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1, "burn_in_epochs": 0}
BATCH = 128
CIFAR_IMAGES = 50_000  # one CIFAR-10 epoch: 391 steps
MLP_IMAGES = 4096
WINDOW_S = 10.0  # the shortest timed window
REPEATS = 3  # timed windows a rate
CHAIN_GAP = 1e-5  # the chain mesh against one process, ||a - b|| / ||b||


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


def _splits(dataset: str, n: int):
    from .. import data, models

    kw = ({"transform_train": models.get_model("PreResNet20").transform_train}
          if dataset == "CIFAR10" else {})
    return data.loaders(dataset, None, batch_size=BATCH, use_validation=False,
                        synthetic_n_train=n, synthetic_n_test=BATCH, **kw)


def _sampler(device, name, split, classes, chains, mesh, strategy="scan"):
    from .. import inference, models

    return inference.SGHMC(HYP, model=models.get_model(name).build(classes), train=split,
                           seed=0, chains=chains, device=device, chain_strategy=strategy,
                           mesh=mesh)


def _timed_epochs(sampler, epochs: int, group: bool) -> float:
    """Seconds of ``epochs`` noisy epochs of ``sampler``, from the host
    clock around the card's (and, with ``group``, every rank's) finish."""
    torch.cuda.synchronize()
    if group:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(epochs):
        sampler._run_epoch(noise_on=True)
    torch.cuda.synchronize()
    if group:
        dist.barrier()
    return time.perf_counter() - t0


def _rate(sampler, device, group: bool, scale: float) -> dict:
    """``scale`` x epochs a second of ``sampler`` in ``REPEATS`` windows of
    whole epochs, each at least ``WINDOW_S`` long by an untimed first
    epoch (with ``group``, every rank's longest, so all ranks run the same
    count)."""
    first = torch.tensor([_timed_epochs(sampler, 1, group)], device=device)
    if group:
        dist.all_reduce(first, op=dist.ReduceOp.MAX)
    epochs = max(1, math.ceil(WINDOW_S / float(first)))
    rates = [scale * epochs / _timed_epochs(sampler, epochs, group) for _ in range(REPEATS)]
    median = statistics.median(rates)
    return {"epochs_a_window": epochs, "windows": rates, "median": median,
            "spread": (max(rates) - min(rates)) / median}


def run(device) -> dict:
    from .. import parallel
    from .hw import card_line

    world, rank = dist.get_world_size(), dist.get_rank()
    cards = [None] * world
    dist.all_gather_object(cards, card_line())
    out = {"world": world, "backend": dist.get_backend(), "cards": cards,
           "images": CIFAR_IMAGES, "window_s": WINDOW_S, "repeats": REPEATS}
    chain_mesh, data_mesh = parallel.Mesh(world, 1), parallel.Mesh(1, world)

    # 1. the chain mesh: agreement, then N chains on N cards
    splits, c = _splits("CIFAR10", CIFAR_IMAGES)
    steps = splits["train"].num_batches
    s = _sampler(device, "PreResNet20", splits["train"], c, world, chain_mesh)
    s._run_epoch(noise_on=True)
    sharded = chain_mesh.chain_rows(s._state.params)
    out["chain_mesh"] = {"chains": world, "steps": steps,
                         "step_forwards_per_s": _rate(s, device, True, steps * world)}
    del s
    one = {}  # the N chains on one card: "scan" on rank 0's, "vmap" on rank 1's
    if rank == 0:
        ref = _sampler(device, "PreResNet20", splits["train"], c, world, None)
        ref._run_epoch(noise_on=True)
        out["chain_gap"] = _rel(sharded, ref._state.params)
        one["scan"] = _rate(ref, device, False, steps * world)
        del ref
    elif rank == 1:
        ref = _sampler(device, "PreResNet20", splits["train"], c, world, None, "vmap")
        one["vmap"] = _rate(ref, device, False, steps * world)
        del ref
    ones = [None] * world
    dist.all_gather_object(ones, one)
    out["chain_mesh"]["one_card"] = {**ones[0], **ones[1]}

    # 2. the data mesh: agreement on MLP200MNIST, then PreResNet-20's rate
    mnist, cm = _splits("MNIST", MLP_IMAGES)
    m = _sampler(device, "MLP200MNIST", mnist["train"], cm, 1, data_mesh)
    m._run_epoch(noise_on=True)
    params = m._state.params.clone()
    replicas = params.new_zeros((world,) + tuple(params.shape))
    replicas[rank] = params
    data_mesh.all_reduce(replicas, "data")
    out["replicas_equal"] = all(torch.equal(replicas[0], r) for r in replicas)
    p = _sampler(device, "PreResNet20", splits["train"], c, 1, data_mesh)
    out["data_mesh"] = {"steps_per_s": _rate(p, device, True, steps)}
    del p
    if rank == 0:
        ref = _sampler(device, "MLP200MNIST", mnist["train"], cm, 1, None)
        ref._run_epoch(noise_on=True)
        excess = ((params - ref._state.params).abs()
                  - (1e-5 + 2e-4 * ref._state.params.abs())).max()
        out["mlp_within_tolerance"] = bool(excess <= 0)
        out["mlp_gap"] = _rel(params, ref._state.params)
        out["data_mesh"]["one_card"] = _rate(
            _sampler(device, "PreResNet20", splits["train"], c, 1, None), device, False, steps)
    dist.barrier()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the JSON result here (rank 0)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False", flush=True)
        return 1
    from .. import parallel

    parallel.initialize()
    if not dist.is_initialized() or dist.get_world_size() < 2:
        print("FAILED: run under torchrun with two ranks or more", flush=True)
        return 1
    device = torch.device(f"cuda:{torch.cuda.current_device()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        out = run(device)
    finally:
        dist.destroy_process_group()
    if "chain_gap" not in out:
        return 0  # ranks other than 0
    ok = (out["chain_gap"] <= CHAIN_GAP and out["mlp_within_tolerance"]
          and out["replicas_equal"])
    out["ok"] = ok
    for line in out["cards"]:
        print(line, flush=True)
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
