"""Sharded SGHMC and HMC over the cards of one host, one process a card
(NCCL), against one process on one card: agreement and rate, each on the
eager path (the programs hidden: ``train_steps`` and the plain potentials,
a step at a time from Python) and through the captured programs.

    torchrun --standalone --nproc_per_node 4 -m ursabench_tpu_torch.profiling.mesh_check \\
        [--out FILE]

With N ranks, float32 with TF32 off and cuDNN deterministic, over a full
CIFAR-10 epoch of synthetic images (50,000, batch 128, crop and flip: 391
steps), each part on both paths (eager, then graphed):

1. **chain mesh** (N, 1): SGHMC x N chains of PreResNet-20, one chain a
   rank, one noisy epoch; the gathered chains against the N chains in one
   process on one card, ||a - b|| / ||b|| (each chain keeps its global
   identity, and K1 draws each rank's block of the noise: 0 is the
   expected gap, and the graphed one must be 0). Then the rate: N chains
   on N cards against the N chains on one card under ``chain_strategy``
   "scan" and "vmap", aggregate step-forwards/s. A rank's graphed step has
   no collective: one graph.
2. **data mesh** (1, N): SGHMC x1 chain of MLP200MNIST over 4,096 MNIST
   images, each batch split over the N ranks, one noisy epoch, against one
   process (rtol 2e-4, atol 1e-5: the all-reduced gradient sums in another
   order), the data ranks' replicas bit-equal, the graphed epoch bit-equal
   to the eager one; then PreResNet-20's rate on (1, N) against one card
   (BatchNorm local to each rank's rows, so this is a rate only). The
   graphed step is two graphs with the all-reduces of the gradient buffer
   and of one packed buffer of the losses and BatchNorm statistics between
   them.
3. **HMC's data-parallel potential** (1, N): MLP200MNIST over 60,000
   MNIST images in gradient batches of 4,096 (4,096 / N rows a rank), the
   CE sum and its gradient at the init against one card's (||a - b|| /
   ||b|| within 1e-5: the all-reduce sums in another order), the graphed
   potential bit-equal to the eager one; then full-batch gradient
   evaluations a second (``HMC._grad_u``: every batch's forward and
   backward, one all-reduce of the CE sum and the gradient) against one
   card.

The one-card rows run at the same time, each on its own rank's card
(``_one_card``). Every rate is taken in ``REPEATS`` windows of whole
epochs, each at least ``WINDOW_S`` seconds long (the epoch count set from
an untimed epoch, every rank's longest on a mesh), from the host clock
around the cards' (and, on a mesh, every rank's) finish; the result gives
each window's rate, their median and their spread, (max - min) / median.

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
HMC_IMAGES = 60_000  # MNIST's train split: 15 gradient batches of 4,096
HMC_HYP = {"step_size": 2e-4, "num_samples": 1, "L": 1, "tau": 100.0, "burn": 0, "mass": 0.19,
           "grad_batch": 4096}
WINDOW_S = 10.0  # the shortest timed window
REPEATS = 3  # timed windows a rate
CHAIN_GAP = 1e-5  # the chain mesh against one process, ||a - b|| / ||b||
POTENTIAL_GAP = 1e-5  # HMC's CE sum and gradient on (1, N) against one card
PATHS = ("eager", "graph")  # the plain step-by-step path (the programs hidden), the programs


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


def _splits(dataset: str, n: int):
    from .. import data, models

    kw = ({"transform_train": models.get_model("PreResNet20").transform_train}
          if dataset == "CIFAR10" else {})
    return data.loaders(dataset, None, batch_size=BATCH, use_validation=False,
                        synthetic_n_train=n, synthetic_n_test=BATCH, **kw)


def _sampler(device, name, split, classes, chains, mesh, strategy="scan", eager=False):
    """SGHMC through its epoch program, or with ``eager`` through
    ``train_steps``, a step at a time from Python (the program hidden: the
    path every mesh took before its programs)."""
    from .. import inference, models

    s = inference.SGHMC(HYP, model=models.get_model(name).build(classes), train=split,
                        seed=0, chains=chains, device=device, chain_strategy=strategy,
                        mesh=mesh)
    if eager:
        s.epoch_program = lambda: None
    return s


def _epoch(sampler):
    """One noisy epoch of ``sampler``: the unit of the samplers' rates."""
    return lambda: sampler._run_epoch(noise_on=True)


def _timed(unit, count: int, group: bool) -> float:
    """Seconds of ``count`` calls of ``unit``, from the host clock around
    the card's (and, with ``group``, every rank's) finish."""
    torch.cuda.synchronize()
    if group:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(count):
        unit()
    torch.cuda.synchronize()
    if group:
        dist.barrier()
    return time.perf_counter() - t0


def _rate(unit, device, group: bool, scale: float) -> dict:
    """``scale`` x calls of ``unit`` a second in ``REPEATS`` windows of
    whole calls, each at least ``WINDOW_S`` long by an untimed first call
    (with ``group``, every rank's longest, so all ranks run the same
    count)."""
    first = torch.tensor([_timed(unit, 1, group)], device=device)
    if group:
        dist.all_reduce(first, op=dist.ReduceOp.MAX)
    count = max(1, math.ceil(WINDOW_S / float(first)))
    rates = [scale * count / _timed(unit, count, group) for _ in range(REPEATS)]
    median = statistics.median(rates)
    return {"calls_a_window": count, "windows": rates, "median": median,
            "spread": (max(rates) - min(rates)) / median}


def _hmc(device, split, classes, mesh, eager=False):
    """HMC through its potential programs, or with ``eager`` through the
    plain potentials (the programs hidden)."""
    from .. import inference, models

    h = inference.HMC(HMC_HYP, model=models.get_model("MLP200MNIST").build(classes),
                      train=split, seed=0, device=device, mesh=mesh)
    if eager:
        h.potential_program = lambda grad, batched: None
    return h


def _one_card(tasks: list, rank: int, world: int) -> dict:
    """The one-card rows, spread over the ranks: rank r runs ``tasks[r::world]``
    (name, fn) on its own card at the same time as the others; every rank's
    results, gathered."""
    mine = {name: fn() for name, fn in tasks[rank::world]}
    every = [None] * world
    dist.all_gather_object(every, mine)
    return {k: v for r in every for k, v in r.items()}


def run(device) -> dict:
    from .. import parallel
    from .hw import card_line

    world, rank = dist.get_world_size(), dist.get_rank()
    cards = [None] * world
    dist.all_gather_object(cards, card_line())
    out = {"world": world, "backend": dist.get_backend(), "cards": cards,
           "images": CIFAR_IMAGES, "window_s": WINDOW_S, "repeats": REPEATS}
    chain_mesh, data_mesh = parallel.Mesh(world, 1), parallel.Mesh(1, world)

    # 1. the chain mesh: agreement, then N chains on N cards, eager and graphed
    splits, c = _splits("CIFAR10", CIFAR_IMAGES)
    steps = splits["train"].num_batches
    sharded = {}
    out["chain_mesh"] = {"chains": world, "steps": steps}
    for path in PATHS:
        s = _sampler(device, "PreResNet20", splits["train"], c, world, chain_mesh,
                     eager=path == "eager")
        s._run_epoch(noise_on=True)
        sharded[path] = chain_mesh.chain_rows(s._state.params)
        rate = _rate(_epoch(s), device, True, steps * world)
        if path == "eager":
            out["chain_mesh"]["step_forwards_per_s"] = rate
        else:
            out["chain_mesh"]["graph"] = {"step_forwards_per_s": rate,
                                          "captures": s._program.captures,
                                          "segments": s._program.segments}
        del s

    def one_chains(strategy, path):  # the N chains on one card; the first epoch's gap
        def fn():
            ref = _sampler(device, "PreResNet20", splits["train"], c, world, None, strategy,
                           eager=path == "eager")
            ref._run_epoch(noise_on=True)
            gap = _rel(sharded[path], ref._state.params) if strategy == "scan" else None
            return {"gap": gap, **_rate(_epoch(ref), device, False, steps * world)}
        return (f"{strategy}_{path}", fn)

    one = _one_card([one_chains(st, path) for st in ("scan", "vmap") for path in PATHS],
                    rank, world)
    out["chain_gap"] = one["scan_eager"].pop("gap")
    out["chain_gap_graph"] = one["scan_graph"].pop("gap")
    for k in ("vmap_eager", "vmap_graph"):
        one[k].pop("gap")
    out["chain_mesh"]["one_card"] = {"scan": one["scan_eager"], "vmap": one["vmap_eager"]}
    out["chain_mesh"]["graph"]["one_card"] = {"scan": one["scan_graph"],
                                              "vmap": one["vmap_graph"]}

    # 2. the data mesh: agreement on MLP200MNIST, then PreResNet-20's rate
    mnist, cm = _splits("MNIST", MLP_IMAGES)
    params = {}
    for path in PATHS:
        m = _sampler(device, "MLP200MNIST", mnist["train"], cm, 1, data_mesh,
                     eager=path == "eager")
        m._run_epoch(noise_on=True)
        params[path] = m._state.params.clone()
        replicas = params[path].new_zeros((world,) + tuple(params[path].shape))
        replicas[rank] = params[path]
        data_mesh.all_reduce(replicas, "data")
        out["replicas_equal" + ("_graph" if path == "graph" else "")] = all(
            torch.equal(replicas[0], r) for r in replicas)
        del m
    out["mlp_graph_equals_eager"] = torch.equal(params["graph"], params["eager"])
    out["data_mesh"] = {}
    for path in PATHS:
        p = _sampler(device, "PreResNet20", splits["train"], c, 1, data_mesh,
                     eager=path == "eager")
        rate = _rate(_epoch(p), device, True, steps)
        if path == "eager":
            out["data_mesh"]["steps_per_s"] = rate
        else:
            out["data_mesh"]["graph"] = {"steps_per_s": rate, "captures": p._program.captures,
                                         "segments": p._program.segments}
        del p
    if rank == 0:
        for path in PATHS:
            ref = _sampler(device, "MLP200MNIST", mnist["train"], cm, 1, None,
                           eager=path == "eager")
            ref._run_epoch(noise_on=True)
            excess = ((params[path] - ref._state.params).abs()
                      - (1e-5 + 2e-4 * ref._state.params.abs())).max()
            suffix = "_graph" if path == "graph" else ""
            out["mlp_within_tolerance" + suffix] = bool(excess <= 0)
            out["mlp_gap" + suffix] = _rel(params[path], ref._state.params)

    def one_data(path):
        return (path, lambda: _rate(_epoch(_sampler(device, "PreResNet20", splits["train"], c,
                                                    1, None, eager=path == "eager")),
                                    device, False, steps))

    one = _one_card([one_data(path) for path in PATHS], rank, world)
    out["data_mesh"]["one_card"] = one["eager"]
    out["data_mesh"]["graph"]["one_card"] = one["graph"]

    # 3. HMC's data-parallel potential: agreement, then gradients a second
    mnist, cm = _splits("MNIST", HMC_IMAGES)
    got = {}
    out["hmc"] = {"images": HMC_IMAGES}
    for path in PATHS:
        h = _hmc(device, mnist["train"], cm, data_mesh, eager=path == "eager")
        theta = h._theta0[0].clone()
        ce, grad = h._grad_u(theta)
        got[path] = ce.clone(), grad.clone()
        rate = _rate(lambda h=h: h._grad_u(theta), device, True, 1)
        out["hmc"]["batches"] = list(h._batches.shape)
        if path == "eager":
            out["hmc"]["gradients_per_s"] = rate
        else:
            prog = h._programs[("grad", False)]
            out["hmc"]["graph"] = {"gradients_per_s": rate, "captures": prog.captures}
        del h
    out["hmc"]["graph_equals_eager"] = all(torch.equal(a, b) for a, b in
                                           zip(got["graph"], got["eager"]))

    def one_hmc(path):
        def fn():
            ref = _hmc(device, mnist["train"], cm, None, eager=path == "eager")
            theta = ref._theta0[0].clone()
            ce1, grad1 = ref._grad_u(theta)
            return {"ce_gap": _rel(got[path][0], ce1), "grad_gap": _rel(got[path][1], grad1),
                    **_rate(lambda: ref._grad_u(theta), device, False, 1)}
        return (path, fn)

    one = _one_card([one_hmc(path) for path in PATHS], rank, world)
    for path in PATHS:
        row = one[path]
        gaps = {k: row.pop(k) for k in ("ce_gap", "grad_gap")}
        if path == "eager":
            out["hmc"].update(gaps, one_card=row)
        else:
            out["hmc"]["graph"].update(gaps, one_card=row)
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
    dist_rank = dist.get_rank()
    try:
        out = run(device)
    finally:
        dist.destroy_process_group()
    if dist_rank != 0:
        return 0
    graph = out["hmc"]["graph"]
    ok = (out["chain_gap"] <= CHAIN_GAP and out["mlp_within_tolerance"]
          and out["replicas_equal"] and out["hmc"]["ce_gap"] <= POTENTIAL_GAP
          and out["hmc"]["grad_gap"] <= POTENTIAL_GAP
          and out["chain_gap_graph"] == 0.0 and out["mlp_within_tolerance_graph"]
          and out["replicas_equal_graph"] and out["mlp_graph_equals_eager"]
          and graph["ce_gap"] <= POTENTIAL_GAP and graph["grad_gap"] <= POTENTIAL_GAP
          and out["hmc"]["graph_equals_eager"]
          and out["chain_mesh"]["graph"]["captures"] == out["data_mesh"]["graph"]["captures"]
          == graph["captures"] == 1)
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
