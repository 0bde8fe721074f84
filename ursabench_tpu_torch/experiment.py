"""The benchmark runner: ``python -m ursabench_tpu_torch.cli run ...``.

Counterpart of ``ursabench_tpu/experiment.py``, with the same flags and
outputs. Validation mode (``--use_val``) samples once, runs Prediction and
appends one CSV row. Test mode runs ``num_trials`` trials, the trial index
seeding each one's sampler: Prediction, the balanced Decision (MNIST,
CIFAR10, CIFAR100) and OOD detection against each pairing
(MNIST <-> FashionMNIST/KMNIST, CIFAR <-> STL10/SVHN); then the mean and
std (ddof 1) over trials, with ``--use_dm_imbalance`` the Decision task
rerun on an imbalanced train set, and a CSV row plus an ``.npz`` of the
results.

``main(argv, device=None)`` runs on ``cuda:<device_num>`` unless the caller
passes a device (the tests pass ``"cpu"``). ``TIMINGS`` holds the seconds of
the last ``main`` call by stage.

Several processes, one a device: ``torchrun --nproc_per_node N -m
ursabench_tpu_torch.cli run ...`` (``parallel.initialize`` joins them; each
rank runs on ``cuda:LOCAL_RANK``). ``--mesh`` then lays the samplers out
over the N ranks as the JAX runner lays them over its devices: ``auto`` a
('chain', 'data') mesh (``parallel.auto_mesh``'s layout), ``chain`` chains
only (``chain_mesh``'s), ``none`` no mesh; with one process every choice
means no mesh and the run is unchanged. The mesh is built once a run and
serves every trial's sampler. Every rank computes every metric; only rank
0 writes the CSV row and the ``.npz``. HMC and the PCA subspace sampler
over a mesh raise ``NotImplementedError`` (ROADMAP.md open item 15c), as do
``--stream`` (15e) and ``--checkpoint_path`` (15f) over one.

``--stream`` keeps the train split on the host and streams it to the
device (``data.native.HostStreamingSplit``, seeded with ``--seed``, M =
``--stream_chunk`` batches a transfer, the tail dropped), for the six
epoch-driven samplers that read the train split only through their epochs;
any other method exits with the JAX runner's message. As there, the
imbalanced Decision rerun trains on its own resident split.

``--checkpoint_path P`` checkpoints every sampler of the run to
``P.seed<seed>.npz`` every ``--checkpoint_every`` epochs (draws, for HMC and
the PCA subspace sampler) and resumes from that file when it exists.
``--pretrained_model_path`` loads a variables file (either package's
``utils_checkpoint.save_variables``) into every chain of an epoch sampler
before it samples, and before a checkpoint is restored, so that a resumed
chain keeps its checkpoint; samplers without a training state refuse it.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import inspect
import json
import time

import numpy as np
import torch

from . import data, inference, models, tasks
from .inference.base import _EpochSampler, resolve_device
from .parallel import Mesh, initialize
from .parallel.distributed import auto_layout, chain_layout, rank, world_size
from .tasks.base import accumulate_split
from .transfer import params_from_jax, params_to_jax
from .util import json_open_from_file
from .utils_checkpoint import load_pytree

OOD_PAIRINGS = {
    "MNIST": ["FashionMNIST", "KMNIST"],
    "CIFAR10": ["STL10", "SVHN"],
    "CIFAR100": ["STL10", "SVHN"],
}
_DECISION_DATASETS = ("MNIST", "CIFAR10", "CIFAR100")

# seconds of the last main() call: "data" (the loaders), "setup" (making the
# samplers), "sample" (their sample()), and per task "<task>_bma" (its BMA
# passes) and "<task>_host" (the rest of its statistics and metrics, on the
# host); "<task>_images" counts the images of its BMA passes
TIMINGS: dict = {}


def build_parser():
    p = argparse.ArgumentParser(description="URSABench benchmark runner (PyTorch)")
    p.add_argument("--dataset", type=str, default="CIFAR10")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--num_trials", type=int, default=1)
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--inference_method", type=str, default="HMC")
    p.add_argument("--hyperparams", type=str, default=None)
    p.add_argument("--hyperparams_path", type=str, default=None)
    p.add_argument("--task", type=str, default="Prediction")
    p.add_argument("--split_classes", type=int, default=None)
    p.add_argument("--validation", type=float, default=0.2)
    p.add_argument("--use_val", action="store_true")
    p.add_argument("--use_dm_imbalance", action="store_true")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--device_num", type=int, default=0, help="runs on cuda:<device_num>")
    p.add_argument("--pretrained_model_path", type=str, default=None)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--chain_strategy", choices=["auto", "scan", "vmap"], default="auto",
                   help="how chains > 1 run on one device: 'scan' in turn, 'vmap' as "
                        "one batched forward and backward; 'auto' picks by the model "
                        "(inference.base.resolve_chain_strategy)")
    p.add_argument("--dtype", type=str, default="fp32", choices=("fp32", "bf16"),
                   help="the model's compute dtype (parameters and metrics stay float32)")
    p.add_argument("--mesh", type=str, default="auto", choices=("auto", "chain", "none"),
                   help="layout over the processes (torchrun): 'auto' = ('chain','data') "
                        "mesh (chains sharded, the other ranks data-parallel), 'chain' = "
                        "chain axis only, 'none' = no mesh; one process needs none")
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="checkpoint each sampler's chain to <path>.seed<seed>.npz and "
                        "resume from it if present")
    p.add_argument("--checkpoint_every", type=int, default=10)
    p.add_argument("--synthetic_n_train", type=int, default=None)
    p.add_argument("--synthetic_n_test", type=int, default=None)
    p.add_argument("--stream", action="store_true",
                   help="train from the host (HostStreamingSplit: the C++ prefetch "
                        "stream, pinned staging slots, an asynchronous copy a batch) "
                        "instead of a train split held on the device")
    p.add_argument("--stream_chunk", type=int, default=1, metavar="M",
                   help="with --stream, move M batches a transfer and train their M "
                        "steps in turn (the epoch's tail beyond whole chunks is dropped)")
    return p


# the samplers whose only reads of the train split are their epochs
_STREAMED_METHODS = {"SGHMC", "SGLD", "cSGHMC", "cSGLD", "SGD", "MCdropout"}


def _stream_split(args, split):
    """The train split as a ``HostStreamingSplit``, or exit for a method
    that needs the whole split on the device."""
    if args.inference_method not in _STREAMED_METHODS:
        raise SystemExit(
            f"--stream supports the epoch-driven samplers {sorted(_STREAMED_METHODS)}; "
            f"{args.inference_method} requires the full train split resident in HBM "
            "(full-batch gradients / train-epoch BN refresh)")
    from .data.native import HostStreamingSplit

    return HostStreamingSplit(split.images, split.labels, batch_size=split.batch_size,
                              spec=split.spec, seed=args.seed,
                              chunk_batches=args.stream_chunk)


def _load_hyp(args):
    if args.hyperparams is not None:
        return json.loads(args.hyperparams)
    if args.hyperparams_path is not None:
        return json_open_from_file(args.hyperparams_path)
    return None


def _mesh_layout(args, n: int):
    """The ``--mesh`` layout ``(chain, data)`` over n ranks, as the JAX
    runner's ``_build_mesh`` lays it over its devices; None with one rank
    or where nothing is sharded."""
    if args.mesh == "none" or n == 1:
        return None
    if args.mesh == "chain":
        chain = chain_layout(args.chains, n)
        return (chain, 1) if chain > 1 else None
    return auto_layout(args.chains, args.batch_size, n)


def _build_mesh(args):
    """The run's ``Mesh`` over the process group's ranks (its process groups
    are made here, once a run), or None; a layout that does not span every
    rank raises ValueError."""
    layout = _mesh_layout(args, world_size())
    return None if layout is None else Mesh(*layout)


def _load_pretrained(sampler, pretrained: dict) -> None:
    """Warm-start every chain of an epoch sampler from flax-layout
    variables; BatchNorm statistics absent from them stay as they are."""
    if not isinstance(sampler, _EpochSampler):
        raise NotImplementedError(
            f"--pretrained_model_path is not supported for {type(sampler).__name__}")
    for module in sampler.modules:
        params_from_jax(module, {**params_to_jax(module), **pretrained})


def _progress(sampler) -> str:
    """Where a resumed chain stands: epochs for an epoch sampler, draws for
    HMC and the PCA subspace sampler, which have no epochs."""
    if isinstance(sampler, _EpochSampler):
        return f"epoch {sampler.epochs_run}"
    return f"draw {sampler.draws_done}"


def _make_sampler(args, hyp, module, train_split, seed, device, mesh=None):
    method = inference.get_inference(args.inference_method)
    if isinstance(method, type) and issubclass(method, inference.MethodSweep):
        raise ValueError(f"{args.inference_method} runs K configurations, not one: "
                         "sweep them with ursabench_tpu_torch.hyperopt "
                         "(vectorized_random_search, batched_bayesopt)")
    kwargs = {}
    sig = inspect.signature(method.__init__).parameters
    if mesh is not None and "mesh" in sig:
        kwargs["mesh"] = mesh
    if "chain_strategy" in sig:
        kwargs["chain_strategy"] = args.chain_strategy
    sampler = method(hyperparameters=hyp, model=module, train=train_split, seed=seed,
                     chains=args.chains, device=device, **kwargs)
    if args.pretrained_model_path is not None:
        _load_pretrained(sampler, load_pytree(args.pretrained_model_path))
    if args.checkpoint_path:
        if sampler.enable_auto_checkpoint(f"{args.checkpoint_path}.seed{seed}.npz",
                                          args.checkpoint_every):
            print(f"resumed chain at {_progress(sampler)}")
    return sampler


def _load_ood(args, cfg):
    out = []
    for d_name in OOD_PAIRINGS.get(args.dataset, []):
        loaders_ood, _ = data.loaders(
            d_name,
            (args.data_path + d_name) if args.data_path else None,
            args.batch_size, args.num_workers,
            transform_train=cfg.transform_train,
            transform_test=cfg.transform_test,
            use_validation=False, val_size=args.validation,
            synthetic_n_train=args.synthetic_n_train,
            synthetic_n_test=args.synthetic_n_test,
        )
        out.append({"data": d_name, "test": loaders_ood["test"]})
    return out


def _add(key: str, value) -> None:
    TIMINGS[key] = TIMINGS.get(key, 0) + value


@contextlib.contextmanager
def _stage(key: str, device: torch.device | None = None):
    """Adds the block's seconds to ``TIMINGS[key]``, after waiting for
    ``device`` if it is a GPU."""
    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    _add(key, time.perf_counter() - t0)


def _sample(args, hyp, module, train_split, seed, device, mesh):
    """A sampler made on ``mesh`` (stage "setup") and run (stage "sample")."""
    with _stage("setup", device):
        sampler = _make_sampler(args, hyp, module, train_split, seed, device, mesh=mesh)
    with _stage("sample", device):
        return sampler.sample()


def _run_task(task, ensemble, **kw):
    """The task's statistics of ``ensemble`` and its metrics; their seconds
    go to TIMINGS, split into the BMA passes and the host work."""
    name = type(task).__name__
    s0, i0, t0 = accumulate_split.seconds, accumulate_split.images, time.perf_counter()
    task.update_statistics(ensemble, output_performance=False, **kw)
    out = task.get_performance_metrics()
    bma = accumulate_split.seconds - s0
    _add(f"{name}_bma", bma)
    _add(f"{name}_host", time.perf_counter() - t0 - bma)
    _add(f"{name}_images", accumulate_split.images - i0)
    return out


def _write_row(args, hyperparameters, values) -> None:
    if rank():
        return
    hyp_values = ([hyperparameters[k] for k in sorted(hyperparameters)]
                  if hyperparameters else [])
    with open((args.save_path or "") + "results.csv", "a+") as f:
        csv.writer(f, dialect="excel").writerow([
            args.dataset, args.model, args.seed, args.inference_method,
            args.task, args.batch_size, *hyp_values, *values,
        ])


def main(argv=None, device=None):
    args = build_parser().parse_args(argv)
    initialize()  # several ranks under torchrun; nothing in one process
    mesh = _build_mesh(args)
    if device is None:
        device = (f"cuda:{args.device_num}" if world_size() == 1
                  else f"cuda:{torch.cuda.current_device()}")
    device = resolve_device(device)
    TIMINGS.clear()
    hyperparams = _load_hyp(args)
    cfg = models.get_model(args.model)
    with _stage("data"):
        loaders, num_classes = data.loaders(
            args.dataset, args.data_path, args.batch_size, args.num_workers,
            transform_train=cfg.transform_train, transform_test=cfg.transform_test,
            shuffle_train=True, use_validation=args.use_val,
            val_size=args.validation, split_classes=args.split_classes,
            seed=args.seed,
            synthetic_n_train=args.synthetic_n_train,
            synthetic_n_test=args.synthetic_n_test,
        )
    train_split, test_split = loaders["train"], loaders["test"]
    if args.stream:
        train_split = _stream_split(args, train_split)
    num_classes = int(num_classes)
    build_kw = {"dtype": torch.bfloat16} if args.dtype == "bf16" else {}
    module = cfg.build(num_classes, **build_kw)
    task_loader = {"in_distribution_test": test_split}

    # ---- validation mode: one CSV row for the sweep
    if args.task == "Prediction" and args.use_val:
        ensemble = _sample(args, hyperparams, module, train_split, args.seed, device, mesh)
        task = tasks.Prediction(task_loader, num_classes, metric_list="ALL")
        perf = _run_task(task, ensemble, smoothing=True)
        _write_row(args, hyperparams, [perf[k] for k in sorted(perf)])
        print(perf)
        return perf

    # ---- test mode
    with _stage("data"):
        ood_list = _load_ood(args, cfg)
    results, temp, cost_list = {}, {}, []
    S = args.num_trials
    for s in range(S):
        print("Prediction:", s)
        ensemble = _sample(args, hyperparams, module, train_split, s, device, mesh)

        task = tasks.Prediction(task_loader, num_classes, metric_list="ALL")
        perf = _run_task(task, ensemble, smoothing=True)

        if not args.use_dm_imbalance and args.dataset in _DECISION_DATASETS:
            print("Running DM task on balanced data:", s)
            dec = tasks.Decision({"decision_data_test": test_split}, num_classes)
            cost_list.append(_run_task(dec, ensemble)["True_Cost"])

        print("OOD:", s)
        for ood in ood_list:
            ood_task = tasks.OODDetection(
                {"in_distribution_test": test_split, "out_distribution_test": ood["test"]},
                num_classes,
            )
            dic = _run_task(ood_task, ensemble)
            for k, v in dic.items():
                temp.setdefault(k + "_" + ood["data"], []).append(v)

        for k in task.required_metric_list:
            temp.setdefault(k, []).append(perf[k])

    for k, vals in temp.items():
        results[k + "_mean"] = float(np.mean(vals))
        results[k + "_std"] = float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0

    if args.use_dm_imbalance and args.dataset in _DECISION_DATASETS:
        cost_list = []
        for s in range(S):
            print("Decision Making SEED:", s)
            with _stage("data"):
                loaders_imb, nc = data.loaders(
                    args.dataset, args.data_path, args.batch_size, args.num_workers,
                    transform_train=cfg.transform_train,
                    transform_test=cfg.transform_test, shuffle_train=True,
                    use_validation=False, val_size=args.validation,
                    split_classes=args.split_classes, imbalance=True, seed=s,
                    synthetic_n_train=args.synthetic_n_train,
                    synthetic_n_test=args.synthetic_n_test,
                )
            ensemble = _sample(args, hyperparams, module, loaders_imb["train"], s, device,
                               mesh)
            dec = tasks.Decision({"decision_data_test": loaders_imb["test"]}, int(nc))
            cost_list.append(_run_task(dec, ensemble)["True_Cost"])

    if cost_list:
        results["cost_mean"] = float(np.mean(cost_list))
        results["cost_std"] = float(np.std(cost_list, ddof=1)) if len(cost_list) > 1 else 0.0

    print(sorted(results.keys()))
    print(results)
    if args.save_path:
        _write_row(args, hyperparams, [results[k] for k in sorted(results)])
        if not rank():
            np.savez(args.save_path + "_tests.npz", **results)
    return results


if __name__ == "__main__":
    main()
