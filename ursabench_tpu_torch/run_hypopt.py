"""The sequential and parallel hyperparameter-optimization entry points:
``python -m ursabench_tpu_torch.cli hypopt ...`` and ``... hypopt-par ...``.

Counterpart of ``ursabench_tpu/run_hypopt.py``, with the same flags:
``main_seq`` runs BayesOpt (RandomSearch initialisation) over a domain JSON
with the Prediction task's 'll' as the objective, and writes the best
hyperparameters and the evaluations' seconds to ``<save_path>_best.json``;
``main_par`` draws a RandomSearch and runs one ``python -m
ursabench_tpu_torch.experiment`` process per configuration, or with
``--dry_run`` only prints the commands. Both run on the card unless the
caller passes a device (the tests pass ``"cpu"``).
"""

from __future__ import annotations

import argparse
import json
import subprocess

from . import data, hyperopt, inference, models, tasks
from .inference.base import resolve_device
from .util import json_open_from_file


def _common_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="MNIST")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--model", type=str, default="MLP200MNIST")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--inference_method", type=str, default="SGHMC")
    p.add_argument("--task", type=str, default="Prediction")
    p.add_argument("--domain_path", type=str, required=True,
                   help="JSON list of domain dicts")
    p.add_argument("--validation", type=float, default=0.2)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--N_evaluations", type=int, default=10)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--synthetic_n_train", type=int, default=None)
    p.add_argument("--synthetic_n_test", type=int, default=None)
    return p


def _build(args, device):
    cfg = models.get_model(args.model)
    loaders, num_classes = data.loaders(
        args.dataset, args.data_path, args.batch_size,
        transform_train=cfg.transform_train, transform_test=cfg.transform_test,
        use_validation=True, val_size=args.validation, seed=args.seed,
        synthetic_n_train=args.synthetic_n_train,
        synthetic_n_test=args.synthetic_n_test,
    )
    num_classes = int(num_classes)
    module = cfg.build(num_classes)
    sampler = inference.get_inference(args.inference_method)(
        hyperparameters=None, model=module, train=loaders["train"], seed=args.seed,
        device=device,
    )
    # the objective: the Prediction task's 'll'
    task = tasks.get_task(args.task)(
        {"in_distribution_test": loaders["test"]}, num_classes, metric_list=["ll"],
    )
    domain = json_open_from_file(args.domain_path)
    return task, domain, sampler


def main_seq(argv=None, device=None):
    p = _common_parser()
    p.add_argument("--init_evaluations", type=int, default=3)
    p.add_argument("--time_limit", type=float, default=float("inf"))
    args = p.parse_args(argv)
    task, domain, sampler = _build(args, resolve_device(device))
    bo = hyperopt.BayesOpt(
        task, domain, sampler, time_limit=args.time_limit,
        N_evaluations=args.N_evaluations,
        init_evaluations=args.init_evaluations, seed=args.seed,
    )
    best_hyp, max_obj = bo.run(verbose=1, initialisation="RandomSearch",
                               save_path=args.save_path)
    print("Best hyperparameters:", best_hyp, "objective:", max_obj)
    if args.save_path:
        with open(args.save_path + "_best.json", "w") as f:
            json.dump({"best_hyp": best_hyp, "max_obj": float(max_obj),
                       "times": bo.time}, f)
    return best_hyp, max_obj


def main_par(argv=None, device=None):
    p = _common_parser()
    p.add_argument("--dry_run", action="store_true",
                   help="print the command list without launching")
    args = p.parse_args(argv)
    task, domain, sampler = _build(args, resolve_device(device))
    rs = hyperopt.RandomSearch(task, domain, sampler, N_evaluations=args.N_evaluations,
                               seed=args.seed)
    commands = rs.run_parallel(args.dataset, args.data_path, args.model, args.validation,
                               args.inference_method, args.task)
    if args.dry_run:
        for c in commands:
            print(" ".join(c))
        return commands
    for c in commands:
        subprocess.run(c, check=False)
    return commands


if __name__ == "__main__":
    main_seq()
