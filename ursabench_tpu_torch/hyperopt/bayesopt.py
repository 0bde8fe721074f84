"""Bayesian optimization over sampler hyperparameters.

Counterpart of ``ursabench_tpu/hyperopt/bayesopt.py``: a GridSearch or
RandomSearch initialisation, then per iteration a GP refit warm-started
from the last one's parameters, the UCB maximum (beta 0.1) as the next
configuration, and its evaluation; a wall-time limit, a stop after
``threshold_evaluations`` evaluations without improvement, and the best
hyperparameters written as JSON on every improvement. Where the GP's
proposal is not finite (a kernel matrix that is not positive definite), a
uniform draw takes its place and the warm start is reset.

The GP lives on ``device`` (the sampler's by default; the card unless the
caller asks for the CPU); the random draws come from a CPU
``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..inference.base import resolve_device
from .gp import GP, init_params, uniform_points
from .search import GridSearch, RandomSearch, _BoundedSearch


def sanitize_targets(y: np.ndarray) -> np.ndarray:
    """Non-finite objectives replaced by (worst finite - spread - 1), so the
    GP sees diverged configurations as very bad rather than NaN."""
    y = np.asarray(y, np.float64)
    finite = np.isfinite(y)
    if finite.all():
        return y
    if not finite.any():
        raise RuntimeError(
            "All hyperopt objectives are non-finite — every evaluated "
            "configuration diverged; widen/lower the search domain."
        )
    lo, hi = y[finite].min(), y[finite].max()
    out = y.copy()
    out[~finite] = lo - (hi - lo) - 1.0
    return out


class BayesOpt(_BoundedSearch):
    def __init__(self, obj_instance, domain, inference, time_limit=float("inf"),
                 N_evaluations=10, init_evaluations=3, threshold_evaluations=70,
                 beta=0.1, optim_kwargs=None, iterative_mode=False, seed=123, device=None):
        super().__init__(obj_instance, domain, inference, iterative_mode, seed)
        self.N = N_evaluations
        self.init_evaluations = init_evaluations
        self.time_limit = time_limit
        self.threshold_evaluations = threshold_evaluations
        self.beta = beta
        self.optim_kwargs = optim_kwargs or {"num_restarts": 20, "raw_samples": 200}
        self.grid_size = [
            init_evaluations if d["type"] in ("continuous", "discrete") else 1
            for d in domain
        ]
        # the GP's device: the one given, else the sampler's, else the card
        self.device = resolve_device(device if device is not None
                                     else getattr(inference, "device", None))

    def run(self, verbose=0, return_all=0, initialisation="GridSearch", save_path=None):
        if initialisation == "GridSearch":
            init_search = GridSearch(self.obj_instance, self.domain, self.inference,
                                     self.grid_size, self.iterative_mode, self.seed)
        elif initialisation == "RandomSearch":
            init_search = RandomSearch(self.obj_instance, self.domain, self.inference,
                                       self.init_evaluations, self.iterative_mode, self.seed)
        else:
            raise NotImplementedError(initialisation)
        if verbose == 1:
            print(f"{initialisation} Initialisation\n")
        _, _, hyp_list, obj_list, pts = init_search.run(verbose=verbose, return_all=True)
        self.time.extend(init_search.time)

        train_x = np.asarray(pts, np.float64).reshape(len(obj_list), -1)
        train_y = np.asarray(obj_list, np.float64)
        bounds = torch.as_tensor(self.bounds, dtype=torch.float32, device=self.device)
        gp_params = init_params(train_x.shape[1], self.device)

        if verbose == 1:
            print("\nBayesOpt\n")

        gen = torch.Generator().manual_seed(int(self.seed))
        max_obj = -float("inf")
        threshold_count = 0
        best_trace = []
        for iteration in range(self.N):
            gp = GP(train_x, sanitize_targets(train_y), p0=gp_params, device=self.device)
            gp_params = gp.params  # the next refit's warm start
            new_x = gp.optimize_ucb(bounds, gen, beta=self.beta,
                                    **self.optim_kwargs).cpu().numpy().astype(np.float64)
            if not np.isfinite(new_x).all():
                # a kernel matrix that is not positive definite: a uniform
                # draw, and the warm start reset
                new_x = uniform_points(bounds, 1, gen)[0].cpu().numpy().astype(np.float64)
                gp_params = init_params(train_x.shape[1], self.device)
            hyp = self._mk_hyp(new_x)
            obj = self.inference_step(hyp, verbose)

            train_x = np.vstack([train_x, new_x])
            train_y = np.append(train_y, obj)
            hyp_list.append(hyp)
            best_trace.append(float(np.max(train_y)))
            if verbose == 1:
                print(f"Iteration {iteration},\nhypers: {hyp}, obj: {obj}")

            if sum(self.time) > self.time_limit:
                print(f"Time Limit Reached after {iteration} iterations.")
                break
            if obj > max_obj:
                max_obj = obj
                threshold_count = 0
                if save_path is not None:
                    with open(save_path + ".json", "w") as f:
                        json.dump(hyp, f)
            else:
                threshold_count += 1
            if threshold_count > self.threshold_evaluations:
                print(f"Ending BO as no improvement in "
                      f"{self.threshold_evaluations} evaluations")
                break

        i = int(np.argmax(train_y))
        best_hyp = hyp_list[i]
        max_obj = float(train_y[i])
        if return_all:
            return best_hyp, max_obj, hyp_list, best_trace
        return best_hyp, max_obj
