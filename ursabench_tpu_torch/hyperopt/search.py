"""Hyperparameter search: the base protocol, RandomSearch and GridSearch.

Counterpart of ``ursabench_tpu/hyperopt/search.py``, numpy only and kept
as it is there, so that points, grids and commands are the same: a domain is
a list of {'name', 'type': continuous|discrete|constant, 'domain': (lo, hi)
or a value, 'option': linspace|logspace}; ``inference_step`` is update_hyp
-> task.reset -> timed sample -> update_statistics(output_performance=True);
RandomSearch draws uniformly in the (log-)bounds from numpy's
``default_rng(seed)``; GridSearch takes the product of linspace grids in
search units. ``run_parallel`` builds one ``python -m
ursabench_tpu_torch.experiment`` command per configuration.
"""

from __future__ import annotations

import itertools
import json
import time
from typing import List, Sequence

import numpy as np


class _HypOpt:
    def __init__(self, obj_instance, domain, inference, iterative_mode=False,
                 seed=123):
        self.seed = seed
        self.obj_instance = obj_instance
        self.iterative_mode = iterative_mode
        self.domain = domain
        self.inference = inference
        self.time: List[float] = []

    def inference_step(self, hyp: dict, verbose: int = 0) -> float:
        if not self.time:
            print("Timer Starting")
        self.inference.update_hyp(hyp)
        self.obj_instance.reset()
        t0 = time.perf_counter()
        if self.iterative_mode:
            raise NotImplementedError
        samples = self.inference.sample()
        obj = self.obj_instance.update_statistics(samples, output_performance=True)
        t1 = time.perf_counter()
        self.time.append(t1 - t0)
        obj = float(obj)
        if not np.isfinite(obj):
            # diverged configuration (e.g. too-hot lr -> NaN weights); report
            # -inf so argmax/GP handling can exclude it instead of poisoning
            # the whole search (the reference propagates the NaN)
            print(f"Non-finite objective for hyp {hyp}; treating as -inf")
            obj = float("-inf")
        return obj

    def run(self, verbose=0, return_all=0):
        raise NotImplementedError


def _parse_domain(domain):
    """Returns (names, vary_names, vary_types, vary_options, bounds,
    const_names, const_values). Log-space bounds are stored in log units."""
    names, vary_names, vary_types, vary_options = [], [], [], []
    bounds, const_names, const_values = [], [], []
    for dom in domain:
        names.append(dom["name"])
        if dom["type"] in ("continuous", "discrete"):
            vary_names.append(dom["name"])
            vary_types.append(dom["type"])
            opt = dom.get("option", "linspace")
            vary_options.append(opt)
            lo, hi = dom["domain"]
            if opt == "logspace":
                bounds.append((float(np.log(lo)), float(np.log(hi))))
            elif opt == "linspace":
                bounds.append((float(lo), float(hi)))
            else:
                raise NotImplementedError(opt)
        elif dom["type"] == "constant":
            const_names.append(dom["name"])
            const_values.append(dom["domain"])
        else:
            raise NotImplementedError(dom["type"])
    return (names, vary_names, vary_types, vary_options,
            np.asarray(bounds, np.float64).reshape(-1, 2),
            const_names, const_values)


class _BoundedSearch(_HypOpt):
    def __init__(self, obj_instance, domain, inference, iterative_mode=False,
                 seed=123):
        super().__init__(obj_instance, domain, inference, iterative_mode, seed)
        (self.hyp_names, self.hyp_names_vary, self.param_space_vary_type,
         self.param_space_vary, self.bounds, self.hyp_names_constant,
         self.constants) = _parse_domain(domain)

    def convert_to_param_space(self, x: np.ndarray) -> list:
        """Map a point in search space (log units for logspace dims) to
        parameter space, with discrete dims truncated to int
        (hyper_optimization.py:118-132)."""
        out = []
        for i, opt in enumerate(self.param_space_vary):
            v = float(np.exp(x[i])) if opt == "logspace" else float(x[i])
            if self.param_space_vary_type[i] == "discrete":
                v = int(v) if opt == "logspace" else int(x[i])
            out.append(v)
        return out

    def _mk_hyp(self, x: np.ndarray) -> dict:
        hyp = dict(zip(self.hyp_names_vary, self.convert_to_param_space(x)))
        hyp.update(dict(zip(self.hyp_names_constant, self.constants)))
        return hyp

    def _command_list(self, points: Sequence[np.ndarray], dataset, data_path,
                      model, validation, inference_method, task):
        cmds = []
        for x in points:
            hyp = self._mk_hyp(x)
            cmds.append([
                "python", "-m", "ursabench_tpu_torch.experiment",
                "--hyperparams", json.dumps(hyp),
                "--dataset", dataset, "--data_path", str(data_path),
                "--model", model, "--validation", str(validation),
                "--inference_method", inference_method, "--task", task,
                "--seed", str(self.seed), "--use_val",
            ])
        return cmds


class RandomSearch(_BoundedSearch):
    def __init__(self, obj_instance, domain, inference, N_evaluations=10,
                 iterative_mode=False, seed=123):
        super().__init__(obj_instance, domain, inference, iterative_mode, seed)
        self.N_evaluations = N_evaluations

    def _draw_points(self):
        rng = np.random.default_rng(self.seed)
        u = rng.random((self.N_evaluations, len(self.hyp_names_vary)))
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + (hi - lo) * u

    def run(self, verbose=0, return_all=0):
        pts = self._draw_points()
        objs, hyps = [], []
        for n in range(self.N_evaluations):
            hyp = self._mk_hyp(pts[n])
            obj = self.inference_step(hyp, verbose)
            objs.append(obj)
            hyps.append(hyp)
            if verbose == 1:
                print(f"Iteration {n},\nhypers: {hyp}, obj: {obj}")
        i = int(np.argmax(objs))
        if return_all:
            return hyps[i], objs[i], hyps, objs, pts
        return hyps[i], objs[i]

    def run_parallel(self, dataset, data_path, model, validation,
                     inference_method, task, verbose=1):
        cmds = self._command_list(self._draw_points(), dataset, data_path,
                                  model, validation, inference_method, task)
        if verbose == 1:
            print(f"Sending off {len(cmds)} jobs.")
        return cmds


class GridSearch(_BoundedSearch):
    def __init__(self, obj_instance, domain, inference, grid_size=None,
                 iterative_mode=False, seed=123):
        super().__init__(obj_instance, domain, inference, iterative_mode, seed)
        if grid_size is None:
            raise RuntimeError("grid_size not set")
        if len(grid_size) != len(domain):
            raise RuntimeError(
                f"length of grid_size ({len(grid_size)}) not set to same "
                f"length as domain ({len(domain)})"
            )
        self.grid_size = grid_size
        # per-dim grids in *search space* units (log for logspace dims)
        self.grid_steps = []
        vi = 0
        for dom, k in zip(domain, grid_size):
            if dom["type"] in ("continuous", "discrete"):
                lo, hi = self.bounds[vi]
                self.grid_steps.append(np.linspace(lo, hi, k))
                vi += 1

    def _grid_points(self):
        return [np.asarray(p) for p in itertools.product(*self.grid_steps)]

    def run(self, verbose=0, return_all=0):
        objs, hyps, pts = [], [], []
        best_obj, best_hyp = -float("inf"), None
        for i, x in enumerate(self._grid_points()):
            hyp = self._mk_hyp(x)
            obj = self.inference_step(hyp, verbose)
            if obj > best_obj:
                best_obj, best_hyp = obj, hyp
            if verbose == 1:
                print(f"Iteration {i}, hypers: {hyp}, obj: {obj}")
            if return_all:
                objs.append(obj)
                hyps.append(hyp)
                pts.append(x)
        if return_all:
            return best_hyp, best_obj, hyps, objs, pts
        return best_hyp, best_obj

    def run_parallel(self, dataset, data_path, model, validation,
                     inference_method, task, verbose=1):
        cmds = self._command_list(self._grid_points(), dataset, data_path,
                                  model, validation, inference_method, task)
        if verbose == 1:
            print(f"Sending off {len(cmds)} jobs.")
        return cmds
