"""Vectorized random search and batched Bayesian optimization: K
configurations evaluated together in one ``MethodSweep`` (any of SGHMC,
SGLD, cSGHMC, cSGLD and SGD), where the reference's parallel script starts
one process per configuration.

Counterpart of ``ursabench_tpu/hyperopt/vectorized.py``. The domain must pin
the method's schedule integers as constants ('num_samples' and
'burn_in_epochs' for SGHMC, the cycle for cSGHMC); continuous
hyperparameters vary. ``batched_bayesopt`` can report its seconds by round:
the sweep's sampling and BMA passes, the GP refit and the acquisition.
With ``mesh`` each sweep's configs ride its chain ranks (``MethodSweep``);
every rank then holds every objective and proposes the same next points.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..inference.base import resolve_device
from ..inference.vectorized import MethodSweep
from .search import RandomSearch, _parse_domain

def _search(domain, seed: int, n: int) -> RandomSearch:
    rs = RandomSearch.__new__(RandomSearch)
    (rs.hyp_names, rs.hyp_names_vary, rs.param_space_vary_type,
     rs.param_space_vary, rs.bounds, rs.hyp_names_constant,
     rs.constants) = _parse_domain(domain)
    rs.seed, rs.N_evaluations = seed, n
    return rs


def _finite_or_neg_inf(objs):
    """Diverged configs (NaN objectives) must never win argmax."""
    return [float(o) if np.isfinite(o) else float("-inf") for o in objs]


def _evaluate(rs, points, module, train, task_factory, seed, sgld, method, device, mesh):
    """One sweep over ``points``: (hyps, objectives, the sweep's seconds)."""
    hyps = [rs._mk_hyp(p) for p in points]
    if sgld:
        for h in hyps:
            h["alpha"] = 1.0
    sweep = MethodSweep(hyps, model=module, train=train, seed=seed, method=method,
                        device=device, mesh=mesh)
    objs = _finite_or_neg_inf(sweep.objectives(task_factory))
    return hyps, objs, sweep.seconds


def vectorized_random_search(
    domain: Sequence[dict],
    module,
    train,
    task_factory: Callable,
    N_evaluations: int = 10,
    seed: int = 123,
    sgld: bool = False,
    inference_method: str = "SGHMC",
    mesh=None,
    device=None,
):
    """N configs drawn uniformly over the domain (logspace-aware), run as one
    MethodSweep (its configs over ``mesh``'s chain ranks, if given). Returns
    (best_hyp, best_obj, hyp_list, obj_list)."""
    rs = _search(domain, seed, N_evaluations)
    hyps, objs, _ = _evaluate(rs, rs._draw_points(), module, train, task_factory, seed,
                              sgld, inference_method, device, mesh)
    i = int(np.argmax(objs))
    return hyps[i], float(objs[i]), hyps, objs


def batched_bayesopt(
    domain: Sequence[dict],
    module,
    train,
    task_factory: Callable,
    rounds: int = 5,
    q: int = 4,
    init_evaluations: int = 4,
    seed: int = 123,
    beta: float = 0.1,
    sgld: bool = False,
    verbose: int = 0,
    inference_method: str = "SGHMC",
    mesh=None,
    device=None,
    round_seconds: list | None = None,
):
    """Batched Bayesian optimization (BASELINE.md config 5): an initial
    random sweep of ``init_evaluations`` configs, then each round q diverse
    UCB proposals of a GP refitted on everything seen, evaluated together in
    one MethodSweep. Proposals that are not finite are replaced by uniform
    draws and reset the GP's warm start. Returns (best_hyp, best_obj,
    hyp_list, obj_list); a ``round_seconds`` list given is filled with one
    dict of seconds a sweep (the initial one first)."""
    from .bayesopt import sanitize_targets
    from .gp import GP, init_params, uniform_points

    device = resolve_device(device)
    rounds_s = [] if round_seconds is None else round_seconds
    rs = _search(domain, seed, init_evaluations)
    pts = rs._draw_points()
    hyp_list, obj_list, seconds = _evaluate(rs, pts, module, train, task_factory, seed,
                                            sgld, inference_method, device, mesh)
    rounds_s.append(dict(seconds))
    train_x = np.asarray(pts, np.float64)
    train_y = np.asarray(obj_list, np.float64)
    bounds = torch.as_tensor(rs.bounds, dtype=torch.float32, device=device)
    gp_params = init_params(train_x.shape[1], device)
    gen = torch.Generator().manual_seed(int(seed) + 1)

    for r in range(rounds):
        t0 = time.perf_counter()
        gp = GP(train_x, sanitize_targets(train_y), p0=gp_params, device=device)
        gp_params = gp.params
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        batch = np.asarray(gp.optimize_ucb_batch(bounds, gen, q, beta=beta), np.float64)
        t2 = time.perf_counter()
        bad = ~np.isfinite(batch).all(axis=1)
        if bad.any():
            batch[bad] = uniform_points(bounds, int(bad.sum()), gen).cpu().numpy()
            gp_params = init_params(train_x.shape[1], device)
        new_hyps, new_objs, seconds = _evaluate(rs, batch, module, train, task_factory, seed,
                                                sgld, inference_method, device, mesh)
        rounds_s.append({**seconds, "gp_fit": t1 - t0, "acquisition": t2 - t1})
        hyp_list.extend(new_hyps)
        obj_list.extend(new_objs)
        train_x = np.vstack([train_x, batch])
        train_y = np.append(train_y, new_objs)
        if verbose:
            print(f"round {r}: best so far {float(np.max(train_y)):.4f}")

    i = int(np.argmax(obj_list))
    return hyp_list[i], float(obj_list[i]), hyp_list, [float(o) for o in obj_list]


def batched_bayesopt_sghmc(*args, **kwargs):
    """``batched_bayesopt`` (SGHMC by default)."""
    return batched_bayesopt(*args, **kwargs)
