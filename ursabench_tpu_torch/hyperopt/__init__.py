"""Hyperparameter optimization: RandomSearch, GridSearch, BayesOpt with its
GP, and the vectorized searches over ``inference.MethodSweep``.
Counterpart of ``ursabench_tpu/hyperopt``."""

from .bayesopt import BayesOpt
from .gp import GP
from .search import GridSearch, RandomSearch, _HypOpt
from .vectorized import batched_bayesopt, batched_bayesopt_sghmc, vectorized_random_search

__all__ = ["RandomSearch", "GridSearch", "BayesOpt", "GP", "_HypOpt",
           "vectorized_random_search", "batched_bayesopt", "batched_bayesopt_sghmc"]


def get_hypopt(name: str):
    import sys

    mod = sys.modules[__name__]
    if not hasattr(mod, name):
        raise KeyError(f"Unknown hyperopt method '{name}'")
    return getattr(mod, name)
