"""URSABench in PyTorch and CUDA: posterior sampling -> stacked ensemble ->
Bayesian-model-averaged uncertainty tasks, on an NVIDIA GPU.

The JAX package ``ursabench_tpu`` beside this one is the reference; every
module here keeps its counterpart's file name. This package imports torch
and numpy only. Hand-written kernels live in ``csrc/`` and are built at
first use by ``kernels/``.
"""

from . import data, inference, models, tasks

__all__ = ["data", "inference", "models", "tasks"]
