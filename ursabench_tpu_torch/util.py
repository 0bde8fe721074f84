"""Probability helpers, state-dict stacking and seed derivation.

Counterpart of ``ursabench_tpu/util.py``: the same smoothing and entropy
formulas on torch tensors. Ensembles stack ``state_dict``s along a leading
sample axis where the JAX package stacks pytrees.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence

import torch

StateDict = Dict[str, torch.Tensor]


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed``, derived from
    ``seed`` and ``tags`` with sha256 (stable across processes, unlike the
    builtin ``hash``)."""
    text = "/".join([str(int(seed))] + [str(t) for t in tags])
    digest = hashlib.sha256(text.encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def make_generator(device, seed: int, *tags) -> torch.Generator:
    """A generator on ``device`` seeded with ``derive_seed(seed, *tags)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, *tags))
    return gen


def stack_state_dicts(states: Sequence[StateDict]) -> StateDict:
    """Stack identically-keyed state dicts along a new leading axis."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def index_state_dict(state: StateDict, i: int) -> StateDict:
    """Member ``i`` of a stacked state dict."""
    return {k: v[i] for k, v in state.items()}


def central_smoothing(proba: torch.Tensor, gamma: float = 1e-4) -> torch.Tensor:
    """``(1-g)*p + g/K`` (Malinin et al. central smoothing)."""
    return (1.0 - gamma) * proba + gamma / proba.shape[-1]


def predictive_entropy(proba: torch.Tensor) -> torch.Tensor:
    """``-sum p log p`` over the class axis."""
    return -torch.sum(proba * torch.log(proba), dim=-1)


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    """exp(log_softmax(logits)), as the reference accumulates them."""
    return torch.exp(torch.log_softmax(logits, dim=-1))
