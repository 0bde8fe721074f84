"""Probability helpers, state-dict stacking, seed derivation and JSON.

Counterpart of ``ursabench_tpu/util.py``: the same smoothing and entropy
formulas on torch tensors. Ensembles stack ``state_dict``s along a leading
sample axis where the JAX package stacks pytrees.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, Sequence

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def json_open_from_file(path: str) -> dict:
    if not os.path.exists(path):
        raise FileNotFoundError(f"The file {path} does not exist!")
    with open(path, encoding="utf-8") as f:
        return json.loads(f.read())


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


def as_f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``: a tensor cast (a no-op for a
    float32 one there), a Python number filled in on the device, never
    copied from the host (what a captured CUDA graph needs)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def ravel(module: nn.Module) -> torch.Tensor:
    """``module``'s parameters as one flat vector, in ``parameters()``
    order: a view of the flat buffer after ``engine.flatten_parameters``, a
    copy otherwise. (The JAX package's ``ravel`` orders leaves by pytree
    path, so the two vectors are permutations of each other.)"""
    plist = [p.detach() for p in module.parameters()]
    storage = plist[0].untyped_storage().data_ptr()
    start, offset = plist[0].storage_offset(), 0
    for p in plist:  # a view only if the parameters tile one buffer in order
        if (p.untyped_storage().data_ptr() != storage or not p.is_contiguous()
                or p.storage_offset() != start + offset):
            return torch.cat([q.reshape(-1) for q in plist])
        offset += p.numel()
    return plist[0].as_strided((offset,), (1,), start)


def unraveler(module: nn.Module) -> Callable[[torch.Tensor], StateDict]:
    """A function mapping a flat vector in ``ravel(module)``'s order to
    ``{parameter name: view of the vector}``."""
    shapes = [(name, p.shape, p.numel()) for name, p in module.named_parameters()]

    def unravel(vec: torch.Tensor) -> StateDict:
        out, offset = {}, 0
        for name, shape, k in shapes:
            out[name] = vec[offset: offset + k].view(shape)
            offset += k
        return out

    return unravel


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
