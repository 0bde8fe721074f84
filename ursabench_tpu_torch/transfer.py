"""Load flax variables (as numpy arrays) into a module of this package.

Flax names a compact module's children ``<Type>_<k>``, counting each type in
creation order. The modules of this package register their children in the
same order, so walking ``named_children`` and counting per type pairs every
torch layer with its flax scope. ``nn.ModuleList`` containers are walked
through, since their flax counterparts sit directly in the parent scope.

Layouts: conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in);
BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` map to
``weight``/``bias`` and ``running_mean``/``running_var``.

Takes numpy arrays only (``jax.tree.map(np.asarray, variables)`` on the JAX
side), so this module imports no JAX.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from .models.common import BatchNorm2d

_FLAX_TYPE = {nn.Conv2d: "Conv", nn.Linear: "Dense", BatchNorm2d: "BatchNorm"}


def _flax_children(module: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    counts: Counter = Counter()

    def walk(m):
        for child in m.children():
            if isinstance(child, (nn.ModuleList, nn.Sequential)):
                yield from walk(child)
                continue
            kind = _FLAX_TYPE.get(type(child), type(child).__name__)
            yield f"{kind}_{counts[kind]}", child
            counts[kind] += 1

    yield from walk(module)


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: flax shape {tuple(src.shape)} != torch "
                         f"shape {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def params_from_jax(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy ``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy
    arrays) into ``module`` in place. Every flax leaf must find its layer
    and every layer its leaves."""
    _load(module, variables.get("params", {}),
          variables.get("batch_stats", {}), "")
    return module


def _load(module: nn.Module, params: Mapping, stats: Mapping, scope: str):
    seen = set()
    for name, child in _flax_children(module):
        seen.add(name)
        path = f"{scope}/{name}"
        if name not in params:
            raise KeyError(f"no flax params at {path}")
        p = params[name]
        if isinstance(child, nn.Conv2d):
            _copy(child.weight, np.transpose(p["kernel"], (3, 2, 0, 1)), path)
        elif isinstance(child, nn.Linear):
            _copy(child.weight, np.transpose(p["kernel"]), path)
            _copy(child.bias, p["bias"], path)
        elif isinstance(child, BatchNorm2d):
            _copy(child.weight, p["scale"], path)
            _copy(child.bias, p["bias"], path)
            s = stats[name]
            _copy(child.running_mean, s["mean"], path)
            _copy(child.running_var, s["var"], path)
        else:
            _load(child, p, stats.get(name, {}), path)
    missing = set(params) - seen
    if missing:
        raise KeyError(f"flax scopes without a torch layer under "
                       f"{scope or '/'}: {sorted(missing)}")
