"""Move weights between flax variables (as numpy arrays) and a module of
this package: ``params_from_jax`` loads them, ``params_to_jax`` exports them.

Flax names a compact module's children ``<Type>_<k>``, counting each type in
creation order. The modules of this package register their children in the
same order, so walking ``named_children`` and counting per type pairs every
torch layer with its flax scope. ``nn.ModuleList`` containers are walked
through, since their flax counterparts sit directly in the parent scope.
Children without parameters (``Dropout``) have no flax scope and are
passed over.

Layouts: conv kernels HWIO -> OIHW (and the bias, where the conv has one),
dense kernels (in, out) -> (out, in); BatchNorm ``scale``/``bias`` and
``batch_stats`` ``mean``/``var`` map to ``weight``/``bias`` and
``running_mean``/``running_var``.

Takes and returns numpy arrays only (``jax.tree.map(np.asarray, variables)``
on the JAX side), so this module imports no JAX.
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
            if next(child.parameters(), None) is None:
                continue  # no parameters, no flax scope
            kind = next((name for t, name in _FLAX_TYPE.items() if isinstance(child, t)),
                        type(child).__name__)
            yield f"{kind}_{counts[kind]}", child
            counts[kind] += 1

    yield from walk(module)


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src = torch.from_numpy(np.array(src)).to(dst.dtype)
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
            want = {"kernel"} | ({"bias"} if child.bias is not None else set())
            if set(p) != want:
                raise KeyError(f"{path}: flax leaves {sorted(p)}, torch conv has "
                               f"{sorted(want)}")
            _copy(child.weight, np.transpose(p["kernel"], (3, 2, 0, 1)), path)
            if child.bias is not None:
                _copy(child.bias, p["bias"], path)
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


def params_to_jax(module: nn.Module) -> dict:
    """``module``'s weights as flax variables: ``{"params": ...,
    "batch_stats": ...}`` (the latter only if it has BatchNorm), nested
    dicts of float32 numpy arrays; the inverse of ``params_from_jax``."""
    params, stats = _export(module)
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def _numpy(t: torch.Tensor, perm=None) -> np.ndarray:
    t = t.detach().to("cpu", torch.float32)
    return (t if perm is None else t.permute(*perm)).contiguous().numpy().copy()


def _export(module: nn.Module):
    params, stats = {}, {}
    for name, child in _flax_children(module):
        if isinstance(child, nn.Conv2d):
            params[name] = {"kernel": _numpy(child.weight, (2, 3, 1, 0))}
            if child.bias is not None:
                params[name]["bias"] = _numpy(child.bias)
        elif isinstance(child, nn.Linear):
            params[name] = {"kernel": _numpy(child.weight, (1, 0)), "bias": _numpy(child.bias)}
        elif isinstance(child, BatchNorm2d):
            params[name] = {"scale": _numpy(child.weight), "bias": _numpy(child.bias)}
            stats[name] = {"mean": _numpy(child.running_mean),
                           "var": _numpy(child.running_var)}
        else:
            params[name], sub = _export(child)
            if sub:
                stats[name] = sub
    return params, stats
