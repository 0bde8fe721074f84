"""Checkpoints as .npz files whose keys are '/'-joined paths of nested dicts.

Counterpart of ``ursabench_tpu/utils_checkpoint.py``:
- ``save_variables`` / ``load_variables``: a model's weights in flax's
  variable layout (``params/...``, ``batch_stats/...``, through
  ``transfer.params_to_jax`` and ``params_from_jax``), so a variables file
  written by either package loads in the other;
- ``save_ensemble`` / ``load_ensemble``: an ``Ensemble``'s stacked state;
- ``save_sampler_state`` / ``restore_sampler_state``: an epoch sampler's
  chains mid-run: the (C, P) parameter and momentum buffers, every chain's
  BatchNorm buffers, the step, ``epochs_run``, ``burnt_in`` and, in place
  of the JAX package's PRNG key, the state of every generator the chains
  draw from (CUDA generators included), so a resumed chain continues the
  same streams.

A file is written beside its path and renamed over it, so a run killed
while saving leaves the previous checkpoint whole.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .transfer import params_from_jax, params_to_jax


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Write a nested dict of tensors or arrays to ``path`` (exactly that
    name) as one .npz."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(tree))
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    """The nested dict of numpy arrays that ``save_pytree`` wrote."""
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def save_variables(path: str, module: nn.Module) -> None:
    save_pytree(path, params_to_jax(module))


def load_variables(path: str, module: nn.Module) -> nn.Module:
    """Load a variables file (either package's) into ``module`` in place."""
    return params_from_jax(module, load_pytree(path))


def save_ensemble(path: str, ensemble) -> None:
    """Write the whole ensemble (gathered first when it was made on a device
    mesh: a collective, so every rank calls it)."""
    ensemble = ensemble.gather()
    tree = {"state": ensemble.state, "num_members": ensemble.num_members}
    if ensemble.dropout_seed is not None:
        tree["dropout_seed"] = np.asarray(ensemble.dropout_seed, np.int64)
    save_pytree(path, tree)


def load_ensemble(path: str, module: nn.Module, device=None):
    """The ensemble that ``save_ensemble`` wrote, on ``module``'s device
    unless ``device`` is given."""
    from .inference.ensemble import Ensemble

    tree = load_pytree(path)
    if device is None:
        device = next(module.parameters()).device
    state = {k: torch.from_numpy(v).to(device) for k, v in tree["state"].items()}
    seed = tree.get("dropout_seed")
    return Ensemble(module, state, int(tree["num_members"]),
                    dropout_seed=None if seed is None else int(seed))


def generator_states(generators: Dict[str, torch.Generator]) -> Dict[str, torch.Tensor]:
    return {name: g.get_state() for name, g in generators.items()}


def set_generator_states(generators: Dict[str, torch.Generator], states: Dict) -> None:
    if set(states) != set(generators):
        raise ValueError(f"checkpoint generators {sorted(states)} != the sampler's "
                         f"{sorted(generators)}")
    for name, g in generators.items():
        g.set_state(torch.from_numpy(np.asarray(states[name])))


def copy_into(dst: torch.Tensor, src, name: str) -> None:
    """``dst.copy_(src)``, refusing a shape that would broadcast."""
    src = torch.as_tensor(np.asarray(src))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint {name}: shape {tuple(src.shape)}, the sampler "
                         f"holds {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def save_sampler_state(path: str, sampler) -> None:
    """An epoch sampler's chains, mid-run."""
    st = sampler._state
    buffers = {name: torch.stack([m.get_buffer(name) for m in sampler.modules])
               for name, _ in sampler.module.named_buffers()}
    save_pytree(path, {
        "params": st.params,
        "momentum": st.momentum,
        "batch_stats": buffers,
        "generators": generator_states(sampler._generators()),
        "step": np.asarray(st.step),
        "epochs_run": np.asarray(sampler.epochs_run),
        "burnt_in": np.asarray(1 if sampler.burnt_in else 0),
    })


def restore_sampler_state(path: str, sampler) -> None:
    tree = load_pytree(path)
    st = sampler._state
    copy_into(st.params, tree["params"], "params")
    copy_into(st.momentum, tree["momentum"], "momentum")
    for name, rows in tree.get("batch_stats", {}).items():
        for c, module in enumerate(sampler.modules):
            copy_into(module.get_buffer(name), rows[c], name)
    set_generator_states(sampler._generators(), tree["generators"])
    st.step = int(tree["step"])
    sampler.epochs_run = int(tree["epochs_run"])
    sampler.burnt_in = bool(int(tree["burnt_in"]))
