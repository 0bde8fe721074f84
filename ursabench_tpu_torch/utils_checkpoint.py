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

A sampler on a device mesh writes the file of one process: rank 0 gathers
every chain rank's block of each chain-indexed array and every chain's
generators (``save_chain_state``: one all-reduce over 'chain' a dtype),
writes, and every rank waits for the write before it goes on; on a resume
each rank reads its own block (``chain_block``) and generators. A sampler
whose chains are replicated over the chain axis (``sampler.replicated``)
gathers nothing: rank 0 holds every chain and writes them, and each rank
restores all of them. Generators
are named by global chain id (``data0``, ``data1``, ...), so a checkpoint
moves between layouts of the same chain count.

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


def generator_names(sampler) -> list:
    """Every generator of ``sampler`` by name, over every rank: its shared
    ones, and ``<prefix><c>`` for each chain c of each per-chain kind."""
    chains = range(sampler.chains)
    return sorted(list(sampler._shared_generators())
                  + [f"{p}{c}" for p in sampler._chain_generators() for c in chains])


def restore_generators(sampler, states: Dict) -> None:
    """Set this rank's generators from a checkpoint's ``generators``,
    which must name every generator of every rank."""
    if sorted(states) != generator_names(sampler):
        raise ValueError(f"checkpoint generators {sorted(states)} != the sampler's "
                         f"{generator_names(sampler)}")
    for name, g in sampler._generators().items():
        g.set_state(torch.from_numpy(np.asarray(states[name])))


def chain_block(sampler, array, dim: int = 0) -> np.ndarray:
    """This rank's chains of a checkpoint's chain-indexed ``array`` (all of
    them without a mesh), along ``dim``."""
    ids = sampler.chain_ids
    index = [slice(None)] * np.ndim(array)
    index[dim] = slice(ids[0], ids[-1] + 1)
    return np.asarray(array)[tuple(index)]


def save_chain_state(path: str, sampler, tree: dict, chain_dims: Dict[str, int]) -> None:
    """Write ``tree`` and every generator of ``sampler`` (as ``generators``)
    to ``path`` in the one-process layout. The entries named in
    ``chain_dims`` are tensors of this rank's chains along that axis; on a mesh they
    are assembled on rank 0 (which holds them all when the chains are
    replicated), which writes, and every rank waits for the file
    (collectives: every rank calls it)."""
    mesh = sampler.mesh
    chain = sampler._chain_generators()
    prefixes = sorted(chain)
    names = sorted(chain_dims)
    blocks = ([torch.stack([g.get_state() for g in chain[p]]) for p in prefixes]
              + [tree[k].movedim(chain_dims[k], 0) for k in names])
    if mesh is not None and not sampler.replicated:
        blocks = mesh.gather_rows(blocks)
    elif mesh is not None and mesh.rank:
        blocks = None
    if blocks is not None:
        out = dict(tree)
        gens = {n: g.get_state() for n, g in sampler._shared_generators().items()}
        for p, rows in zip(prefixes, blocks):
            gens.update({f"{p}{c}": rows[c] for c in range(rows.shape[0])})
        for k, rows in zip(names, blocks[len(prefixes):]):
            out[k] = rows.movedim(0, chain_dims[k])
        out["generators"] = gens
        save_pytree(path, out)
    if mesh is not None:
        mesh.barrier()


def copy_into(dst: torch.Tensor, src, name: str) -> None:
    """``dst.copy_(src)``, refusing a shape that would broadcast."""
    src = torch.as_tensor(np.asarray(src))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint {name}: shape {tuple(src.shape)}, the sampler "
                         f"holds {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def save_sampler_state(path: str, sampler) -> None:
    """An epoch sampler's chains, mid-run (every rank's, on a mesh: every
    rank calls it)."""
    st = sampler._state
    names = [name for name, _ in sampler.module.named_buffers()]
    tree = {"params": st.params, "momentum": st.momentum,
            "step": np.asarray(st.step), "epochs_run": np.asarray(sampler.epochs_run),
            "burnt_in": np.asarray(1 if sampler.burnt_in else 0)}
    tree.update({f"batch_stats/{name}": torch.stack([m.get_buffer(name) for m in sampler.modules])
                 for name in names})
    save_chain_state(path, sampler, tree, {k: 0 for k in tree if k in ("params", "momentum")
                                           or k.startswith("batch_stats/")})


def restore_sampler_state(path: str, sampler) -> None:
    """This rank's chains of an epoch sampler's checkpoint."""
    tree = load_pytree(path)
    st = sampler._state
    copy_into(st.params, chain_block(sampler, tree["params"]), "params")
    copy_into(st.momentum, chain_block(sampler, tree["momentum"]), "momentum")
    for name, rows in tree.get("batch_stats", {}).items():
        for module, row in zip(sampler.modules, chain_block(sampler, rows)):
            copy_into(module.get_buffer(name), row, name)
    restore_generators(sampler, tree["generators"])
    st.step = int(tree["step"])
    sampler.epochs_run = int(tree["epochs_run"])
    sampler.burnt_in = bool(int(tree["burnt_in"]))
