"""The ('chain', 'data') grid of ranks, its collectives, and sharded BMA
evaluation.

Counterpart of ``ursabench_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a ``Mesh`` and lets ``shard_map`` generate the collectives;
here each device is a rank of ``torch.distributed`` and the grid is written
out:

    rank = chain_idx * data + data_idx

- sampler state (a block of ``chains / chain`` chains: parameters,
  momenta, BatchNorm buffers, generators) lives on the ranks of one chain
  row, replicated over its data ranks;
- each data rank of a row computes its slice of every batch, and the row's
  gradients are summed over 'data' by one all-reduce a step.

The collectives use only ``all_reduce`` (and no ``all_gather``), so one
path serves NCCL, gloo on CPU tensors and gloo on CUDA tensors (which has
no all-gather): rows are assembled as a sum of zero-filled buffers, each
rank writing its own block.

A ``Mesh`` spans the whole process group: one of another size raises
(the pure layout rules of ``distributed`` give a shape without one).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .distributed import make_layout, rank, world_size

StateDict = Dict[str, torch.Tensor]


class Mesh:
    """``shape`` {'chain': chain, 'data': data}, this rank's ``chain_idx``
    and ``data_idx``, and the process groups of its data row (the ranks
    that share its chains) and of its chain column (the ranks that share
    its data slice). Creating a group is a collective, so every rank builds
    every group, in the same order: construct a Mesh on every rank at the
    same point, once a run. Its size is the world's: ValueError otherwise."""

    def __init__(self, chain: int = 1, data: int = 1):
        if chain < 1 or data < 1:
            raise ValueError(f"mesh axes must be >= 1, got chain={chain} data={data}")
        self.shape = {"chain": int(chain), "data": int(data)}
        self.size = self.shape["chain"] * self.shape["data"]
        if self.size != world_size():
            raise ValueError(f"a mesh of {chain} x {data} ranks needs that many processes, "
                             f"not {world_size()}: start them and call "
                             "parallel.initialize() before building it")
        self.rank = rank()
        self.chain_idx, self.data_idx = divmod(self.rank, self.shape["data"])
        self._data_group = self._chain_group = None
        if self.size > 1:
            for c in range(chain):  # the data rows
                group = dist.new_group([c * data + d for d in range(data)]) if data > 1 else None
                if c == self.chain_idx:
                    self._data_group = group
            for d in range(data):  # the chain columns
                group = dist.new_group([c * data + d for c in range(chain)]) if chain > 1 else None
                if d == self.data_idx:
                    self._chain_group = group

    def __repr__(self) -> str:
        return (f"Mesh(chain={self.shape['chain']}, data={self.shape['data']}, "
                f"rank={self.rank})")

    # -- this rank's blocks -----------------------------------------------------

    def chain_block(self, rows: int) -> range:
        """This rank's rows (chains, sweep configs) of ``rows`` in all, as
        global indices: block ``chain_idx`` of ``chain`` equal blocks."""
        per, rest = divmod(rows, self.shape["chain"])
        if rest:
            raise ValueError(f"{rows} chains do not split over a chain axis of "
                             f"{self.shape['chain']}")
        return range(self.chain_idx * per, (self.chain_idx + 1) * per)

    def data_rows(self, n: int) -> slice:
        """This rank's rows of a batch of n: n * d // data up to
        n * (d + 1) // data, d = ``data_idx``."""
        dd, d = self.shape["data"], self.data_idx
        return slice(n * d // dd, n * (d + 1) // dd)

    # -- collectives ------------------------------------------------------------

    def _group(self, axis: str):
        if axis == "all":
            return None  # the default group: the whole world
        return self._data_group if axis == "data" else self._chain_group

    def _span(self, axis: str) -> int:
        return self.size if axis == "all" else self.shape[axis]

    def all_reduce(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``tensor`` in place over ``axis`` ('data': the ranks of this
        chain row, 'chain': of this data column, 'all': every rank)."""
        if self._span(axis) > 1:
            dist.all_reduce(tensor, group=self._group(axis))
        return tensor

    def all_reduce_many(self, tensors: Sequence[torch.Tensor], axis: str,
                        mean: bool = False) -> None:
        """``all_reduce`` of several tensors in place, one collective per
        dtype (they are packed into one buffer); ``mean`` divides by the
        axis's ranks afterwards (JAX's ``pmean``)."""
        span = self._span(axis)
        if span == 1 or not tensors:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = defaultdict(list)
        for t in tensors:
            by_dtype[t.dtype].append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, group=self._group(axis))
            if mean:
                flat /= span
            offset = 0
            for t in group:
                t.copy_(flat[offset: offset + t.numel()].view_as(t))
                offset += t.numel()

    def chain_rows(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The blocks of every chain rank along ``dim``, in chain order: a
        new tensor, ``chain`` times ``local`` along ``dim`` (the data ranks
        of a row hold equal blocks, so the column's sum assembles them)."""
        if self.shape["chain"] == 1:
            return local
        shape = list(local.shape)
        n = shape[dim]
        shape[dim] = n * self.shape["chain"]
        out = local.new_zeros(shape)
        out.narrow(dim, self.chain_idx * n, n).copy_(local)
        return self.all_reduce(out, "chain")


def make_mesh(n_devices: Optional[int] = None, chain_devices: Optional[int] = None) -> Mesh:
    """A ('chain', 'data') ``Mesh`` over ``n_devices`` ranks (default, and
    the one size a Mesh may have: the world), the chain axis
    ``make_layout``'s square-ish power of two."""
    return Mesh(*make_layout(world_size() if n_devices is None else n_devices, chain_devices))


def shard_ensemble_eval(module: nn.Module, mesh: Mesh) -> Callable:
    """BMA forward with the ensemble's members sharded over 'chain' and the
    eval batch over 'data': returns ``fn(state, x) -> (S, B, classes)``
    eval-mode logits of every member on the whole NCHW batch ``x``, on every
    rank. ``state`` holds this rank's members stacked (S / chain of them,
    block ``chain_idx`` of the member axis, as ``P('chain')`` shards it);
    each rank computes them on its rows of ``x`` through the forward of
    the tasks' BMA pass (``Ensemble.logits_all`` on ``data_rows``), and one
    all-reduce of a zero-filled buffer assembles the rest."""

    @torch.no_grad()
    def fn(state: StateDict, x: torch.Tensor) -> torch.Tensor:
        from ..inference.ensemble import Ensemble

        local = next(iter(state.values())).shape[0]
        rows = mesh.data_rows(x.shape[0])
        logits = Ensemble(module, state, local).logits_all(x[rows]).to(torch.float32)
        out = logits.new_zeros((local * mesh.shape["chain"], x.shape[0], logits.shape[-1]))
        out[mesh.chain_idx * local:(mesh.chain_idx + 1) * local, rows] = logits
        return mesh.all_reduce(out, "all")

    return fn
