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
rank writing its own block. ``gather_rows`` assembles a checkpoint's
(C, ...) blocks for rank 0 that way, and ``barrier`` is an all-reduce of
one element; both move host tensors (generator states) to the backend's
device and back, since NCCL reduces CUDA tensors only.

A ``Mesh`` of ``chain * data`` ranks spans ranks 0 .. chain * data - 1 of
the process group, as the JAX package lays its mesh over the first
``chain * data`` devices; one larger than the group raises. The ranks past
it idle (``active`` False): they build every process group with the rest,
since making a group is a collective over the whole world, and then hold
no chains and run no sampler. The mesh's own collectives ('all' included)
run in its own groups, so an idle rank never joins them. Rank 0 is always
in the mesh.
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
    """``shape`` {'chain': chain, 'data': data} over the first chain * data
    ranks, this rank's ``chain_idx`` and ``data_idx`` (None on an idle
    rank, whose ``active`` is False), and the process groups of its data
    row (the ranks that share its chains), of its chain column (the ranks
    that share its data slice) and, on a mesh smaller than the world, of
    the whole mesh. Creating a group is a collective over the world, so
    every rank, idle or not, builds every group in the same order:
    construct a Mesh on every rank at the same point, once a run. A mesh
    of more ranks than the world raises ValueError."""

    def __init__(self, chain: int = 1, data: int = 1):
        if chain < 1 or data < 1:
            raise ValueError(f"mesh axes must be >= 1, got chain={chain} data={data}")
        self.shape = {"chain": int(chain), "data": int(data)}
        self.size = self.shape["chain"] * self.shape["data"]
        world = world_size()
        if self.size > world:
            raise ValueError(f"a mesh of {chain} x {data} ranks needs that many processes, "
                             f"not {world}: start them and call "
                             "parallel.initialize() before building it")
        self.rank = rank()
        self.active = self.rank < self.size
        self.chain_idx, self.data_idx = (divmod(self.rank, self.shape["data"]) if self.active
                                         else (None, None))
        self._data_group = self._chain_group = self._all_group = None
        if world > 1:
            for c in range(chain):  # the data rows
                group = dist.new_group([c * data + d for d in range(data)]) if data > 1 else None
                if c == self.chain_idx:
                    self._data_group = group
            for d in range(data):  # the chain columns
                group = dist.new_group([c * data + d for c in range(chain)]) if chain > 1 else None
                if d == self.data_idx:
                    self._chain_group = group
            if 1 < self.size < world:  # 'all' is the mesh's ranks, not the world's
                self._all_group = dist.new_group(list(range(self.size)))

    def __repr__(self) -> str:
        where = f"rank={self.rank}" if self.active else f"rank={self.rank}, idle"
        return f"Mesh(chain={self.shape['chain']}, data={self.shape['data']}, {where})"

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
        if axis == "all":  # the mesh's group, or the default one when it is the world
            return self._all_group
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

    def gather_rows(self, blocks: Sequence[torch.Tensor], dim: int = 0
                    ) -> Optional[List[torch.Tensor]]:
        """Every chain rank's blocks of each of ``blocks`` along ``dim``, in
        chain order, as CPU tensors on rank 0 (None on the others): one
        all-reduce over 'chain' a dtype of zero-filled buffers, on the
        backend's device (a sum with zeros is exact, uint8 generator states
        included; bool blocks travel as uint8). A collective: every rank
        calls it."""
        if self.shape["chain"] == 1:
            out = [b.detach().cpu() for b in blocks]
        else:
            device = _collective_device()
            out = []
            for b in blocks:
                shape = list(b.shape)
                n = shape[dim]
                shape[dim] = n * self.shape["chain"]
                dtype = torch.uint8 if b.dtype == torch.bool else b.dtype
                full = torch.zeros(shape, dtype=dtype, device=device)
                full.narrow(dim, self.chain_idx * n, n).copy_(b)
                out.append(full)
            self.all_reduce_many(out, "chain")
            out = [t.cpu().to(b.dtype) for t, b in zip(out, blocks)]
        return out if self.rank == 0 else None

    def barrier(self) -> None:
        """Wait for every rank of the mesh (an all-reduce of one element
        over 'all')."""
        self.all_reduce(torch.zeros(1, device=_collective_device()), "all")


class StaticReduce:
    """The all-reduce over one axis of a fixed list of tensors through static
    flat buffers, one a dtype, made once (a captured program's collectives,
    run between the replays of its two segments).

    ``pack(sums)`` copies this step's ``sums`` and the ``means`` into their
    slices (one ``cat`` a buffer); ``reduce()`` runs one ``dist.all_reduce``
    a buffer, in place; ``unpack()`` divides the ``means``' slice of each
    buffer by the axis's ranks (JAX's ``pmean``, in the buffer's dtype, as
    ``Mesh.all_reduce_many(mean=True)`` divides), copies it back into the
    ``means`` and returns the summed ``sums``, views of the buffers shaped
    as the tensors given. ``pack`` and ``unpack`` launch device work only,
    so a CUDA graph captures them; ``reduce`` runs eagerly between two
    replays. The reduction is elementwise, so each value is the sum (or
    mean) that ``Mesh.all_reduce`` or ``all_reduce_many`` gives it: bit for
    bit where the sum over ranks does not depend on a value's place in the
    buffer (two ranks)."""

    def __init__(self, mesh: Mesh, axis: str, sums: Sequence[torch.Tensor],
                 means: Sequence[torch.Tensor]):
        self.mesh, self.axis, self.means = mesh, axis, list(means)
        entries = [(t, False) for t in sums] + [(t, True) for t in self.means]
        by_dtype: Dict[torch.dtype, List[int]] = defaultdict(list)
        for j, (t, _) in enumerate(entries):
            by_dtype[t.dtype].append(j)
        views: List[Optional[torch.Tensor]] = [None] * len(entries)
        self.buffers: List[tuple] = []  # (flat buffer, its entries' indices)
        self._mean_slices: List[torch.Tensor] = []
        for dtype, js in by_dtype.items():
            buf = torch.zeros(sum(entries[j][0].numel() for j in js), dtype=dtype,
                              device=entries[js[0]][0].device)
            offset, first_mean = 0, None
            for j in js:  # the sums first, then the means: one slice to divide
                t, mean = entries[j]
                if mean and first_mean is None:
                    first_mean = offset
                views[j] = buf[offset: offset + t.numel()].view(t.shape)
                offset += t.numel()
            self.buffers.append((buf, js))
            if first_mean is not None:
                self._mean_slices.append(buf[first_mean:])
        self.sums = views[:len(sums)]
        self._mean_views = views[len(sums):]

    def pack(self, sums: Sequence[torch.Tensor]) -> None:
        values = list(sums) + self.means
        for buf, js in self.buffers:
            torch.cat([values[j].reshape(-1) for j in js], out=buf)

    def reduce(self) -> None:
        for buf, _ in self.buffers:
            self.mesh.all_reduce(buf, self.axis)

    def unpack(self) -> List[torch.Tensor]:
        span = self.mesh._span(self.axis)
        for s in self._mean_slices:
            s /= span
        if self.means:
            torch._foreach_copy_(self.means, self._mean_views)
        return self.sums


def _collective_device() -> torch.device:
    """Where a collective of host data runs: the rank's card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: Optional[int] = None, chain_devices: Optional[int] = None) -> Mesh:
    """A ('chain', 'data') ``Mesh`` over the first ``n_devices`` ranks
    (default: the world), the chain axis ``make_layout``'s square-ish power
    of two."""
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
