"""Training machinery for the epoch-driven samplers.

Counterpart of ``ursabench_tpu/inference/engine.py:54-313`` and ``:733-857``.
The JAX package compiles one epoch into a ``lax.scan``. Here
``epoch_indices`` draws the shuffled batch plan and ``make_epoch_fn``
builds the counterpart of that compiled epoch (an epoch program): the
plan, the crops and flips, the noise seeds and the epoch go into static
device buffers once an epoch, and one step, which reads them by a device
counter, is captured once as a CUDA graph and replayed a batch at a time
(on the CPU the same step runs eagerly). The step is gather -> normalize ->
augment -> forward, cross entropy, backward -> learning rate -> parameter
update; a model with dropout draws each step's keep masks into static
buffers before the step, from the generators ``train_steps`` draws from.
``make_streaming_step_fn`` and ``make_streaming_chunk_fn`` build the
program of an epoch over the batches a ``data.native.HostStreamingSplit``
streams from the host (the JAX package's ``run_streaming_epoch`` over its
compiled step or chunk), where the stream's permutation takes the place of
the batch plan: each transfer is copied into a static buffer and the one
captured step replayed once for each of its batches. ``train_steps`` runs
the resident epoch step by step from Python (``train_step``, the step
from normalize on) and ``stream_steps`` the streamed one: the programs'
plain versions.

C chains each have their own module (and so their own BatchNorm buffers),
batch plan, crops, flips and dropout streams. Their parameters, momenta and
gradients are the rows of one (C, P) float32 buffer each
(``flatten_chains``); autograd adds each gradient into its ``.grad`` view
in place. A step runs every chain's forward and backward, then one update
over the whole buffer: on the GPU, one launch of kernel K1 for all chains.
The chains share the learning rate, the noise gate and the first-step flag,
as they do in the JAX package's vmapped and scanned epochs. Two strategies
advance them (``base.resolve_chain_strategy``): ``"scan"`` runs each
chain's forward and backward in turn (``train_step``); ``"vmap"``
(``train_step_vmap``) gathers, normalizes and augments every chain's batch
in one pass and runs one forward and backward for all of them: chain 0's
module under ``torch.func.vmap`` over ``functional_call``, its parameters
(C, *shape) views of the (C, P) buffer (``ChainForward``), whose gradients
land in the (C, P) gradient buffer and whose BatchNorm statistics come back
as outputs, folded into each chain's own buffers after the forward
(``fold_batch_stats``). Both draw the same random streams. A sweep
(``inference/vectorized.py``) gives each row its own hyperparameters as
(K,) tensors, and its update applies them row by row in the same one call.
The gradient buffer is zeroed with ``zero_()`` before each step, never set
to None.

On a device mesh (``parallel.Mesh``, the ``mesh`` argument of the three step
functions, of ``stream_steps`` and of the three program makers, whose
split streams a data rank's rows of every batch) the state is one rank's
block of chains (``TrainState.row_offset``
and ``total_rows`` place it in the global buffer, so K1 draws that block's
noise) and every step follows the JAX package's sharded epoch
(``ursabench_tpu/inference/engine.py:317-480``): each data rank of a chain
row takes its slice of the same batch plan; the gradients become the global
batch's mean through one all-reduce over 'data' of the rank's whole (C, P)
gradient buffer (the cross-entropy sums over the global batch size, as
``psum(g) / n_global``), and the losses likewise; BatchNorm normalizes with
the local batch's statistics and the updated running statistics are then
averaged over 'data' (``pmean``, not SyncBN; under vmap after
``fold_batch_stats``); K1's seed is the same on every data rank, so the
replicas stay equal; each data rank draws its own dropout stream (JAX's
``fold_in(..., data_idx)``). The crops and flips are drawn for the whole
(chains, batches, batch) plan, and a data rank takes its slice of them, so
a sharded epoch equals the one-process epoch up to the order of the sums
(the JAX package folds ``data_idx`` into its augmentation key instead: the
same distribution through another stream). The programs run the same
sharded step, as the JAX package jits its ``shard_map``: on a chain mesh
it has no collective and is captured as it is; on a data mesh it is cut
at its collectives (``_Captured``): the forward, backward and BatchNorm
fold are one captured segment, the all-reduces of the gradient buffer
and of one static buffer a dtype holding the losses and the running
statistics (``parallel.mesh.StaticReduce``) run eagerly between its
replay and the second segment's, which averages the statistics and runs
the update.

``bn_refresh`` recomputes BatchNorm's running statistics with one exact
pass over a split; ``eval_loss`` is the mean cross entropy over a split in
eval mode. ``make_bn_refresh_fn`` and ``make_eval_loss_fn`` are the two as
programs (the JAX package's compiled passes), built once and called for
every set of weights; ``bn_refresh`` and ``eval_loss`` stay as their plain
versions. ``make_potential_fn`` is the full-batch samplers' potential as a
program: HMC's CE sum with and without its gradient, and PCA-ESS's
train-mode density, over the resident train split a ``grad_batch`` (or
batch) at a time, one or C weight rows. Every program here and the tasks'
BMA pass share ``_Captured``: a step read from device buffers, captured
once as a CUDA graph on the card and replayed, run eagerly on the CPU.
"""

from __future__ import annotations

import gc
import time
import warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, vmap

from .. import tracing
from ..data.transforms import ImageSpec, augment_normalized, normalize
from ..models.common import (BatchNorm2d, batch_stats_out, dropout_calls, dropout_generator,
                             dropout_layers, dropout_masks)
from ..parallel.mesh import StaticReduce
from ..util import StateDict, make_generator

if TYPE_CHECKING:
    from ..parallel.mesh import Mesh

# (hyp, epoch, batch_idx, global_step) -> lr, a 0-dim device tensor
LrFn = Callable[..., torch.Tensor]
# (state, hyp, *, lr, noise_on, is_first_step, seed) -> None, in place
UpdateFn = Callable[..., None]


@dataclass
class TrainState:
    """The chains: ``modules[c]``'s parameters and gradients are views into
    row c of ``params`` and ``grads`` ((C, P) float32, or (P,) for one
    chain); its BatchNorm buffers are chain c's batch stats. ``module`` is
    chain 0's; ``modules`` defaults to ``(module,)``. On a device mesh the
    rows are chains ``row_offset`` up of a global buffer of ``total_rows``
    (by default the state is the whole buffer)."""

    module: nn.Module
    params: torch.Tensor
    momentum: torch.Tensor
    grads: torch.Tensor
    step: int = 0  # global batch counter
    modules: Sequence[nn.Module] = ()
    row_offset: int = 0
    total_rows: Optional[int] = None
    _batched: Optional[tuple] = field(default=None, repr=False)
    _bns: Optional[list] = field(default=None, repr=False)

    def __post_init__(self):
        if not self.modules:
            self.modules = (self.module,)

    def noise_block(self) -> dict:
        """``offset`` and ``total`` of ``ops.sgmcmc.sghmc_update``: where
        these rows' elements lie in the global buffer."""
        rows = self.params.shape[0] if self.params.dim() == 2 else 1
        row_len = self.params.numel() // rows
        return {"offset": self.row_offset * row_len,
                "total": (self.total_rows or rows) * row_len}

    def bn_buffers(self) -> list:
        """Every chain's BatchNorm running statistics, in chain order."""
        if self._bns is None:
            self._bns = [b for module in self.modules for m in module.modules()
                         if isinstance(m, BatchNorm2d) for b in (m.running_mean, m.running_var)]
        return self._bns

    def batched(self):
        """``(ChainForward(module), leaves, bns)`` for the vmap step, made
        once: ``leaves`` maps each parameter name to a (C, *shape) view of
        ``params`` that autograd treats as a leaf, its ``.grad`` the same
        view of ``grads``; ``bns[c]`` is chain c's BatchNorm layers."""
        if self._batched is None:
            leaves = stacked_leaves(self.module, self.params, self.grads)
            bns = [[m for m in module.modules() if isinstance(m, BatchNorm2d)]
                   for module in self.modules]
            self._batched = (ChainForward(self.module), leaves, bns)
        return self._batched


def flatten_chains(modules: Sequence[nn.Module]):
    """Re-home every parameter of ``modules[c]`` (and its ``.grad``) as a
    view into row c of one (C, P) float32 buffer (float64 for float64
    modules, a CPU check's); returns ``(params, grads)``. Parameters keep
    their values; gradients start at zero. The modules must have the same
    architecture."""
    plists = [list(m.parameters()) for m in modules]
    device = plists[0][0].device
    dtype = torch.float64 if plists[0][0].dtype == torch.float64 else torch.float32
    total = sum(p.numel() for p in plists[0])
    flat_p = torch.empty(len(modules), total, dtype=dtype, device=device)
    flat_g = torch.zeros(len(modules), total, dtype=dtype, device=device)
    with torch.no_grad():
        for c, plist in enumerate(plists):
            if sum(p.numel() for p in plist) != total:
                raise ValueError("chains of different sizes")
            offset = 0
            for p in plist:
                if p.dtype != dtype or p.device != device:
                    raise ValueError("flat buffers need parameters of one dtype (float32, or "
                                     "float64) on one device")
                k = p.numel()
                flat_p[c, offset: offset + k].copy_(p.reshape(-1))
                p.data = flat_p[c, offset: offset + k].view_as(p)
                p.grad = flat_g[c, offset: offset + k].view_as(p)
                offset += k
    return flat_p, flat_g


def update_buffers(state: TrainState, hyp: dict):
    """``(params, momentum, grads)`` for the update: flat (C * P,) views when
    the hyperparameters are 0-dim (shared by every row), the (K, P) buffers
    when they are (K,) tensors, one value a row (a sweep's configs)."""
    if next(iter(hyp.values())).dim():
        return state.params, state.momentum, state.grads
    return state.params.view(-1), state.momentum.view(-1), state.grads.view(-1)


def stacked_views(module: nn.Module, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``{name: (C, *shape) view of flat}``: the rows of a (C, P) buffer cut
    into ``module``'s parameters, in ``parameters()`` order (the layout of
    ``flatten_chains``)."""
    out, offset = {}, 0
    for name, p in module.named_parameters():
        k = p.numel()
        out[name] = flat[:, offset: offset + k].view((flat.shape[0],) + tuple(p.shape))
        offset += k
    if offset != flat.shape[1]:
        raise ValueError(f"{flat.shape[1]} floats a row, the module has {offset} parameters")
    return out


def stacked_leaves(module: nn.Module, params: torch.Tensor,
                   grads: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``stacked_views`` of the (C, P) ``params`` as autograd leaves whose
    ``.grad`` is the same view of ``grads``: a backward adds each row's
    gradient into ``grads`` in place (``backward_into_views``)."""
    views = stacked_views(module, grads)
    leaves = {}
    for name, view in stacked_views(module, params).items():
        leaves[name] = view.detach().requires_grad_()
        leaves[name].grad = views[name]
    return leaves


class ChainForward:
    """C models of ``module``'s architecture as one batched forward:
    ``module``'s code under ``torch.func.vmap`` over ``functional_call``,
    each parameter a (C, *shape) tensor whose row c is model c's.

    Nothing inside draws or writes: in training mode each ``BatchNorm2d``
    returns its batch statistics (``(C, F)`` each, in ``self.bns`` order;
    ``fold_batch_stats`` folds them), and each active dropout layer takes a
    mask drawn outside (``masks``), in the order the forward calls them.
    The module's own buffers (BatchNorm's running statistics in eval mode)
    are shared by every row."""

    def __init__(self, module: nn.Module):
        self.module = module
        self.bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
        self._calls: dict = {}  # (input shape, training) -> dropout_calls

    def masks(self, x: torch.Tensor, gens: Sequence[torch.Generator]):
        """``(layers, masks)``: the dropout layers a forward on one row's
        input ``x`` calls, in order, and their keep masks, generator c
        drawing row c's layer after layer (what ``dropout_generator`` draws
        in a plain forward); (C, *shape) each, or unstacked for one
        generator (a mask shared by every row)."""
        key = (tuple(x.shape), self.module.training)
        if key not in self._calls:
            self._calls[key] = dropout_calls(self.module, x)
        calls = self._calls[key]
        drawn = [[layer.draw(shape, g) for layer, shape in calls] for g in gens]
        masks = drawn[0] if len(gens) == 1 else [torch.stack(col) for col in zip(*drawn)]
        return [layer for layer, _ in calls], masks

    def __call__(self, params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                 x_batched: bool, layers=(), masks=(), masks_batched: bool = False):
        """``(logits (C, B, classes), batch statistics)`` of the C rows of
        ``params`` on ``x``: (C, B, ...) when ``x_batched``, else one (B, ...)
        batch that every row sees."""
        module, bns = self.module, self.bns

        def one(p, xc, mc):
            with dropout_masks(layers, mc), batch_stats_out(bns) as stats:
                logits = functional_call(module, p, (xc,))
            return logits, tuple(stats)

        return vmap(one, in_dims=(0, 0 if x_batched else None, 0 if masks_batched else None))(
            params, x, list(masks))


@torch.no_grad()
def fold_batch_stats(bns_by_chain: Sequence[Sequence[BatchNorm2d]], stats) -> None:
    """Fold ``ChainForward``'s batch statistics into every chain's running
    ones, as a training forward of ``BatchNorm2d`` does: ``running = (1 - m)
    * running + m * batch`` (the biased variance); ``bns_by_chain[c][l]`` is
    chain c's layer l, ``stats[l]`` its ``(mean, var)``, (C, F) each."""
    groups: dict = {}  # momentum -> (running buffers, batch statistics)
    for layer, (mean, var) in enumerate(stats):
        for bns, m, v in zip(bns_by_chain, mean.unbind(0), var.unbind(0)):
            bn = bns[layer]
            run, new = groups.setdefault(bn.momentum, ([], []))
            run += [bn.running_mean, bn.running_var]
            new += [m, v]
    for momentum, (run, new) in groups.items():
        torch._foreach_mul_(run, 1.0 - momentum)
        torch._foreach_add_(run, new, alpha=momentum)


def backward_into_views(loss: torch.Tensor) -> None:
    """``loss.backward()`` into leaves whose ``.grad`` is a strided view of a
    flat buffer: autograd adds into it in place and warns that the view's
    strides are not the layout it prefers; the warning is silenced."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="grad and param do not obey")
        loss.backward()


def flatten_parameters(module: nn.Module):
    """``flatten_chains`` for one module: ``(params, grads)``, each (P,)."""
    params, grads = flatten_chains([module])
    return params[0], grads[0]


def init_variables(module: nn.Module, gen: torch.Generator) -> None:
    """(Re-)initialise ``module`` in place with the JAX package's
    initialisers, drawn from the CPU generator ``gen``. Writes into the
    existing tensors, so flat-buffer views stay bound."""
    module.init_parameters(gen)


def cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """nn.CrossEntropyLoss(reduction='mean')."""
    return F.cross_entropy(logits, labels)


def epoch_indices(gen: torch.Generator, n: int, bsz: int) -> torch.Tensor:
    """The epoch's batch plan, (num_batches, bsz) indices on ``gen``'s
    device: a permutation of ``range(n)``, its last batch filled up with the
    permutation's first ``pad`` entries."""
    nb = -(-n // bsz)
    pad = nb * bsz - n
    perm = torch.randperm(n, generator=gen, device=gen.device)
    if pad:
        perm = torch.cat([perm, perm[:pad]])
    return perm.view(nb, bsz)


def _data_shards(mesh: Optional["Mesh"]) -> int:
    return 1 if mesh is None else mesh.shape["data"]


def _dropout_gen(device, seed: int, batch_idx: int, mesh: Optional["Mesh"]) -> torch.Generator:
    """A chain's dropout generator for batch ``batch_idx``; on a data mesh,
    each data rank's own (the counterpart of ``fold_in(..., data_idx)``)."""
    if _data_shards(mesh) > 1:
        return make_generator(device, seed, batch_idx, "data", mesh.data_idx)
    return make_generator(device, seed, batch_idx)


def _reduce_over_data(state: TrainState, losses: torch.Tensor, mesh: Optional["Mesh"]) -> None:
    """On a data mesh, in place: the gradients and losses summed over
    'data' (one all-reduce of the whole gradient buffer, one of the
    losses), then the BatchNorm running statistics averaged over it."""
    if _data_shards(mesh) == 1:
        return
    mesh.all_reduce(state.grads, "data")
    mesh.all_reduce(losses, "data")
    mesh.all_reduce_many(state.bn_buffers(), "data", mean=True)


def _batch_loss(logits: torch.Tensor, y: torch.Tensor, shards: int) -> torch.Tensor:
    """The mean cross entropy, or on a data mesh this rank's share of the
    global batch's: its sum over the global batch size."""
    if shards == 1:
        return cross_entropy_mean(logits, y)
    return F.cross_entropy(logits, y, reduction="sum") / (y.shape[0] * shards)


_NO_DROPOUT_SEEDS = ("active Dropout without a generator: a model with dropout needs "
                     "dropout_seeds")


def _chains_loss_backward(state: TrainState, batches: Sequence[tuple], *, spec: ImageSpec,
                          batch_idx, aug, dropout_seeds, mesh, masks=None) -> torch.Tensor:
    """Each chain's forward, cross entropy and backward in turn (the
    gradients added into ``state.grads``); returns the (C,) losses. Chain
    c's dropout draws from its generator for ``batch_idx`` or, with
    ``masks``, takes ``masks[c]``, ``(layers, keep masks)`` drawn outside."""
    shards = _data_shards(mesh)
    losses = []
    for c, module in enumerate(state.modules):
        x, y = batches[c]
        if not x.is_floating_point():
            x = normalize(x, spec)
        if aug is not None:
            x = augment_normalized(x, spec, *aug[c])
        x = x.permute(0, 3, 1, 2).contiguous()
        if masks is not None:
            drop = dropout_masks(*masks[c])
        else:
            gen = (None if dropout_seeds is None
                   else _dropout_gen(x.device, dropout_seeds[c], batch_idx, mesh))
            drop = dropout_generator(module, gen)
        with drop:
            loss = _batch_loss(module(x), y, shards)
        loss.backward()
        losses.append(loss.detach())
    return torch.stack(losses)


def _vmap_loss_backward(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
                        idx: torch.Tensor, *, spec: ImageSpec, batch_idx, aug, dropout_seeds,
                        mesh, masks=None) -> torch.Tensor:
    """Every chain's forward, cross entropy and backward as one batched
    pass (``ChainForward``), the BatchNorm statistics folded after it;
    returns the (C,) losses. Dropout draws from the chains' generators for
    ``batch_idx`` or, with ``masks``, takes ``(layers, (C, *shape) keep
    masks)`` drawn outside."""
    chains, bsz = idx.shape
    fwd, leaves, bns = state.batched()
    flat = idx.reshape(-1)
    x, y = images.index_select(0, flat), labels.index_select(0, flat)
    if not x.is_floating_point():
        x = normalize(x, spec)
    if aug is not None:
        x = augment_normalized(x, spec, *(None if a is None else a.reshape(-1) for a in aug))
    x = x.permute(0, 3, 1, 2).contiguous()
    x = x.view((chains, bsz) + tuple(x.shape[1:]))
    layers, keep, batched = (), (), chains > 1
    if masks is not None:
        (layers, keep), batched = masks, True
    elif dropout_layers(fwd.module):
        if dropout_seeds is None:
            raise RuntimeError(_NO_DROPOUT_SEEDS)
        layers, keep = fwd.masks(x[0], [_dropout_gen(x.device, s, batch_idx, mesh)
                                        for s in dropout_seeds])
    logits, stats = fwd(leaves, x, x_batched=True, layers=layers, masks=keep,
                        masks_batched=batched)
    ce = F.cross_entropy(logits.reshape(chains * bsz, -1), y, reduction="none").view(chains, bsz)
    shards = _data_shards(mesh)
    losses = ce.mean(1) if shards == 1 else ce.sum(1) / (bsz * shards)
    backward_into_views(losses.sum())
    if stats:
        fold_batch_stats(bns, stats)
    return losses.detach()


def train_step(
    state: TrainState,
    batches: Sequence[tuple],
    *,
    spec: ImageSpec,
    epoch: int,
    batch_idx: int,
    noise_on: torch.Tensor,
    hyp: dict,
    lr_fn: LrFn,
    update_fn: UpdateFn,
    seed: int,
    aug: Optional[Sequence[tuple]] = None,
    dropout_seeds: Optional[Sequence[int]] = None,
    mesh: Optional["Mesh"] = None,
) -> torch.Tensor:
    """One training step of every chain of ``state``, in place; returns the
    chains' losses, (C,), on the device. The body of both epochs, resident
    (``train_steps``) and streamed (``stream_steps``). On a data mesh the
    batches are this rank's rows and the step is the global batch's (module
    docstring).

    ``batches[c]`` is chain c's ``(x, y)``: x NHWC, uint8 (normalized here
    with ``normalize``) or float32 (taken as normalized), y int64 labels;
    ``aug[c]`` is its ``(ox, oy, flip)`` or None for none; chain c's
    dropout draws from ``make_generator(device, dropout_seeds[c],
    batch_idx)`` (a model with dropout raises without ``dropout_seeds``);
    ``seed`` keys the step's Langevin noise (one update over all
    chains)."""
    state.grads.zero_()
    losses = _chains_loss_backward(state, batches, spec=spec, batch_idx=batch_idx, aug=aug,
                                   dropout_seeds=dropout_seeds, mesh=mesh)
    _reduce_over_data(state, losses, mesh)
    lr = lr_fn(hyp, epoch, batch_idx, state.step)
    update_fn(state, hyp, lr=lr, noise_on=noise_on, is_first_step=state.step == 0, seed=seed)
    state.step += 1
    return losses


def train_step_vmap(
    state: TrainState,
    images: torch.Tensor,
    labels: torch.Tensor,
    idx: torch.Tensor,
    *,
    spec: ImageSpec,
    epoch: int,
    batch_idx: int,
    noise_on: torch.Tensor,
    hyp: dict,
    lr_fn: LrFn,
    update_fn: UpdateFn,
    seed: int,
    aug: Optional[tuple] = None,
    dropout_seeds: Optional[Sequence[int]] = None,
    mesh: Optional["Mesh"] = None,
) -> torch.Tensor:
    """``train_step`` for every chain at once: chain c trains on
    ``images[idx[c]]`` ((C, batch) indices) with ``aug``'s row c ((C, batch)
    each, or None), gathered, normalized and augmented in one pass, then one
    batched forward and backward (``ChainForward``) and the same update.
    Chain c's dropout masks come from ``make_generator(device,
    dropout_seeds[c], batch_idx)``, drawn as ``train_step`` draws them.
    Returns the (C,) losses on the device. On a data mesh ``idx`` and
    ``aug`` are this rank's columns."""
    state.grads.zero_()
    losses = _vmap_loss_backward(state, images, labels, idx, spec=spec, batch_idx=batch_idx,
                                 aug=aug, dropout_seeds=dropout_seeds, mesh=mesh)
    _reduce_over_data(state, losses, mesh)
    lr = lr_fn(hyp, epoch, batch_idx, state.step)
    update_fn(state, hyp, lr=lr, noise_on=noise_on, is_first_step=state.step == 0, seed=seed)
    state.step += 1
    return losses


def train_steps(
    state: TrainState,
    images: torch.Tensor,
    labels: torch.Tensor,
    idx: torch.Tensor,
    *,
    spec: ImageSpec,
    epoch: int,
    noise_on: torch.Tensor,
    hyp: dict,
    lr_fn: LrFn,
    update_fn: UpdateFn,
    seeds: Sequence[int],
    aug: Optional[tuple] = None,
    dropout_seeds: Optional[Sequence[int]] = None,
    chain_strategy: Optional[str] = None,
    mesh: Optional["Mesh"] = None,
) -> torch.Tensor:
    """Run one training step per batch of ``idx`` on every chain of
    ``state``, in place (``train_step_vmap`` when ``chain_strategy`` is
    ``"vmap"``, else ``train_step``), and return the mean training loss: a
    0-dim tensor for one chain, (C,) for C, on the device (not read back).

    ``images`` (uint8 NHWC) and ``labels`` live on the device; ``idx`` is
    (C, num_batches, batch) or, for one chain, (num_batches, batch);
    ``aug`` is ``(ox, oy, flip)`` from ``draw_augment`` shaped like ``idx``,
    or None for no augmentation; ``seeds[i]`` keys step i's Langevin noise
    (one update over all chains); ``dropout_seeds[c]`` keys chain c's
    dropout, step i drawing from ``make_generator(device, seed, i)`` (the
    counterpart of ``fold_in(k_drop, i)``), and is needed only by models
    with dropout. On a data mesh each rank trains on its columns of every
    batch of ``idx`` and ``aug`` (``mesh.data_rows``), which must split the
    batch evenly."""
    chains = len(state.modules)
    idx = idx.reshape(chains, -1, idx.shape[-1])
    if aug is not None:
        aug = tuple(None if a is None else a.reshape(idx.shape) for a in aug)
    shards = _data_shards(mesh)
    if shards > 1:
        if idx.shape[-1] % shards:
            raise ValueError(f"a batch of {idx.shape[-1]} does not split over {shards} data ranks")
        mine = mesh.data_rows(idx.shape[-1])
        idx = idx[..., mine]
        if aug is not None:
            aug = tuple(None if a is None else a[..., mine] for a in aug)
    for m in state.modules:
        m.train()
    losses = []
    kw = dict(spec=spec, epoch=epoch, noise_on=noise_on, hyp=hyp, lr_fn=lr_fn,
              update_fn=update_fn, dropout_seeds=dropout_seeds, mesh=mesh)
    for bi in range(idx.shape[1]):
        if chain_strategy == "vmap":
            step_aug = None if aug is None else tuple(None if a is None else a[:, bi]
                                                      for a in aug)
            losses.append(train_step_vmap(state, images, labels, idx[:, bi], batch_idx=bi,
                                          seed=seeds[bi], aug=step_aug, **kw))
            continue
        batches = [(images.index_select(0, idx[c, bi]), labels.index_select(0, idx[c, bi]))
                   for c in range(chains)]
        losses.append(train_step(state, batches, batch_idx=bi, seed=seeds[bi],
                                 aug=_aug_at(aug, chains, bi), **kw))
    mean = torch.stack(losses).mean(0)
    return mean[0] if chains == 1 else mean


def _aug_at(aug: Optional[tuple], chains: int, bi: int) -> Optional[list]:
    """Each chain's ``(ox, oy, flip)`` of batch ``bi``, from (C, nb, batch)
    draws."""
    if aug is None:
        return None
    return [tuple(None if a is None else a[c, bi] for a in aug) for c in range(chains)]


def _per_chain(aug: Optional[tuple], chains: int) -> Optional[list]:
    """Each chain's ``(ox, oy, flip)`` of one batch, from (C, batch) draws."""
    if aug is None:
        return None
    return [tuple(None if a is None else a[c] for a in aug) for c in range(chains)]


# eager steps a program runs before it captures its step on the card: cuDNN,
# cuBLAS and autograd make their handles and workspaces there, the
# normalization constants and K1's library are built, and the capture then
# sees only the step's own work
WARMUP_STEPS = 3


class _Captured:
    """A program's step, run once a call for each of its batches: on the
    card the first ``WARMUP_STEPS`` steps run eagerly on a side stream (real
    steps, counted as such), then the step is captured once as a CUDA graph
    and every later step is a replay; on the CPU the step runs eagerly every
    time, the program's plain version. A capture that fails raises: nothing
    falls back to the eager step. The kernels' launch counts take each
    replay's launches (``tracing.replayed``); each capture is counted in
    ``tracing``'s ``program.capture``, with the warm-up steps before it.

    ``_step`` reads every input from the device (static buffers and device
    counters that it advances), so a replay computes what an eager step
    would from the buffers' current values. A step with collectives (a
    program on a data mesh) is cut there into two segments, ``_step`` and
    ``_step_after``, with the eager ``_hook`` between them (its
    all-reduces): each segment is captured once into its own graph, the
    second sharing the first's pool, and a step replays the first, runs the
    hook on the current stream (a warm-up step: on the side stream) and
    replays the second. What crosses the cut lies in static buffers. A step
    without a hook is one graph. ``pool`` returns, when the step is
    captured, the memory pool of a live graph of other programs that never
    run at the same time (``CUDAGraph.pool()``), to share it, or None for a
    private pool. ``captures`` counts the captures (one for both segments),
    ``segments`` is 1 or 2, ``capture_ms`` is the last capture's time on the
    host clock, ``pool_bytes`` what the allocator reserved for the graphs'
    pool in it (their intermediates), ``steps_run`` the steps run."""

    _hook: Optional[Callable[[], None]] = None

    def __init__(self, device: torch.device, pool: Callable[[], object] = lambda: None):
        self.device = device
        self.pool = pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_after: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.steps_run = 0
        self._warmed = 0
        self._captured_launches: list = []
        self._side = torch.cuda.Stream(device) if device.type == "cuda" else None

    @property
    def path(self) -> str:
        """``"graph"`` on the card, ``"eager"`` on the CPU."""
        return "eager" if self._side is None else "graph"

    @property
    def segments(self) -> int:
        """The step's captured segments: 2 with a hook between them, else 1."""
        return 1 if self._hook is None else 2

    def _step(self) -> None:
        raise NotImplementedError

    def _step_after(self) -> None:
        """The step's second segment, after the hook."""
        raise NotImplementedError

    def _run_step(self) -> None:
        """The whole step, uncaptured, on the current stream."""
        self._step()
        if self._hook is not None:
            self._hook()
            self._step_after()

    def _advance(self, eager: bool = False) -> None:
        """One step: a replay, or a warm-up step and the capture first; with
        ``eager`` (and on the CPU) the step itself on the current stream."""
        if eager or self._side is None:
            self._run_step()
        elif self.graph is None and self._warmed < WARMUP_STEPS:
            current = torch.cuda.current_stream(self.device)
            self._side.wait_stream(current)  # a warm-up step, on a side stream as a capture wants
            with tracing.span("program.warmup"), torch.cuda.stream(self._side):
                self._run_step()
            current.wait_stream(self._side)
            self._warmed += 1
        else:
            if self.graph is None:
                with tracing.span("program.capture"):
                    self._capture()
            with tracing.span("program.replay"):
                self.graph.replay()
                if self._hook is not None:
                    self._hook()
                    self._graph_after.replay()
            tracing.replayed(self._captured_launches)
        self.steps_run += 1

    def _capture(self) -> None:
        # capture_begin on the side stream, not torch.cuda.graph, which first
        # empties the allocator's cache: every later eager allocation of the
        # process would pay for that. As torch.cuda.graph does, garbage is
        # collected first, and no collection runs during the capture: one
        # that freed another graph there would invalidate the capture
        torch.cuda.synchronize(self.device)
        gc.collect()
        reserved = torch.cuda.memory_reserved(self.device)  # the pool maps segments of its own
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        after = None if self._hook is None else torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with tracing.record() as captured, torch.cuda.stream(self._side):
                graph.capture_begin(pool=self.pool())
                try:
                    self._step()
                finally:
                    graph.capture_end()
                if after is not None:  # always replayed after the first: it may reuse its memory
                    after.capture_begin(pool=graph.pool())
                    try:
                        self._step_after()
                    finally:
                        after.capture_end()
        finally:
            if collecting:
                gc.enable()
        self._captured_launches = captured
        torch.cuda.synchronize(self.device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self._graph_after = graph, after
        self.captures += 1
        tracing.captured(type(self).__name__, self.capture_ms, self._warmed)


def live_pool(programs) -> Optional[object]:
    """The memory pool of a live graph among ``programs`` (``_Captured``
    programs that never run at the same time), for a new capture to share;
    None when no graph lives (a new pool)."""
    return next((p.graph.pool() for p in programs if p.graph is not None), None)


class _ChainMasks:
    """The keep masks of a training program's active dropout calls, probed
    once when the program is built (``dropout_calls`` of each chain's
    train-mode forward on one batch): one static (C, *shape) buffer a call,
    row c chain c's. ``draw`` fills them before a step from each chain's
    generator for the batch, layer after layer, as ``train_step`` draws
    them (``_dropout_gen``); ``per_chain[c]`` binds chain c's layers to its
    rows (``dropout_masks``, the scan step), ``batched`` chain 0's layers to
    the whole buffers (the vmap step). Empty without active dropout. On a
    data mesh ``batch_size`` is the rank's rows and each data rank draws
    its own stream, as ``train_step`` does."""

    def __init__(self, modules: Sequence[nn.Module], spec: ImageSpec, batch_size: int,
                 device: torch.device, mesh: Optional["Mesh"] = None):
        self.device, self.mesh = device, mesh
        self.calls = [_dropout_probe(m, spec, batch_size, training=True) for m in modules]
        self.masks = [torch.zeros((len(modules),) + shape, dtype=torch.bool, device=device)
                      for _, shape in self.calls[0]]
        self.per_chain = [([layer for layer, _ in calls], [m[c] for m in self.masks])
                          for c, calls in enumerate(self.calls)]
        self.batched = self.per_chain[0][0], self.masks

    def draw(self, seeds: Sequence[int], batch_idx: int) -> None:
        for c, calls in enumerate(self.calls):
            _draw_into([m[c] for m in self.masks], calls,
                       _dropout_gen(self.device, seeds[c], batch_idx, self.mesh))


class _TrainProgram(_Captured):
    """What the resident and the streamed epoch programs share: one
    ``TrainState``, its hyperparameter tensors and its noise gate, read in
    place, so ``update_hyp``, the gate and an in-place checkpoint restore
    change what the next replay computes without a new capture (a new
    ``TrainState`` or hyperparameter dict needs a new program); static
    buffers for an epoch's crops and flips ((C, num_batches, batch), None
    where the spec draws none), its noise seeds and its epoch; device
    counters for the batch in the epoch and the global step; a
    (num_batches, C) loss buffer; and the dropout masks (``_ChainMasks``),
    drawn before each step.

    A call starts an epoch (``_begin``: the draws copied in, the counters
    reset) and runs its steps (``_run``). The step ends in ``_update``: the
    learning rate from the epoch, batch and step counters, the first-step
    flag from the global one on the device, the update (K1 reads its seed,
    ``seeds[i]``, from device memory), the losses into row i, both counters
    advanced. Nothing in the step reads the host or copies from it.

    On a device mesh (``mesh``) the state is the rank's block of chains
    and ``batch_size`` the rank's rows of a batch; a call takes the draws
    of the whole batch and keeps this rank's columns (``mesh.data_rows``),
    as ``train_steps`` does. On a data mesh the step is ``train_step``'s
    sharded one, cut at its collectives: the first segment runs the
    forward and backward (the BatchNorm statistics folded) and packs the
    losses and the running statistics into the static buffers of a
    ``parallel.mesh.StaticReduce``; the hook all-reduces the gradient
    buffer and those buffers over 'data' (one collective a dtype); the
    second segment unpacks them (the statistics' mean copied back) and runs
    the update. A chain mesh's step has no collective and stays one
    graph."""

    chain_strategy: Optional[str] = None

    def __init__(self, state: TrainState, *, spec: ImageSpec, num_batches: int, batch_size: int,
                 hyp: dict, noise_on: torch.Tensor, lr_fn: LrFn, update_fn: UpdateFn,
                 mesh: Optional["Mesh"] = None):
        device = state.params.device
        super().__init__(device)
        chains = len(state.modules)
        self.shape = (chains, num_batches, batch_size)
        self.state, self.hyp, self.noise_on, self.spec = state, hyp, noise_on, spec
        self.lr_fn, self.update_fn, self.mesh = lr_fn, update_fn, mesh
        crop = spec.random_crop_pad > 0
        self.aug = (tuple(torch.zeros(self.shape, dtype=dt, device=device) if on else None
                          for on, dt in ((crop, torch.int64), (crop, torch.int64),
                                         (spec.random_flip, torch.bool)))
                    if spec.augments else None)
        self.seeds = torch.zeros(num_batches, dtype=torch.int64, device=device)
        self.epoch = torch.zeros((), dtype=torch.float32, device=device)
        self.batch = torch.zeros((), dtype=torch.int64, device=device)  # in the epoch
        self.step = torch.zeros((), dtype=torch.int64, device=device)  # global
        self.losses = torch.zeros((num_batches, chains), dtype=state.params.dtype, device=device)
        self.dropout = _ChainMasks(state.modules, spec, batch_size, device, mesh)
        self._dropout_seeds: Optional[Sequence[int]] = None
        self._reduce = None  # the data mesh's StaticReduce, made at the first step
        if _data_shards(mesh) > 1:
            self._hook = self._exchange

    def _columns(self, t: torch.Tensor) -> torch.Tensor:
        """Draws of whole batches as (C, num_batches, batch), this rank's
        columns of each batch on a data mesh."""
        t = t.reshape(self.shape[:2] + (-1,))
        return t if self.mesh is None else t[..., self.mesh.data_rows(t.shape[-1])]

    def _begin(self, *, epoch: int, seeds, aug: Optional[tuple],
               dropout_seeds: Optional[Sequence[int]]) -> None:
        """An epoch's draws into the static buffers, the counters reset."""
        if self.dropout.masks and dropout_seeds is None:
            raise RuntimeError(_NO_DROPOUT_SEEDS)
        self._dropout_seeds = dropout_seeds
        if self.aug is not None:
            for buf, a in zip(self.aug, aug):
                if buf is not None:
                    buf.copy_(self._columns(a))
        seeds = torch.as_tensor(seeds, dtype=torch.int64)
        if self._side is not None:  # no wait for the card: a pinned, asynchronous copy
            seeds = seeds.pin_memory()
        self.seeds.copy_(seeds, non_blocking=True)
        self.epoch.fill_(float(epoch))
        self.batch.zero_()
        self.step.fill_(self.state.step)
        for m in self.state.modules:
            m.train()

    def _run(self, batch_idx: int) -> None:
        """Step ``batch_idx`` of the epoch: its dropout masks drawn, then
        the step (on the card a replay)."""
        if self.dropout.masks:
            self.dropout.draw(self._dropout_seeds, batch_idx)
        self._advance()

    def _step_aug(self, i: torch.Tensor) -> Optional[tuple]:
        """The crops and flips of batch ``i`` (a device index): ``(ox, oy,
        flip)``, (C, batch) each, or None."""
        if self.aug is None:
            return None
        return tuple(None if a is None else a.index_select(1, i).squeeze(1) for a in self.aug)

    def _finish(self, losses: torch.Tensor) -> None:
        """The end of the first segment: the update, or on a data mesh the
        losses and the BatchNorm statistics packed for the hook."""
        if self._hook is None:
            self._update(losses)
            return
        if self._reduce is None:
            self._reduce = StaticReduce(self.mesh, "data", [losses], self.state.bn_buffers())
        self._reduce.pack([losses])

    def _exchange(self) -> None:
        """The hook of a data mesh: the gradient buffer and the packed
        buffers summed over 'data', in place (``_reduce_over_data``'s
        collectives)."""
        self.mesh.all_reduce(self.state.grads, "data")
        self._reduce.reduce()

    def _step_after(self) -> None:
        self._update(self._reduce.unpack()[0])

    def _update(self, losses: torch.Tensor) -> None:
        state, i = self.state, self.batch.view(1)
        lr = self.lr_fn(self.hyp, self.epoch, self.batch, self.step)
        self.update_fn(state, self.hyp, lr=lr, noise_on=self.noise_on,
                       is_first_step=self.step == 0, seed=self.seeds.index_select(0, i))
        self.losses.index_copy_(0, i, losses.to(self.losses.dtype)[None])
        self.batch.add_(1)
        self.step.add_(1)


class _EpochProgram(_TrainProgram):
    """One sampler's resident epoch as one program (``make_epoch_fn``'s),
    called once an epoch with that epoch's draws.

    A call copies the batch plan (C, num_batches, batch), the crops and
    flips shaped like it, the steps' noise seeds and the epoch into static
    buffers, resets the in-epoch batch counter and sets the global step
    counter from ``state.step``; then it runs the step once a batch
    (``_Captured``: replays of one capture on the card), a model with
    dropout drawing each chain's masks into static buffers before it. The
    step reads row i of the plan and of the crops and flips by the device
    counter, gathers, normalizes, augments and permutes to NCHW, runs the
    forward, cross entropy and backward (each chain in turn, or every chain
    as one batched pass under ``"vmap"``) with the masks bound, and ends in
    the update (``_TrainProgram``; on a data mesh after the hook's
    all-reduces)."""

    def __init__(self, state: TrainState, images: torch.Tensor, labels: torch.Tensor, *,
                 spec: ImageSpec, num_batches: int, batch_size: int, hyp: dict,
                 noise_on: torch.Tensor, lr_fn: LrFn, update_fn: UpdateFn,
                 chain_strategy: Optional[str] = None, mesh: Optional["Mesh"] = None):
        shards = _data_shards(mesh)
        if batch_size % shards:
            raise ValueError(f"a batch of {batch_size} does not split over {shards} data ranks")
        super().__init__(state, spec=spec, num_batches=num_batches,
                         batch_size=batch_size // shards, hyp=hyp, noise_on=noise_on,
                         lr_fn=lr_fn, update_fn=update_fn, mesh=mesh)
        self.images, self.labels, self.chain_strategy = images, labels, chain_strategy
        self.batch_size = batch_size
        self.plan = torch.zeros(self.shape, dtype=torch.int64, device=self.device)

    def fits(self, split) -> bool:
        """Whether ``split``'s epochs take this program (its batches and spec)."""
        return ((self.shape[1], self.batch_size) == (split.num_batches, split.batch_size)
                and self.spec == split.spec)

    def __call__(self, idx: torch.Tensor, *, epoch: int, seeds, aug: Optional[tuple] = None,
                 dropout_seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """One epoch of every chain, in place, from this epoch's draws (as
        ``train_steps`` takes them: ``idx`` (C, num_batches, batch) or, for
        one chain, (num_batches, batch), whole batches also on a data mesh;
        ``aug`` shaped like it; ``seeds`` the (num_batches,) int64 noise
        seeds, a tensor or a list; ``dropout_seeds[c]`` chain c's dropout
        seed, needed by a model with dropout only). Returns the mean
        training loss, a 0-dim tensor for one chain and (C,) for C, on the
        device; advances ``state.step`` by the epoch's steps."""
        chains, num_batches, _ = self.shape
        self.plan.copy_(self._columns(idx))
        self._begin(epoch=epoch, seeds=seeds, aug=aug, dropout_seeds=dropout_seeds)
        for i in range(num_batches):
            self._run(i)
        self.state.step += num_batches
        mean = self.losses.mean(0)
        return mean[0] if chains == 1 else mean

    def _step(self) -> None:
        """The step (on a data mesh its first segment) that the graph
        captures; every input is read from the device."""
        state = self.state
        state.grads.zero_()
        i = self.batch.view(1)
        rows = self.plan.index_select(1, i).squeeze(1)  # (C, batch)
        aug = self._step_aug(i)
        kw = dict(spec=self.spec, batch_idx=None, dropout_seeds=None, mesh=self.mesh)
        if self.chain_strategy == "vmap":
            losses = _vmap_loss_backward(state, self.images, self.labels, rows, aug=aug,
                                         masks=self.dropout.batched, **kw)
        else:
            batches = [(self.images.index_select(0, r), self.labels.index_select(0, r))
                       for r in rows]
            losses = _chains_loss_backward(state, batches, aug=_per_chain(aug, len(batches)),
                                           masks=self.dropout.per_chain, **kw)
        self._finish(losses)


def make_epoch_fn(state: TrainState, split, images: Optional[torch.Tensor] = None,
                  labels: Optional[torch.Tensor] = None, *, hyp: dict, noise_on: torch.Tensor,
                  lr_fn: LrFn, update_fn: UpdateFn, chain_strategy: Optional[str] = None,
                  mesh: Optional["Mesh"] = None) -> _TrainProgram:
    """The epoch program (the JAX package's ``make_epoch_fn``, or on a
    ``mesh`` its ``_make_sharded_epoch_fn``) of ``state``'s chains: over a
    resident ``split`` whose ``images`` and ``labels`` lie on their device,
    one chain, or C chains in turn or, with ``chain_strategy`` ``"vmap"``,
    batched, in the split's batches and with the crops and flips its spec
    draws; a split with ``epoch`` (a ``data.native.HostStreamingSplit``,
    made with the same mesh) goes to ``make_streaming_step_fn`` or, with
    M > 1 batches a transfer, ``make_streaming_chunk_fn``."""
    if hasattr(split, "epoch"):
        maker = make_streaming_chunk_fn if split.chunk_batches > 1 else make_streaming_step_fn
        return maker(state, split, hyp=hyp, noise_on=noise_on, lr_fn=lr_fn, update_fn=update_fn,
                     mesh=mesh)
    return _EpochProgram(state, images, labels, spec=split.spec,
                         num_batches=split.num_batches, batch_size=split.batch_size, hyp=hyp,
                         noise_on=noise_on, lr_fn=lr_fn, update_fn=update_fn,
                         chain_strategy=chain_strategy, mesh=mesh)


# transfers the host may queue ahead of the card in a streamed program: each
# holds a device copy of its batches until the card has read it
STREAM_AHEAD = 2


def _transfer_layout(split) -> tuple:
    """``(shape, dtype, num_batches)`` of a streamed split's transfers: (M,
    batch, H, W, C) uint8 or float32 (a data rank's rows of each batch),
    and the batches of an epoch."""
    shape = (split.chunk_batches, split.local_batch) + tuple(split.images.shape[1:])
    dtype = torch.uint8 if split.transfer_dtype == "uint8" else torch.float32
    return shape, dtype, split.num_batches


class _StreamProgram(_TrainProgram):
    """``make_streaming_step_fn``'s and ``make_streaming_chunk_fn``'s
    program: one chain's epoch over the transfers of a host stream, M
    batches a transfer (M = 1: a batch), built for a ``TrainState``, its
    hyperparameter tensors and its noise gate, and a transfer layout
    (``_transfer_layout``); the split itself is taken at each call.

    A call copies the epoch's crops and flips ((1, num_batches, batch)),
    noise seeds and epoch into static buffers and resets the counters
    (``_TrainProgram``); then, for each transfer the split's ``epoch``
    yields on the card, it copies the transfer into a static (M, batch, H,
    W, C) buffer and its labels into an (M, batch) one, on the current
    stream (which the stream has made wait for its copy), and runs M steps,
    a model with dropout drawing its masks before each. The step is
    ``stream_steps``' ``train_step``, its inputs read from the device: row
    ``i % M`` of the transfer, for the epoch's batch counter i, normalized
    on the device (uint8) or taken as it is (float32), row i of the crops
    and flips; forward, cross entropy and backward with the masks bound;
    then the update (``_TrainProgram``; on a data mesh, whose split streams
    the rank's rows of every batch, after the hook's all-reduces). One step
    is captured and replayed M times a transfer, whatever M. The host runs
    at most ``STREAM_AHEAD`` transfers ahead of the card. The epoch's loss
    is the mean of the transfers' mean losses, reduced as ``stream_steps``
    reduces it."""

    def __init__(self, state: TrainState, split, *, hyp: dict, noise_on: torch.Tensor,
                 lr_fn: LrFn, update_fn: UpdateFn, mesh: Optional["Mesh"] = None):
        if len(state.modules) != 1:
            raise ValueError("host-streaming epochs are single-chain")
        self.layout = _transfer_layout(split)
        shape, dtype, num_batches = self.layout
        super().__init__(state, spec=split.spec, num_batches=num_batches, batch_size=shape[1],
                         hyp=hyp, noise_on=noise_on, lr_fn=lr_fn, update_fn=update_fn,
                         mesh=mesh)
        self.x = torch.zeros(shape, dtype=dtype, device=self.device)
        self.y = torch.zeros(shape[:2], dtype=torch.int64, device=self.device)

    def fits(self, split) -> bool:
        """Whether ``split``'s transfers take this program (their layout and
        the spec)."""
        return _transfer_layout(split) == self.layout and self.spec == split.spec

    def __call__(self, split, *, epoch: int, seeds, aug: Optional[tuple] = None,
                 dropout_seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """One epoch over the transfers ``split`` streams, in place (the
        draws as ``stream_steps`` takes them); returns the mean training
        loss, a 0-dim device tensor, and advances ``state.step`` by the
        epoch's steps."""
        if not self.fits(split):
            raise ValueError(f"the stream's transfers {_transfer_layout(split)} are not the "
                             f"program's {self.layout}")
        self._begin(epoch=epoch, seeds=seeds, aug=aug, dropout_seeds=dropout_seeds)
        m = self.x.shape[0]
        queued: list = []  # each transfer's end on the card
        chunks = 0
        for x, y in split.epoch(self.device):
            self.x.copy_(x.view(self.x.shape))
            self.y.copy_(y.view(self.y.shape))
            for j in range(m):
                self._run(chunks * m + j)
            chunks += 1
            if self._side is not None:
                queued.append(torch.cuda.Event())
                queued[-1].record()
                if len(queued) > STREAM_AHEAD:
                    queued.pop(0).synchronize()
        if not chunks:
            raise ValueError(f"the stream has {split.n} samples, fewer than one transfer "
                             f"({split.batch_size} x {m})")
        self.state.step += chunks * m
        chunk_means = [losses.mean(0) for losses in self.losses.view(chunks, m, 1)]
        return torch.stack(chunk_means).mean(0)[0]

    def _step(self) -> None:
        """The step (on a data mesh its first segment) that the graph
        captures; every input is read from the device."""
        self.state.grads.zero_()
        i = self.batch.view(1)
        row = torch.remainder(i, self.x.shape[0])
        batch = (self.x.index_select(0, row).squeeze(0), self.y.index_select(0, row).squeeze(0))
        losses = _chains_loss_backward(
            self.state, [batch], spec=self.spec, batch_idx=None,
            aug=_per_chain(self._step_aug(i), 1), dropout_seeds=None, mesh=self.mesh,
            masks=self.dropout.per_chain)
        self._finish(losses)


def make_streaming_step_fn(state: TrainState, split, *, hyp: dict, noise_on: torch.Tensor,
                           lr_fn: LrFn, update_fn: UpdateFn,
                           mesh: Optional["Mesh"] = None) -> _StreamProgram:
    """The streamed epoch of one chain over a ``HostStreamingSplit`` that
    moves a batch a transfer, as one program (the JAX package's
    ``make_streaming_step_fn``, one compiled step a batch, or on a data
    ``mesh``, whose rows the split streams, its
    ``make_sharded_streaming_step_fn``, with its ``run_streaming_epoch``):
    ``fn(split, epoch=, seeds=, aug=, dropout_seeds=)`` runs an epoch as
    ``stream_steps`` does."""
    if split.chunk_batches != 1:
        raise ValueError(f"{split.chunk_batches} batches a transfer: use make_streaming_chunk_fn")
    return _StreamProgram(state, split, hyp=hyp, noise_on=noise_on, lr_fn=lr_fn,
                          update_fn=update_fn, mesh=mesh)


def make_streaming_chunk_fn(state: TrainState, split, *, hyp: dict, noise_on: torch.Tensor,
                            lr_fn: LrFn, update_fn: UpdateFn,
                            mesh: Optional["Mesh"] = None) -> _StreamProgram:
    """The chunked streamed epoch (the JAX package's
    ``make_streaming_chunk_fn``, one compiled scan over a staged chunk of M
    batches, or on a data ``mesh`` its ``make_sharded_streaming_chunk_fn``):
    the same program as ``make_streaming_step_fn``'s, its one captured step
    replayed M times a transfer."""
    return _StreamProgram(state, split, hyp=hyp, noise_on=noise_on, lr_fn=lr_fn,
                          update_fn=update_fn, mesh=mesh)


def stream_steps(
    state: TrainState,
    split,
    *,
    epoch: int,
    noise_on: torch.Tensor,
    hyp: dict,
    lr_fn: LrFn,
    update_fn: UpdateFn,
    seeds: Sequence[int],
    aug: Optional[tuple] = None,
    dropout_seeds: Optional[Sequence[int]] = None,
    mesh: Optional["Mesh"] = None,
) -> torch.Tensor:
    """One epoch of ``train_step`` over the batches a ``HostStreamingSplit``
    streams to the device of ``state`` (one chain), in place; returns the
    mean training loss, a 0-dim device tensor: the plain version of the
    streamed programs (``make_streaming_step_fn``), and the streamed epoch
    of a device mesh. A chunk of M batches trains
    its M steps in turn, batch ``chunk_idx * M + j``, and the epoch's loss
    is the mean of the chunks' mean losses (the JAX package's chunked
    epoch; with M = 1, the mean of the batches'). ``aug`` and ``seeds``
    are indexed by batch, as in ``train_steps`` with one chain. On a data
    mesh the split streams this rank's rows of every batch (it was made
    with the mesh), ``aug`` covers the whole batch and this rank takes its
    columns, and each step is ``train_step``'s sharded one: every replica
    runs the same update."""
    if len(state.modules) != 1:
        raise ValueError("host-streaming epochs are single-chain")
    state.module.train()
    m = split.chunk_batches
    if aug is not None:
        aug = tuple(None if a is None else a.reshape(1, split.num_batches, -1) for a in aug)
        if _data_shards(mesh) > 1:
            mine = mesh.data_rows(split.batch_size)
            aug = tuple(None if a is None else a[..., mine] for a in aug)
    chunk_means = []
    for ci, (x, y) in enumerate(split.epoch(state.params.device)):
        if m == 1:
            x, y = x[None], y[None]
        losses = []
        for j in range(m):
            bi = ci * m + j
            losses.append(train_step(
                state, [(x[j], y[j])], spec=split.spec, epoch=epoch, batch_idx=bi,
                noise_on=noise_on, hyp=hyp, lr_fn=lr_fn, update_fn=update_fn,
                seed=seeds[bi], aug=_aug_at(aug, 1, bi), dropout_seeds=dropout_seeds,
                mesh=mesh))
        chunk_means.append(torch.stack(losses).mean(0))
    if not chunk_means:
        raise ValueError(f"the stream has {split.n} samples, fewer than one transfer "
                         f"({split.batch_size} x {m})")
    return torch.stack(chunk_means).mean(0)[0]


def _padded_batches(n: int, bsz: int, fill, device) -> torch.Tensor:
    """(num_batches, bsz) indices ``arange(n)``, the last batch filled up
    with ``fill(idx, pad)``."""
    nb = -(-n // bsz)
    pad = nb * bsz - n
    idx = torch.arange(n, device=device)
    if pad:
        idx = torch.cat([idx, fill(idx, pad)])
    return idx.view(nb, bsz)


def _sharded_batches(n: int, bsz: int, mesh: Optional["Mesh"], device) -> torch.Tensor:
    """The index batches of a full-data pass: ``arange(n)`` in batches of
    ``bsz``, the last filled up with -1. On a data mesh ``bsz`` is rounded
    down to a multiple of the data axis (one row a rank at least) and the
    result is this rank's (num_batches, bsz / data) columns (the JAX
    package's data-parallel HMC potential and ESS log density)."""
    shards = _data_shards(mesh)
    if shards > 1:
        if n < shards:
            raise ValueError(f"{n} samples do not split over {shards} data ranks")
        bsz = max(shards, bsz - bsz % shards)
    batches = _padded_batches(n, bsz, lambda idx, pad: torch.full_like(idx[:pad], -1), device)
    return batches if shards == 1 else batches[:, mesh.data_rows(bsz)].contiguous()


@torch.no_grad()
def bn_refresh(module: nn.Module, split, *, images: Optional[torch.Tensor] = None,
               dropout_seed: int = 0) -> None:
    """Recompute every ``BatchNorm2d``'s running statistics of ``module``,
    in place, as the exact batch-size-weighted mean of its per-batch
    (biased) statistics over ``split`` (the reference's ``bn_update``).

    Batches are ``arange(n)``, the last filled up with the first ``pad``
    indices; the running variance is reset to 1 first. Each layer's
    momentum is set to b/(count + b) for the batch, so that ``running =
    count/(count + b) * running + b/(count + b) * batch``, and restored
    after. ``images`` is the split on the module's device, if already
    there."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    if not bns:
        return
    device = next(module.parameters()).device
    if images is None:
        images, _ = split.device_tensors(device)
    bsz = split.batch_size
    batches = _padded_batches(split.n, bsz, lambda idx, pad: idx[:pad], device)
    momenta, was_training = [m.momentum for m in bns], module.training
    has_dropout = bool(dropout_layers(module))
    for m in bns:
        m.running_mean.zero_()
        m.running_var.fill_(1.0)
    module.train()
    try:
        count = 0.0
        for bi in range(batches.shape[0]):
            for m in bns:
                m.momentum = bsz / (count + bsz)
            x = normalize(images.index_select(0, batches[bi]), split.spec)
            gen = make_generator(device, dropout_seed, bi) if has_dropout else None
            with dropout_generator(module, gen):
                module(x.permute(0, 3, 1, 2).contiguous())
            count += bsz
    finally:
        for m, mom in zip(bns, momenta):
            m.momentum = mom
        module.train(was_training)


@torch.no_grad()
def eval_loss(module: nn.Module, split, *, state: Optional[StateDict] = None,
              dropout_seed: int = 0) -> torch.Tensor:
    """Mean cross entropy of ``module`` (with ``state`` swapped in, if
    given) over ``split`` in eval mode, a 0-dim tensor on the device. The
    last batch is filled up with index -1 and those rows are masked out."""
    device = next(module.parameters()).device
    images, labels = split.device_tensors(device)
    batches = _padded_batches(split.n, split.batch_size,
                              lambda idx, pad: torch.full_like(idx[:pad], -1), device)
    has_dropout = bool(dropout_layers(module))
    was_training = module.training
    module.eval()
    total = torch.zeros((), dtype=torch.float32, device=device)
    try:
        for bi in range(batches.shape[0]):
            b = batches[bi]
            valid = (b >= 0).to(torch.float32)
            b = b.clamp_min(0)
            x = normalize(images.index_select(0, b), split.spec).permute(0, 3, 1, 2)
            x = x.contiguous()
            gen = make_generator(device, dropout_seed, bi) if has_dropout else None
            with dropout_generator(module, gen):
                logits = module(x) if state is None else functional_call(module, state, (x,))
            ce = F.cross_entropy(logits.to(torch.float32), labels.index_select(0, b),
                                 reduction="none")
            total = total + torch.sum(ce * valid)
    finally:
        module.train(was_training)
    return total / split.n


def _dropout_probe(module: nn.Module, spec: ImageSpec, batch_size: int, training: bool) -> list:
    """``dropout_calls``' ``[(layer, shape)]`` of a forward of ``module`` in
    ``training`` mode on a batch of ``batch_size`` images of ``spec`` (none
    without active dropout)."""
    if not dropout_layers(module):
        return []
    h, w, c = spec.shape
    was_training = module.training
    module.train(training)
    try:
        x = torch.zeros((batch_size, c, h, w), device=next(module.parameters()).device)
        return dropout_calls(module, x)
    finally:
        module.train(was_training)


def _probe_dropout(module: nn.Module, split, training: bool):
    """``(calls, masks)``: ``_dropout_probe`` on a batch of ``split``, and a
    static keep-mask buffer for each call."""
    calls = _dropout_probe(module, split.spec, split.batch_size, training)
    device = next(module.parameters()).device
    return calls, [torch.zeros(shape, dtype=torch.bool, device=device) for _, shape in calls]


def _draw_into(masks: list, calls: list, gen: torch.Generator) -> None:
    """Each layer's keep mask from ``gen``, layer after layer (what a plain
    forward with ``gen`` bound draws), into its static buffer."""
    for buf, (layer, shape) in zip(masks, calls):
        buf.copy_(layer.draw(shape, gen))


class _RefreshProgram(_Captured):
    """``make_bn_refresh_fn``'s program: ``bn_refresh`` over a resident
    split, a step a batch. The step gathers batch i of the plan (``arange(n)``,
    the last batch filled up with the first ``pad`` indices) by the device
    counter, normalizes, runs the module's train-mode forward with every
    ``BatchNorm2d`` under ``batch_stats_out`` (it writes nothing and returns
    its batch's mean and biased variance) and folds them into device
    accumulators with the weight ``count / (count + b)`` of a device count,
    ``acc = w * acc + (1 - w) * batch``: the exact batch-size-weighted mean.
    A call resets the accumulators (mean 0, variance 1), runs the steps and
    writes the running statistics from them. The module's parameters are
    read where they are, so weights copied in place need no new capture.
    A model with dropout draws each batch's masks from
    ``make_generator(device, 0, bi)`` into static buffers before the step,
    as ``bn_refresh`` draws them by default."""

    def __init__(self, module: nn.Module, split, images: torch.Tensor):
        device = next(module.parameters()).device
        super().__init__(device)
        self.module, self.spec, self.images = module, split.spec, images
        self.bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
        self.batch_size = split.batch_size
        self.plan = _padded_batches(split.n, split.batch_size, lambda idx, pad: idx[:pad], device)
        self.batch = torch.zeros((), dtype=torch.int64, device=device)
        self.count = torch.zeros((), dtype=torch.float32, device=device)
        self.means = [torch.zeros_like(m.running_mean) for m in self.bns]
        self.vars = [torch.ones_like(m.running_var) for m in self.bns]
        self.calls, self.masks = _probe_dropout(module, split, training=True)

    @torch.no_grad()
    def __call__(self, eager: bool = False) -> None:
        """Recompute the running statistics of the module's BatchNorm layers,
        in place (``eager``: every step on the current stream, uncaptured)."""
        if not self.bns:
            return
        for mean, var in zip(self.means, self.vars):
            mean.zero_()
            var.fill_(1.0)
        self.batch.zero_()
        self.count.zero_()
        was_training = self.module.training
        self.module.train()
        try:
            for bi in range(self.plan.shape[0]):
                if self.calls:
                    _draw_into(self.masks, self.calls, make_generator(self.device, 0, bi))
                self._advance(eager)
        finally:
            self.module.train(was_training)
        for m, mean, var in zip(self.bns, self.means, self.vars):
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)

    def _step(self) -> None:
        i = self.batch.view(1)
        x = normalize(self.images.index_select(0, self.plan.index_select(0, i).squeeze(0)),
                      self.spec)
        layers = [layer for layer, _ in self.calls]
        with dropout_masks(layers, self.masks), batch_stats_out(self.bns) as stats:
            self.module(x.permute(0, 3, 1, 2).contiguous())
        w = self.count / (self.count + self.batch_size)
        for acc, new in zip(self.means + self.vars,
                            [s[0] for s in stats] + [s[1] for s in stats]):
            acc.mul_(w).add_(new * (1.0 - w))
        self.count.add_(self.batch_size)
        self.batch.add_(1)


def make_bn_refresh_fn(module: nn.Module, split, images: Optional[torch.Tensor] = None
                       ) -> _RefreshProgram:
    """The BatchNorm refresh of ``module`` over ``split`` as one program
    (the JAX package's ``make_bn_refresh_fn``): ``fn()`` recomputes the
    running statistics in place from the module's current weights, as
    ``bn_refresh`` does. ``images`` is the split on the module's device, if
    already there. Build it once and call it for every set of weights
    copied into the module in place."""
    if images is None:
        images, _ = split.device_tensors(next(module.parameters()).device)
    return _RefreshProgram(module, split, images)


class _LossProgram(_Captured):
    """``make_eval_loss_fn``'s program: ``eval_loss`` over a resident split,
    a step a batch. The state it evaluates lies in static buffers (one per
    entry of the module's state dict) that a call copies the given state
    into; the step gathers batch i (the last filled up with index -1, those
    rows masked out) by the device counter, normalizes, runs the eval-mode
    forward on the static state and adds the masked cross entropy's sum to a
    device total. A model whose dropout stays on in eval mode draws each
    batch's masks from ``make_generator(device, 0, bi)`` into static
    buffers before the step, as ``eval_loss`` draws them by default."""

    def __init__(self, module: nn.Module, split):
        device = next(module.parameters()).device
        super().__init__(device)
        self.module, self.spec, self.n = module, split.spec, split.n
        self.images, self.labels = split.device_tensors(device)
        plan = _padded_batches(split.n, split.batch_size,
                               lambda idx, pad: torch.full_like(idx[:pad], -1), device)
        self.valid = (plan >= 0).to(torch.float32)
        self.plan = plan.clamp_min(0)
        self.state = {k: v.detach().clone() for k, v in module.state_dict().items()}
        self.batch = torch.zeros((), dtype=torch.int64, device=device)
        self.total = torch.zeros((), dtype=torch.float32, device=device)
        self.calls, self.masks = _probe_dropout(module, split, training=False)

    @torch.no_grad()
    def __call__(self, state: Optional[StateDict] = None, eager: bool = False) -> torch.Tensor:
        """The mean cross entropy of ``state`` (entries missing from it, or
        all of them without it: the module's own), a 0-dim device tensor
        (``eager``: every step on the current stream, uncaptured)."""
        own = self.module.state_dict()
        for k, buf in self.state.items():
            buf.copy_(own[k] if state is None or k not in state else state[k])
        self.batch.zero_()
        self.total.zero_()
        was_training = self.module.training
        self.module.eval()
        try:
            for bi in range(self.plan.shape[0]):
                if self.calls:
                    _draw_into(self.masks, self.calls, make_generator(self.device, 0, bi))
                self._advance(eager)
        finally:
            self.module.train(was_training)
        return self.total / self.n

    def _step(self) -> None:
        i = self.batch.view(1)
        b = self.plan.index_select(0, i).squeeze(0)
        x = normalize(self.images.index_select(0, b), self.spec).permute(0, 3, 1, 2)
        with dropout_masks([layer for layer, _ in self.calls], self.masks):
            logits = functional_call(self.module, self.state, (x.contiguous(),))
        ce = F.cross_entropy(logits.to(torch.float32), self.labels.index_select(0, b),
                             reduction="none")
        self.total.add_(torch.sum(ce * self.valid.index_select(0, i).squeeze(0)))
        self.batch.add_(1)


def make_eval_loss_fn(module: nn.Module, split) -> _LossProgram:
    """The mean cross entropy over ``split`` in eval mode as one program
    (the JAX package's ``make_eval_loss_fn``): ``fn(state)`` evaluates
    ``state`` (by default the module's own) as ``eval_loss`` does. Build it
    once a split and call it for every state."""
    return _LossProgram(module, split)


POTENTIAL_VARIANTS = {  # variant -> (train-mode forward, backward, Kahan sum)
    "grad": (False, True, True),  # HMC's CE sum and its gradient (_grad_u)
    "ce": (False, False, True),  # HMC's CE sum alone (the chain's first)
    "density": (True, False, False),  # PCA-ESS's tempered log density's CE sum
}


class _PotentialProgram(_Captured):
    """``make_potential_fn``'s program: a CE sum over a resident split in
    the index batches of ``plan`` (the last filled up with index 0, those
    rows masked out by ``valid``), a step a batch, replayed once for each
    batch a call.

    The weights lie in a static flat buffer, ``flat`` ((P,) under the
    module's own parameters, or (C, P) under ``views``, each parameter's (C,
    *shape) view of it, run by one ``ChainForward``), which a call copies
    its argument into; with ``grads`` (the "grad" variant) the flat
    gradient buffer, zeroed at the start of a call, that every parameter's
    ``.grad`` views (``flatten_parameters`` and ``stacked_leaves`` bind
    them), so the backward adds into it in place. The step gathers batch i
    by a device counter, normalizes, runs the forward in the variant's mode
    with the dropout masks bound, takes the masked cross entropy's sum,
    backpropagates it in the "grad" variant, adds it into device ``total``
    and ``comp`` buffers (Kahan's sum, or a plain one for "density") in the
    plain versions' order of operations, and advances the counter. A model
    whose dropout is active in that mode draws each batch's masks from
    ``make_generator(device, 0, bi)`` into static buffers before the step,
    as the plain versions draw them."""

    def __init__(self, module: nn.Module, images: torch.Tensor, labels: torch.Tensor,
                 spec: ImageSpec, plan: torch.Tensor, valid: torch.Tensor, *, variant: str,
                 flat: torch.Tensor, grads: Optional[torch.Tensor] = None,
                 views: Optional[Dict[str, torch.Tensor]] = None,
                 pool: Callable[[], object] = lambda: None):
        super().__init__(flat.device, pool)
        self.training, self.grad, self.kahan = POTENTIAL_VARIANTS[variant]
        if self.grad != (grads is not None):
            raise ValueError(f"the 'grad' variant needs grads and the others take none; "
                             f"got {variant!r}")
        self.module, self.spec = module, spec
        self.images, self.labels, self.plan, self.valid = images, labels, plan, valid
        self.flat, self.grads, self.views = flat, grads, views
        self.forward = None if views is None else ChainForward(module)
        shape = flat.shape[:-1]  # () or (C,)
        self.batch = torch.zeros((), dtype=torch.int64, device=self.device)
        self.total = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.comp = torch.zeros_like(self.total)
        self.calls = _dropout_probe(module, spec, plan.shape[1], self.training)
        self.masks = [torch.zeros(s, dtype=torch.bool, device=self.device) for _, s in self.calls]

    def __call__(self, weights: torch.Tensor) -> torch.Tensor:
        """The CE sum at ``weights`` (shaped as ``flat``): a 0-dim or (C,)
        float32 tensor; in the "grad" variant its gradient is left in
        ``grads``."""
        with torch.no_grad():
            self.flat.copy_(weights)
        if self.grads is not None:
            self.grads.zero_()
        self.batch.zero_()
        self.total.zero_()
        self.comp.zero_()
        was_training = self.module.training
        self.module.train(self.training)
        try:
            with torch.set_grad_enabled(self.grad):
                for bi in range(self.plan.shape[0]):
                    if self.calls:
                        _draw_into(self.masks, self.calls, make_generator(self.device, 0, bi))
                    self._advance()
        finally:
            self.module.train(was_training)
        return self.total.clone()

    def _step(self) -> None:
        i = self.batch.view(1)
        b = self.plan.index_select(0, i).squeeze(0)
        valid = self.valid.index_select(0, i).squeeze(0)
        x = normalize(self.images.index_select(0, b), self.spec).permute(0, 3, 1, 2).contiguous()
        y = self.labels.index_select(0, b)
        layers = [layer for layer, _ in self.calls]
        if self.views is None:
            with dropout_masks(layers, self.masks):
                logits = self.module(x)
            ce = F.cross_entropy(logits.to(torch.float32), y, reduction="none")
            s = torch.sum(ce * valid)
            if self.grad:
                s.backward()
        else:
            logits, _ = self.forward(self.views, x, x_batched=False, layers=layers,
                                     masks=self.masks)
            rows = logits.shape[0]
            ce = F.cross_entropy(logits.to(torch.float32).flatten(0, 1), y.repeat(rows),
                                 reduction="none").view(rows, -1)
            s = torch.sum(ce * valid, dim=1)
            if self.grad:
                backward_into_views(s.sum())
        if self.kahan:
            val = s.detach() - self.comp
            t = self.total + val
            self.comp.copy_((t - self.total) - val)
            self.total.copy_(t)
        else:
            self.total.add_(s)
        self.batch.add_(1)


def make_potential_fn(module: nn.Module, images: torch.Tensor, labels: torch.Tensor,
                      spec: ImageSpec, plan: torch.Tensor, valid: torch.Tensor, *, variant: str,
                      flat: torch.Tensor, grads: Optional[torch.Tensor] = None,
                      views: Optional[Dict[str, torch.Tensor]] = None,
                      pool: Callable[[], object] = lambda: None) -> _PotentialProgram:
    """A full-batch potential over the resident split ``images`` /
    ``labels`` as one program (the JAX package's scan over the data inside
    its compiled HMC chunk and ESS transition): ``fn(weights)`` is the CE
    sum at ``weights``, over the (num_batches, batch) index ``plan`` with
    its 0/1 ``valid`` mask. ``variant`` (``POTENTIAL_VARIANTS``): "grad",
    eval mode, Kahan-summed, its gradient left in ``grads``; "ce", the same
    without it; "density", train mode (BatchNorm's batch statistics), a
    plain sum. ``flat`` is the static weight buffer that ``module``'s
    parameters view, or, with ``views`` ((C, *shape) views of a (C, P)
    ``flat``: leaves whose ``.grad`` views ``grads`` in the "grad" variant),
    C rows as one ``ChainForward``. ``pool`` as ``_Captured`` takes it.
    Build it once and call it for every set of weights."""
    return _PotentialProgram(module, images, labels, spec, plan, valid, variant=variant,
                             flat=flat, grads=grads, views=views, pool=pool)
