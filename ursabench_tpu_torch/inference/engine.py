"""Training machinery for the epoch-driven samplers.

Counterpart of ``ursabench_tpu/inference/engine.py:54-313`` and ``:733-857``.
The JAX package compiles one epoch into a ``lax.scan``; here an epoch is two
pieces: ``epoch_indices`` draws the shuffled batch plan and ``train_steps``
runs it, step by step, eagerly: gather -> normalize -> augment -> forward,
cross entropy, backward -> learning rate -> parameter update. That step,
from normalize on, is ``train_step``; ``stream_steps`` runs it over the
batches a ``data.native.HostStreamingSplit`` streams from the host (the
JAX package's ``run_streaming_epoch`` and its chunked epoch), where the
stream's permutation takes the place of the batch plan.

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
functions) the state is one rank's block of chains (``TrainState.row_offset``
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
same distribution through another stream).

``bn_refresh`` recomputes BatchNorm's running statistics with one exact
pass over a split; ``eval_loss`` is the mean cross entropy over a split in
eval mode.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, vmap

from ..data.transforms import ImageSpec, augment_normalized, normalize
from ..models.common import (BatchNorm2d, batch_stats_out, dropout_calls, dropout_generator,
                             dropout_layers, dropout_masks)
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
    shards = _data_shards(mesh)
    state.grads.zero_()
    losses = []
    for c, module in enumerate(state.modules):
        x, y = batches[c]
        if not x.is_floating_point():
            x = normalize(x, spec)
        if aug is not None:
            x = augment_normalized(x, spec, *aug[c])
        x = x.permute(0, 3, 1, 2).contiguous()
        gen = (None if dropout_seeds is None
               else _dropout_gen(x.device, dropout_seeds[c], batch_idx, mesh))
        with dropout_generator(module, gen):
            loss = _batch_loss(module(x), y, shards)
        loss.backward()
        losses.append(loss.detach())
    losses = torch.stack(losses)
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
    chains, bsz = idx.shape
    fwd, leaves, bns = state.batched()
    state.grads.zero_()
    flat = idx.reshape(-1)
    x, y = images.index_select(0, flat), labels.index_select(0, flat)
    if not x.is_floating_point():
        x = normalize(x, spec)
    if aug is not None:
        x = augment_normalized(x, spec, *(None if a is None else a.reshape(-1) for a in aug))
    x = x.permute(0, 3, 1, 2).contiguous()
    x = x.view((chains, bsz) + tuple(x.shape[1:]))
    layers, masks = (), ()
    if dropout_layers(fwd.module):
        if dropout_seeds is None:
            raise RuntimeError("active Dropout without a generator: a model with dropout "
                               "needs dropout_seeds")
        layers, masks = fwd.masks(x[0], [_dropout_gen(x.device, s, batch_idx, mesh)
                                         for s in dropout_seeds])
    logits, stats = fwd(leaves, x, x_batched=True, layers=layers, masks=masks,
                        masks_batched=chains > 1)
    ce = F.cross_entropy(logits.reshape(chains * bsz, -1), y, reduction="none").view(chains, bsz)
    shards = _data_shards(mesh)
    losses = ce.mean(1) if shards == 1 else ce.sum(1) / (bsz * shards)
    backward_into_views(losses.sum())
    if stats:
        fold_batch_stats(bns, stats)
    losses = losses.detach()
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
) -> torch.Tensor:
    """One epoch of ``train_step`` over the batches a ``HostStreamingSplit``
    streams to the device of ``state`` (one chain), in place; returns the
    mean training loss, a 0-dim device tensor. A chunk of M batches trains
    its M steps in turn, batch ``chunk_idx * M + j``, and the epoch's loss
    is the mean of the chunks' mean losses (the JAX package's chunked
    epoch; with M = 1, the mean of the batches'). ``aug`` and ``seeds``
    are indexed by batch, as in ``train_steps`` with one chain."""
    if len(state.modules) != 1:
        raise ValueError("host-streaming epochs are single-chain")
    state.module.train()
    m = split.chunk_batches
    if aug is not None:
        aug = tuple(None if a is None else a.reshape(1, split.num_batches, -1) for a in aug)
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
                seed=seeds[bi], aug=_aug_at(aug, 1, bi), dropout_seeds=dropout_seeds))
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
