"""Posterior ensembles as one module plus stacked state dicts.

Counterpart of ``ursabench_tpu/inference/ensemble.py``: every entry of
``state`` (parameters and BatchNorm buffers) carries a leading sample axis
S. ``member_logits`` runs the S members on a batch in one of two layouts:
``"vmap"``, one ``torch.func.vmap`` over ``functional_call`` on the stacked
state (the JAX package's ``vmap`` of the member forward), or ``"scan"``,
the members one after another. ``member_strategy`` picks it, by default
``resolve_member_strategy``'s rule at the batch size, precision and input
shape at hand: the layout with the shorter device time on the card. The
tasks' BMA pass (``tasks.base.accumulate_split``) runs it inside one
captured program an ensemble keeps per split; ``logits_all`` runs it
eagerly (``EVAL_PROGRAMS``).

An MCdropout ensemble shares one set of weights (``expand``ed views, not S
copies) and gives each member its own dropout stream: with ``dropout_seed``
set, member i on batch ``batch_idx`` draws its masks from a generator
seeded with (dropout_seed, i, batch_idx), layer after layer (the order of
a plain forward with that generator bound), the counterpart of the JAX
package's ``fold_in(key_i, batch_idx)``.

An ensemble made by a sampler on a device mesh (``parallel.Mesh``) keeps
the mesh. When its chains are sharded over the mesh's 'chain' axis
(``sharded``), ``state`` holds this rank's members only: the chains of its
block, draw-major, as the JAX package orders them; ``num_members`` counts
the members of every rank, and ``gather()`` returns the whole ensemble on
every rank. When the sampler replicated its chains over the chain axis
(``replicated``: the axis does not divide them), every rank holds every
member and nothing is summed over 'chain'. The tasks evaluate it where it
lies (``tasks.base.accumulate_split``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call, vmap

from .. import tracing
from ..models.common import dropout_calls, dropout_layers, dropout_masks
from ..util import StateDict, index_state_dict, make_generator, stack_state_dicts
from .engine import live_pool

# How each evaluation path runs on the card. "graph": a program whose step is
# captured once as a CUDA graph and replayed (engine._Captured; on the CPU the
# same step runs eagerly). "eager": a step at a time from Python, by rule:
# - logits_all: one call on one batch, kept for the two paths below; a
#   program would be built and captured for a single step;
# - latency: Prediction's latency mode times each batch's call, dispatch
#   included, as the reference times a deployed forward;
# - shard_ensemble_eval: parallel.mesh builds a throwaway Ensemble on every
#   call, so a capture would be paid on every call.
EVAL_PROGRAMS = {
    "bma": "graph",  # tasks.base.accumulate_split, every task's pass
    "bn_refresh": "graph",  # engine.make_bn_refresh_fn (SWA, SWAG, PCA-ESS)
    "val_loss": "graph",  # engine.make_eval_loss_fn (compute_val_loss)
    "logits_all": "eager",
    "latency": "eager",
    "shard_ensemble_eval": "eager",
}

MEMBER_STRATEGIES = ("scan", "vmap")

# the largest forward of one member (FLOPs, batch x image) that runs faster
# vmapped than alone, by precision, as measured on an H100 (PERF.md): between
# 11.9 and 127 GFLOP in fp32, 11.9 and 16.4 in bf16, 32.7 and 65.4 in int8
VMAP_FLOPS = {"fp32": 40e9, "bf16": 14e9, "int8": 46e9}


def image_flops(module, spec_shape) -> float:
    """FLOPs of ``module``'s forward on one image of ``spec_shape`` (H, W,
    channels), counted on the meta device from the shapes (eval mode,
    dropout as the identity): nothing is computed or written."""
    from torch.utils.flop_counter import FlopCounterMode

    state = {k: torch.empty_like(v, device="meta") for k, v in
             list(module.named_parameters()) + list(module.named_buffers())}
    h, w, c = spec_shape
    x = torch.empty((1, c, h, w), device="meta")
    was_training, layers = module.training, dropout_layers(module)
    module.eval()
    for m in layers:
        m.calls = []  # a shape probe: the identity
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            functional_call(module, state, (x,))
    finally:
        for m in layers:
            m.calls = None
        module.train(was_training)
    return float(counter.get_total_flops())


def module_cost(module: nn.Module, input_shape):
    """``(flops, convs)``: the FLOPs of ``module``'s forward on one image of
    ``input_shape`` (C, H, W) and whether it has convolutions."""
    c, h, w = input_shape
    convs = any(isinstance(m, nn.Conv2d) for m in module.modules())
    return image_flops(module, (h, w, c)), convs


def member_cost(model: str, num_classes: int, input_shape):
    """``module_cost`` of the registry's ``model`` built on the meta device."""
    from .. import models

    with torch.device("meta"):
        module = models.get_model(model).build(num_classes)
    return module_cost(module, input_shape)


def precision_of(module: nn.Module) -> str:
    """``"bf16"`` for a model that computes in bfloat16 (flax's compute
    ``dtype``), else ``"fp32"``."""
    dtypes = {getattr(m, "compute_dtype", None) for m in module.modules()}
    return "bf16" if torch.bfloat16 in dtypes else "fp32"


def resolve_member_strategy(member_strategy: str, ensemble_size: int, batch_size: int,
                            input_shape, precision: str, image_flops,
                            convs: bool = True) -> str:
    """'auto' picks the strategy with the shorter device time as measured on
    an H100 (PERF.md), from one member's FLOPs on one image (``member_cost``;
    a number, or a function that counts them, called only where the rule
    needs them):
    - at S=1, scan, a plain forward;
    - without convolutions (the MLPs), vmap: one batched matrix product
      a layer, 3-5x faster than the members in turn at every precision and
      batch measured;
    - with convolutions, vmap while one member's forward (batch x
      ``image_flops``) stays within ``VMAP_FLOPS`` of its precision, scan
      above, where the grouped convolutions that vmap over stacked conv
      weights becomes take longer than S plain forwards (PreResNet-20 at
      batch 128 and WideResNet-28x10 and TVResNet-50 at batch 1 under it;
      INResNet50 at batch 1, WRN-28x10 at 128 and TVResNet-50 from batch 2,
      int8 from 8, over it); in fp32 also only at batch 1 and, for inputs
      under 64 pixels high, up to batch 7 (cuDNN's float32 grouped
      convolutions are slow without TF32)."""
    if member_strategy != "auto":
        return member_strategy
    if ensemble_size == 1:
        return "scan"
    if not convs:
        return "vmap"
    if precision == "fp32" and batch_size >= (2 if input_shape[1] >= 64 else 8):
        return "scan"
    if callable(image_flops):
        image_flops = image_flops()
    return "vmap" if batch_size * image_flops <= VMAP_FLOPS[precision] else "scan"


@dataclass
class Ensemble:
    module: nn.Module
    state: StateDict  # each entry (S, ...): this rank's members
    num_members: int  # over every rank
    dropout_seed: Optional[int] = None
    mesh: Any = None  # the parallel.Mesh the members were made on, or None
    chains: int = 1  # members a draw, over every rank
    replicated: bool = False  # every chain rank holds every chain
    member_strategy: str = "auto"  # "scan", "vmap", or "auto": resolve_member_strategy's
    # the evaluation programs built for this ensemble (tasks.base.bma_program),
    # one member's FLOPs and dropout_calls by input shape
    _programs: dict = field(default_factory=dict, repr=False, compare=False)
    _flops: dict = field(default_factory=dict, repr=False, compare=False)
    _calls: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def sharded(self) -> bool:
        """Whether the members are split over the mesh's chain ranks."""
        return (self.mesh is not None and self.mesh.shape["chain"] > 1 and self.chains > 1
                and not self.replicated)

    @property
    def local_members(self) -> int:
        return next(iter(self.state.values())).shape[0]

    def gather(self) -> "Ensemble":
        """The whole ensemble, draw-major, on every rank, without a mesh
        (a collective over the chain ranks when ``sharded``: every rank
        calls it)."""
        if self.mesh is None:
            return self
        state = self.state
        if self.sharded:  # (S, local) blocks into zero-filled (S, chains), summed over 'chain'
            cs, c = self.mesh.shape["chain"], self.mesh.chain_idx
            local = self.chains // cs
            state = {}
            for k, v in self.state.items():
                blocks = v.reshape((-1, local) + tuple(v.shape[1:]))
                state[k] = blocks.new_zeros((blocks.shape[0], self.chains) + tuple(v.shape[1:]))
                state[k][:, c * local:(c + 1) * local] = blocks
            self.mesh.all_reduce_many(list(state.values()), "chain")
            state = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in state.items()}
        return Ensemble(self.module, state, self.num_members, self.dropout_seed,
                        member_strategy=self.member_strategy)

    @staticmethod
    def from_list(module: nn.Module, states: Sequence[StateDict]) -> "Ensemble":
        return Ensemble(module, stack_state_dicts(states), len(states))

    @property
    def device(self) -> torch.device:
        return next(iter(self.state.values())).device

    def member(self, i: int) -> StateDict:
        return index_state_dict(self.state, i)

    def graph_pool(self):
        """The memory pool of a live graph of this ensemble's programs, which
        never run at the same time: a new capture shares it (None: no graph
        lives, a new pool)."""
        return live_pool(self._programs.values())

    def strategy(self, batch_size: int, input_shape) -> str:
        """The members' layout on batches of ``batch_size`` NCHW images of
        ``input_shape`` (C, H, W): ``member_strategy``, or the rule's pick
        for the whole ensemble at the module's precision. On a mesh every
        rank takes the layout of one process, whatever its share of the
        members or rows, so each member's logits are the same there."""
        if self.member_strategy != "auto":
            if self.member_strategy not in MEMBER_STRATEGIES:
                raise ValueError(f"member_strategy must be 'auto' or one of "
                                 f"{MEMBER_STRATEGIES}, got {self.member_strategy!r}")
            return self.member_strategy
        key = tuple(input_shape)

        def flops() -> float:  # counted once a shape, where the rule reads it
            if key not in self._flops:
                self._flops[key] = module_cost(self.module, key)[0]
            return self._flops[key]

        convs = any(isinstance(m, nn.Conv2d) for m in self.module.modules())
        return resolve_member_strategy("auto", self.num_members, batch_size, key,
                                       precision_of(self.module), flops, convs)

    def dropout_calls(self, x: torch.Tensor) -> list:
        """``[(layer, input shape)]`` of the dropout layers an eval-mode
        forward on the NCHW batch ``x`` draws from, in order (none without
        ``dropout_seed``); probed once a shape."""
        if self.dropout_seed is None:
            return []
        key = tuple(x.shape)
        if key not in self._calls:
            was_training = self.module.training
            self.module.eval()
            try:
                self._calls[key] = dropout_calls(self.module, x)
            finally:
                self.module.train(was_training)
        return self._calls[key]

    def draw_masks(self, calls: list, batch_idx: int, out: Optional[list] = None) -> list:
        """The members' keep masks on batch ``batch_idx``, one (S, *shape)
        tensor a layer of ``calls``: member i's from ``make_generator(device,
        dropout_seed, i, batch_idx)``, layer after layer. With ``out`` they
        are written into those buffers."""
        gens = [make_generator(self.device, self.dropout_seed, i, batch_idx)
                for i in range(self.local_members)]
        drawn = [[layer.draw(shape, gen) for layer, shape in calls] for gen in gens]
        masks = [torch.stack(col) for col in zip(*drawn)]
        if out is None:
            return masks
        for buf, m in zip(out, masks):
            buf.copy_(m)
        return out

    def member_logits(self, x: torch.Tensor, strategy: str, layers=(), masks=(),
                      forward_ns: Optional[list] = None) -> torch.Tensor:
        """(S, B, C) eval-mode logits of every member held here on the NCHW
        batch ``x``, in layout ``strategy`` (``"vmap"`` or ``"scan"``);
        ``masks[l]`` (S, *shape) are ``layers[l]``'s keep masks, row i
        member i's. ``forward_ns``, a list, gets the host ns spent inside
        the members' forwards (each member's ``functional_call``, or the one
        ``vmap``) appended."""
        module = self.module
        was_training = module.training
        module.eval()
        try:
            if strategy == "vmap":
                def one(state, member_masks):
                    with dropout_masks(layers, member_masks):
                        return functional_call(module, state, (x,))

                with tracing.span("ensemble.member_forward"):
                    t0 = time.perf_counter_ns()
                    out = vmap(one, in_dims=(0, 0 if masks else None))(self.state, list(masks))
                    ns = time.perf_counter_ns() - t0
            else:
                outs, ns = [], 0
                for i in range(self.local_members):
                    with tracing.span("ensemble.member_state"):
                        state = self.member(i)
                    with tracing.span("ensemble.member_forward"), \
                            dropout_masks(layers, [m[i] for m in masks]):
                        t0 = time.perf_counter_ns()
                        outs.append(functional_call(module, state, (x,)))
                        ns += time.perf_counter_ns() - t0
                with tracing.span("ensemble.stack"):
                    out = torch.stack(outs)
            if forward_ns is not None:
                forward_ns.append(ns)
            return out
        finally:
            module.train(was_training)

    @torch.no_grad()
    def logits_all(self, x: torch.Tensor, batch_idx: int = 0) -> torch.Tensor:
        """(S, B, C) eval-mode logits of every member held here for an
        NCHW batch, the ``batch_idx``-th of its pass: ``member_logits`` in
        ``strategy``'s layout, run eagerly (``EVAL_PROGRAMS``). Counted in
        ``tracing``'s ``ensemble.logits_all``: the call's host ns, and those
        inside the members' forwards."""
        with tracing.span("ensemble.logits_all"):
            t0 = time.perf_counter_ns()
            calls = self.dropout_calls(x)
            masks = self.draw_masks(calls, batch_idx) if calls else ()
            forward_ns = []
            out = self.member_logits(x, self.strategy(x.shape[0], tuple(x.shape[1:])),
                                     [layer for layer, _ in calls], masks, forward_ns)
            tracing.logits_all(time.perf_counter_ns() - t0, sum(forward_ns))
        return out
