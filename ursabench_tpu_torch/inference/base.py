"""Sampler protocol: the constructor takes (hyperparameters, model, train
split); ``update_hyp`` re-initialises; ``sample_iterative`` returns one
posterior draw; ``sample`` returns the ``Ensemble``.

Counterpart of ``ursabench_tpu/inference/base.py``, plus the chain
bookkeeping that every epoch-driven sampler of
``ursabench_tpu/inference/{sgmcmc,sgd_map,swa}.py`` shares
(``_EpochSampler``). Randomness comes from ``seed`` through generators
seeded with sha256-derived sub-seeds, one per purpose, where the JAX
package splits a PRNG key.

``mesh`` (a ``parallel.Mesh`` of the process group) shards the chains over
its chain ranks and every batch over its data ranks. A rank holds the block
of ``chains / chain`` chains ``mesh.chain_block`` gives, and each keeps its
global identity: its initial weights, batch plans, crops, flips and dropout
seeds are those chain c draws in one process, and K1 draws its block of the
noise (``TrainState.row_offset``). The rank's block advances by the
one-device ``chain_strategy`` rule for its own chain count (the JAX
package's local decision). A mesh of one rank is no mesh.

Mid-chain checkpoints (``enable_auto_checkpoint``): an epoch sampler saves
its chain state every N epochs (``utils_checkpoint.save_sampler_state``)
and restores it at once; HMC and the PCA subspace sampler save theirs every
N draws and resume inside ``sample()``.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional

import torch

from ..data.transforms import draw_augment
from ..models.common import dropout_layers
from ..util import StateDict, derive_seed, make_generator, stack_state_dicts
from .engine import (TrainState, epoch_indices, eval_loss, flatten_chains,
                     init_variables, stream_steps, train_steps)
from .ensemble import Ensemble


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` (CUDA when None). Raises when CUDA
    is asked for and absent: nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return device


# "auto"'s thresholds: one image's forward FLOPs (FlopCounterMode's count,
# two a multiply-add) up to which vmap wins at C >= 2 and at C >= 8 chains.
# Measured by chip_smoke.py's "chains" phase on an NVIDIA H100 80GB HBM3 at
# 700.00 W (the first column of PERF.md section 6's table), SGHMC at batch 128,
# vmap over scan
# aggregate step-forwards/s at C = 1 / 2 / 4 / 8: MLP200MNIST 0.57 / 1.06 /
# 1.93 / 3.05, LeNet5MNIST (0.83 MFLOP) 0.62 / 1.03 / 1.74 / 3.19,
# PreResNet-20 fp32 (82 MFLOP) 0.58 / 0.77 / 1.06 / 1.64, WideResNet-28x10
# bf16 (11.9 GFLOP) 0.69 / 0.56 / 0.66 at C = 1 / 2 / 4.
VMAP_IMAGE_FLOPS = {2: 2e6, 8: 2e8}


def image_flops(module, spec_shape) -> float:
    """FLOPs of ``module``'s forward on one image of ``spec_shape`` (H, W,
    channels), counted on the meta device from the shapes (eval mode,
    dropout as the identity): nothing is computed or written."""
    from torch.func import functional_call
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


def resolve_chain_strategy(strategy: str, module, spec_shape, chains: int = 2) -> str:
    """``"scan"`` or ``"vmap"`` for ``chains`` chains of ``module`` on inputs
    of ``spec_shape`` (H, W, channels): how they advance on one device.
    Either way one update serves every chain a step. ``"scan"`` runs the
    chains' forwards and backwards in turn; ``"vmap"`` runs one batched
    forward and backward over chain-stacked weights, where a convolution
    becomes a grouped one. ``"auto"``, from the card's measurements
    (``VMAP_IMAGE_FLOPS``): vmap without convolution kernels (the MLPs) and,
    with them, while one image's forward stays within the threshold of the
    chain count (LeNet5 from 2 chains, PreResNet-20 from 8); scan above
    (WideResNet-28x10), where the grouped convolutions cost more than the
    launches vmap saves."""
    if strategy not in ("auto", "scan", "vmap"):
        raise ValueError(f"unknown chain_strategy {strategy!r}")
    if strategy != "auto":
        return strategy
    if not any(p.dim() == 4 for p in module.parameters()):
        return "vmap"
    limit = max((f for c, f in VMAP_IMAGE_FLOPS.items() if chains >= c), default=0.0)
    return "vmap" if limit and image_flops(module, spec_shape) <= limit else "scan"


def check_mesh(mesh, chains: int, batch_size: Optional[int]):
    """``mesh`` for a sampler of ``chains`` chains, or None for no mesh (or
    one of a single rank). Raises where its chain axis does not divide
    ``chains`` or its data axis does not divide the batch."""
    if mesh is None or mesh.size == 1:
        return None
    if chains % mesh.shape["chain"]:
        raise ValueError(f"{chains} chains do not split over a chain axis of "
                         f"{mesh.shape['chain']}")
    if batch_size is not None and batch_size % mesh.shape["data"]:
        raise ValueError(f"a batch of {batch_size} does not split over "
                         f"{mesh.shape['data']} data ranks")
    return mesh


class _Inference:
    def __init__(
        self,
        hyperparameters: Optional[dict],
        model=None,  # torch module
        train=None,  # DataSplit
        model_loss: str = "multi_class_linear_output",
        seed: int = 0,
        chains: int = 1,
        device=None,
        chain_strategy: str = "auto",
        mesh=None,
    ):
        if model_loss != "multi_class_linear_output":
            raise NotImplementedError(model_loss)
        if int(chains) < 1:
            raise ValueError(f"chains must be >= 1, got {chains}")
        self.chains = int(chains)
        self.mesh = check_mesh(mesh, self.chains, getattr(train, "batch_size", None))
        # this rank's chains, as global indices (all of them without a mesh)
        self.chain_ids = (range(self.chains) if self.mesh is None
                          else self.mesh.chain_block(self.chains))
        self.chain_strategy = chain_strategy
        self.device = resolve_device(device)
        self.module = model.to(self.device)
        self.train = train
        self.model_loss = model_loss
        self.seed = int(seed)
        # the resolved strategy of this rank's chains (None for one), as the
        # JAX package records it
        local = len(self.chain_ids)
        self._resolved_chain_strategy = (
            resolve_chain_strategy(chain_strategy, self.module, train.spec.shape, local)
            if local > 1 else None)
        self.hyperparameters = hyperparameters
        self._draws = 0
        self._ckpt_path: Optional[str] = None
        self._ckpt_every = 1

    # -- protocol ------------------------------------------------------------

    def update_hyp(self, hyperparameters: dict):
        raise NotImplementedError

    def sample_iterative(self):
        raise NotImplementedError

    def sample(self, num_samples: Optional[int] = None) -> Ensemble:
        raise NotImplementedError

    # -- shared helpers --------------------------------------------------------

    @staticmethod
    def run_seed(seed: int, draw: int) -> int:
        """The ``draw``-th ``next_seed`` of a sampler seeded with ``seed``."""
        return derive_seed(seed, "draw", draw)

    def next_seed(self) -> int:
        """A fresh sub-seed of ``seed`` (the counterpart of splitting the
        sampler's PRNG key)."""
        self._draws += 1
        return self.run_seed(self.seed, self._draws)

    def fresh_variables(self, module=None, run: Optional[int] = None,
                        chain: int = 0) -> StateDict:
        """(Re-)initialise ``module`` (the sampler's by default) in place
        with the JAX package's initialisers, from a fresh sub-seed or from
        ``run`` (chain c > 0 on its own stream of it); returns its state
        dict (views, not copies)."""
        module = self.module if module is None else module
        run = self.next_seed() if run is None else run
        init_variables(module, make_generator("cpu", run, "init", *((chain,) if chain else ())))
        return module.state_dict()

    def compute_val_loss(self, val_split, state: Optional[StateDict] = None) -> float:
        """Mean cross entropy over ``val_split`` in eval mode, of ``state``
        or, by default, of chain 0's current weights."""
        if state is None:
            state = self._single_member()
        return float(eval_loss(self.module, val_split, state=state))

    def _single_member(self) -> StateDict:
        raise NotImplementedError

    def _ensemble_from_draws(self, draws) -> Ensemble:
        """S draws -> an ensemble of S * chains members, draw-major (the
        JAX package's (S, chains) -> (S * chains) merge); on a mesh this
        rank holds its chains' S * chains / chain of them."""
        state = stack_state_dicts(draws)
        if self.chains > 1:
            state = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in state.items()}
        return Ensemble(self.module, state, len(draws) * self.chains, mesh=self.mesh,
                        chains=self.chains)

    # -- mid-chain checkpoints ---------------------------------------------------

    def enable_auto_checkpoint(self, path: str, every_epochs: int = 10,
                               resume: bool = True) -> bool:
        """Save the chain to ``path`` every ``every_epochs`` epochs (draws,
        for HMC and the PCA subspace sampler); with ``resume``, restore an
        existing checkpoint there. Returns True if one was restored."""
        if self.mesh is not None:
            raise NotImplementedError("checkpoints of a sampler sharded over a device mesh "
                                      "are not ported yet (ROADMAP.md open item 15f)")
        self._ckpt_path = path
        self._ckpt_every = max(1, int(every_epochs))
        if resume and os.path.exists(path):
            self._restore_checkpoint(path)
            return True
        return False

    def _checkpoint_due(self, count: int) -> bool:
        return self._ckpt_path is not None and count % self._ckpt_every == 0

    def _restore_checkpoint(self, path: str) -> None:
        raise NotImplementedError


class _EpochSampler(_Inference):
    """C chains (``self.modules``), each with its own module and so its own
    BatchNorm buffers, batch plans, crops and flips (``self._data_gens``)
    and dropout streams (``self._dropout_gens``); their parameters, momenta
    and gradients are the rows of one (C, P) buffer each (``self._state``).
    Hyperparameters live in 0-dim device tensors (``self._hyp``, keys
    ``_HYP_KEYS``) that ``_setup`` fills in place, so changing them rebuilds
    nothing; the Langevin noise gate is one more (``self._noise_gate``). A
    sweep (``inference/vectorized.py``) makes the chains its configurations,
    with (C,) hyperparameter tensors and each row's generators.

    A train split with ``epoch`` (``data.native.HostStreamingSplit``) stays
    on the host: each epoch streams its batches through ``engine.
    stream_steps``, one chain only, and the split's permutation takes the
    place of the data generator's (which still draws the crops and flips).

    On a mesh ``self.modules`` are this rank's chains (``chain_ids``) and
    ``self.chains`` counts every rank's; the epoch is ``engine.
    train_steps``'s sharded one."""

    _HYP_KEYS: tuple = ()
    _LR_FN = None  # (hyp, epoch, batch_idx, step) -> lr
    _UPDATE_FN = None  # (state, hyp, *, lr, noise_on, is_first_step, seed)

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, chain_strategy="auto", mesh=None):
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, chain_strategy, mesh)
        self._streamed = hasattr(train, "epoch")
        if not self._streamed:
            self._images, self._labels = train.device_tensors(self.device)
        elif self.mesh is not None:
            raise NotImplementedError("streamed epochs over a device mesh are not ported "
                                      "yet (ROADMAP.md open item 15e)")
        elif self.chains > 1:
            raise ValueError(f"host-streaming epochs are single-chain: chains={self.chains}")
        else:
            self._images = self._labels = None
        self.modules = [self.module] + [copy.deepcopy(self.module)
                                        for _ in range(len(self.chain_ids) - 1)]
        params, grads = flatten_chains(self.modules)
        self._state = TrainState(self.module, params, torch.zeros_like(params), grads,
                                 modules=self.modules, row_offset=self.chain_ids[0],
                                 total_rows=self.chains)
        self._hyp = {k: torch.zeros((), dtype=torch.float32, device=self.device)
                     for k in self._HYP_KEYS}
        self._noise_gate = torch.ones((), dtype=torch.float32, device=self.device)
        self._has_dropout = bool(dropout_layers(self.module))
        self.epoch_losses: list = []  # mean training loss per epoch, on the device

    def _fill_hyp(self, values: dict) -> None:
        for k, v in values.items():
            self._hyp[k].fill_(v)

    def _init_state(self):
        """Fresh weights, zero momentum, step 0, and fresh generators."""
        run = self.next_seed()
        for c, module in zip(self.chain_ids, self.modules):
            self.fresh_variables(module, run, c)
        self._state.momentum.zero_()
        self._state.grads.zero_()
        self._state.step = 0
        self.epochs_run = 0
        self.burnt_in = False
        # permutations and crop/flip choices are drawn on the device; the
        # per-step noise seeds and per-epoch dropout seeds on the host
        self._data_gens = [make_generator(self.device, run, "data", *((c,) if c else ()))
                           for c in self.chain_ids]
        self._noise_gen = self._noise_generator(run)
        # (generator, rows): the chains' dropout seeds, drawn in row order for
        # every chain; this rank keeps ``_dropout_rows`` of them
        self._dropout_gens = [(torch.Generator().manual_seed(derive_seed(run, "dropout")),
                               self.chains)]
        self._dropout_rows = slice(self.chain_ids[0], self.chain_ids[-1] + 1)

    @staticmethod
    def _noise_generator(run: int) -> torch.Generator:
        """The host generator of the steps' noise seeds of run ``run``."""
        return torch.Generator().manual_seed(derive_seed(run, "noise"))

    def _run_epoch(self, noise_on: Optional[bool] = None) -> torch.Tensor:
        """One epoch on every chain; ``noise_on`` sets the noise gate first
        (None keeps it)."""
        if noise_on is not None:
            self._noise_gate.fill_(1.0 if noise_on else 0.0)
        split = self.train
        if self._streamed:  # stream_steps refuses a sweep's K rows
            shape = (1, split.num_batches, split.batch_size)
        else:
            idx = torch.stack([epoch_indices(g, split.n, split.batch_size)
                               for g in self._data_gens])
            shape = tuple(idx.shape)
        aug = None
        if split.spec.augments:
            draws = [draw_augment(g, shape[1:], split.spec) for g in self._data_gens]
            aug = tuple(None if draws[0][j] is None else torch.stack([d[j] for d in draws])
                        for j in range(3))
        seeds = torch.randint(0, 2 ** 63 - 1, (shape[1],),
                              generator=self._noise_gen).tolist()
        dropout_seeds = ([s for gen, rows in self._dropout_gens
                          for s in torch.randint(0, 2 ** 63 - 1, (rows,), generator=gen).tolist()
                          ][self._dropout_rows] if self._has_dropout else None)
        kw = dict(epoch=self.epochs_run, noise_on=self._noise_gate, hyp=self._hyp,
                  lr_fn=self._LR_FN, update_fn=self._UPDATE_FN, seeds=seeds, aug=aug,
                  dropout_seeds=dropout_seeds)
        if self._streamed:
            loss = stream_steps(self._state, split, **kw)
        else:
            loss = train_steps(self._state, self._images, self._labels, idx, spec=split.spec,
                               chain_strategy=self._resolved_chain_strategy, mesh=self.mesh,
                               **kw)
        self.epochs_run += 1
        self.epoch_losses.append(loss)
        return loss

    def _log_val_loss(self, loss, val_loader, debug_val_loss: bool) -> None:
        if debug_val_loss and val_loader is not None:
            print({"train_loss": float(loss.mean()),
                   "val_loss": self.compute_val_loss(val_loader)})

    def _harvest(self) -> StateDict:
        """A copy of every chain's parameters and BatchNorm buffers (this
        rank's, on a mesh), with a leading chain axis when the sampler has
        more than one chain."""
        states = [{k: v.detach().clone() for k, v in m.state_dict().items()}
                  for m in self.modules]
        return states[0] if self.chains == 1 else stack_state_dicts(states)

    def _single_member(self) -> StateDict:
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def _generators(self) -> Dict[str, torch.Generator]:
        """Every generator the chains draw from, by a stable name."""
        gens = {f"data{c}": g for c, g in enumerate(self._data_gens)}
        gens["noise"] = self._noise_gen
        gens.update({f"dropout{i}": g for i, (g, _) in enumerate(self._dropout_gens)})
        return gens

    def _maybe_checkpoint(self) -> None:
        if self._checkpoint_due(self.epochs_run):
            from ..utils_checkpoint import save_sampler_state

            save_sampler_state(self._ckpt_path, self)

    def _restore_checkpoint(self, path: str) -> None:
        from ..utils_checkpoint import restore_sampler_state

        restore_sampler_state(path, self)
