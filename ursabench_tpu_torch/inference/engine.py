"""Training machinery for the epoch-driven samplers, single chain.

Counterpart of ``ursabench_tpu/inference/engine.py:54-313``. The JAX package
compiles one epoch into a ``lax.scan``; here an epoch is two pieces:
``epoch_indices`` draws the shuffled batch plan and ``train_steps`` runs it,
step by step, eagerly: gather -> normalize -> augment -> forward, cross
entropy, backward -> learning rate -> parameter update.

The parameters, the momentum and the gradients of a model are views into
one flat float32 buffer each (``flatten_parameters``). Autograd adds each
gradient into its ``.grad`` view in place, so the whole model's update is
one call on three flat buffers: kernel K1 on the GPU. The gradient buffer
is zeroed with ``zero_()`` before each backward, never set to None.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..data.transforms import ImageSpec, augment_normalized, normalize

# (hyp, epoch, batch_idx, global_step) -> lr, a 0-dim device tensor
LrFn = Callable[..., torch.Tensor]
# (state, hyp, *, lr, noise_on, is_first_step, seed) -> None, in place
UpdateFn = Callable[..., None]


@dataclass
class TrainState:
    """One chain: ``module``'s parameters and gradients are views into
    ``params`` and ``grads``; its BatchNorm buffers are the batch stats."""

    module: nn.Module
    params: torch.Tensor  # flat float32
    momentum: torch.Tensor  # flat float32
    grads: torch.Tensor  # flat float32
    step: int = 0  # global batch counter


def flatten_parameters(module: nn.Module):
    """Re-home every parameter of ``module`` (and its ``.grad``) as a view
    into one flat float32 buffer; returns ``(params, grads)``. Parameters
    keep their values; gradients start at zero."""
    plist = list(module.parameters())
    device = plist[0].device
    total = sum(p.numel() for p in plist)
    flat_p = torch.empty(total, dtype=torch.float32, device=device)
    flat_g = torch.zeros(total, dtype=torch.float32, device=device)
    offset = 0
    with torch.no_grad():
        for p in plist:
            if p.dtype != torch.float32 or p.device != device:
                raise ValueError("flat buffers need float32 parameters on one device")
            k = p.numel()
            flat_p[offset: offset + k].copy_(p.reshape(-1))
            p.data = flat_p[offset: offset + k].view_as(p)
            p.grad = flat_g[offset: offset + k].view_as(p)
            offset += k
    return flat_p, flat_g


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
) -> torch.Tensor:
    """Run one training step per row of ``idx`` on ``state`` in place and
    return the mean training loss, a 0-dim tensor on the device (not read
    back). ``images`` (uint8 NHWC) and ``labels`` live on the device;
    ``aug`` is ``(ox, oy, flip)`` from ``draw_augment`` with the same
    leading shape as ``idx``, or None for no augmentation; ``seeds[i]``
    keys step i's Langevin noise."""
    module = state.module
    module.train()
    losses = []
    for bi in range(idx.shape[0]):
        b = idx[bi]
        x = normalize(images.index_select(0, b), spec)
        if aug is not None:
            ox, oy, flip = (None if a is None else a[bi] for a in aug)
            x = augment_normalized(x, spec, ox, oy, flip)
        x = x.permute(0, 3, 1, 2).contiguous()
        y = labels.index_select(0, b)
        state.grads.zero_()
        loss = cross_entropy_mean(module(x), y)
        loss.backward()
        lr = lr_fn(hyp, epoch, bi, state.step)
        update_fn(state, hyp, lr=lr, noise_on=noise_on,
                  is_first_step=state.step == 0, seed=seeds[bi])
        state.step += 1
        losses.append(loss.detach())
    return torch.stack(losses).mean()
