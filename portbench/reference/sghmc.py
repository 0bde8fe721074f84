"""SGHMC's first steps, in plain PyTorch: the batches, crops, flips and noise
seeds of a chain's first epoch, the train-mode forward, the architecture's
loss and its gradient, and the update (Chen et al., "Stochastic Gradient
Hamiltonian Monte Carlo", ICML 2014, as the reference URSABench's
``inference/sghmc.py`` runs it):

    d = g + (1 / prior_std**2) / n_train * p
    v = momentum * (first step ? d : v) - lr * d + sqrt(2 alpha lr) / n_train * N(0, 1)
    p = p + v

with momentum = 1 - alpha, and the learning rate of epoch 0 of a cosine
schedule: lr0.

The draws follow the served sampler's documented protocol: sub-seeds are
sha256 of the seed and tags (``derive_seed``); a chain's first run is
``derive_seed(seed, "draw", 1)``; its epoch draws a permutation of the
train set on the device (the last batch filled up from its start), then the
crop offsets in [0, 2 pad] (rows, then columns) and the flips (a uniform
below 1/2), from one generator seeded with ``derive_seed(run, "data")``; the
steps' noise seeds are int64 draws in [0, 2**63 - 1) from a host generator
seeded with ``derive_seed(run, "noise")``. The noise of a CUDA run is
``philox.normals``; of a CPU run ``torch.randn`` under the step's seed.
The architecture prepares each step's rows (``Model.train_batch``: for an
image classifier its normalization, crop and flip) and gives the loss
(``Model.loss``).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional

import torch

from .layers import Precision, Tensors, parameter_leaves
from .models import Model
from .philox import normals


def derive_seed(seed: int, *tags) -> int:
    text = "/".join([str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") & (2 ** 63 - 1)


def _generator(device, seed: int, *tags) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, *tags))
    return gen


def first_epoch_draws(seed: int, n: int, batch: int, crop_pad: int, flip: bool,
                      device) -> Dict[str, Optional[torch.Tensor]]:
    """The batch plan (nb, batch), crops and flips of a chain's first epoch
    and its steps' noise seeds (nb,) int64, from the sampler's seed."""
    run = derive_seed(seed, "draw", 1)
    gen = _generator(device, run, "data")
    nb = -(-n // batch)
    perm = torch.randperm(n, generator=gen, device=gen.device)
    if nb * batch > n:
        perm = torch.cat([perm, perm[:nb * batch - n]])
    out = {"plan": perm.view(nb, batch), "ox": None, "oy": None, "flip": None}
    if crop_pad:
        out["ox"] = torch.randint(0, 2 * crop_pad + 1, (nb, batch), generator=gen, device=device)
        out["oy"] = torch.randint(0, 2 * crop_pad + 1, (nb, batch), generator=gen, device=device)
    if flip:
        out["flip"] = torch.rand((nb, batch), generator=gen, device=device) < 0.5
    host = torch.Generator().manual_seed(derive_seed(run, "noise"))
    out["seeds"] = torch.randint(0, 2 ** 63 - 1, (nb,), generator=host)
    return out


def _noise(seed: int, total: int, device) -> torch.Tensor:
    if torch.device(device).type == "cuda":
        return normals(seed, total, device)
    gen = torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))
    return torch.randn(total, generator=gen)


def sghmc_steps(model: Model, start: Tensors, inputs: torch.Tensor, labels: torch.Tensor,
                draws: dict, hyp: dict, n_train: int, steps: int,
                precision: Precision = Precision(), half_batch: bool = False) -> dict:
    """The chain's first ``steps`` steps from the tensors ``start`` over the
    train split ``inputs`` and ``labels``.

    Returns ``losses`` [steps] (floats), ``grads`` (the first step's
    gradient, by parameter name) and ``params[k]`` (the parameters after
    k + 1 steps, by name). ``half_batch`` takes each loss over the first
    half of the batch only (a fault the comparison has to catch)."""
    leaves = parameter_leaves(model.leaves)
    device = inputs.device
    params = {leaf.name: start[leaf.name].detach().clone().float() for leaf in leaves}
    buffers = {leaf.name: start[leaf.name].detach().clone().float()
               for leaf in model.leaves if leaf.buffer}
    momentum_buf = {k: torch.zeros_like(v) for k, v in params.items()}
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    lr0 = f32(hyp["lr"])
    t_max = f32(max(int(hyp["burn_in_epochs"]) + int(hyp["num_samples"]), 1))
    lr = lr0 * 0.5 * (1.0 + torch.cos(math.pi * f32(0.0) / t_max))  # epoch 0; eta_min 0
    momentum = f32(1.0 - float(hyp["alpha"]))
    wd_over_n = f32((1.0 / float(hyp["prior_std"]) ** 2) / n_train)
    noise_scale = torch.sqrt(2.0 * (1.0 - momentum) * lr) / f32(float(n_train))
    total = sum(leaf.numel for leaf in leaves)
    out: dict = {"losses": [], "grads": None, "params": []}
    for i in range(steps):
        x, y = model.train_batch(inputs, labels, draws, i)
        if half_batch:
            x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
        leaves_now = {k: v.requires_grad_() for k, v in params.items()}
        with precision.active():
            loss = model.loss(model.forward({**leaves_now, **buffers}, x, True, precision), y)
            grads = torch.autograd.grad(loss, list(leaves_now.values()))
        grads = dict(zip(leaves_now, grads))
        out["losses"].append(float(loss.detach()))
        if i == 0:
            out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
        z = _noise(int(draws["seeds"][i]), total, device)
        offset = 0
        with torch.no_grad():
            for leaf in leaves:
                p, g = params[leaf.name].detach(), grads[leaf.name]
                d = g + wd_over_n * p
                v_prev = d if i == 0 else momentum_buf[leaf.name]
                v = momentum * v_prev - lr * d + noise_scale * z[offset: offset + leaf.numel].view(
                    leaf.shape)
                momentum_buf[leaf.name] = v
                params[leaf.name] = p + v
                offset += leaf.numel
        out["params"].append({k: v.detach().clone() for k, v in params.items()})
    return out
