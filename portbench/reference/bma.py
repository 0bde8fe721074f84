"""Bayesian model averaging over an ensemble, in plain PyTorch, as the
reference URSABench's prediction task accumulates it: each member's
eval-mode logits, their softmax, and over the members the sum of the
probabilities and the sum of the entropies of the centrally smoothed
probabilities ((1 - g) p + g / C, g = 1e-4; Malinin et al.).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .layers import Precision
from .models import Model

GAMMA = 1e-4


def member(stacked: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in stacked.items()}


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> normalized float32 NCHW."""
    m = torch.tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.tensor(std, dtype=torch.float32, device=images.device)
    return ((images.to(torch.float32) / 255.0 - m) / s).permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def logits(model: Model, stacked: Dict[str, torch.Tensor], x: torch.Tensor,
           precision: Precision = Precision()) -> torch.Tensor:
    """(S, B, C) float32 eval-mode logits of every member on the NCHW batch."""
    members = next(iter(stacked.values())).shape[0]
    with precision.active():
        return torch.stack([model.forward(member(stacked, i), x, False, precision).float()
                            for i in range(members)])


def sums(member_logits: torch.Tensor):
    """(probability sums (B, C), entropy sums (B,)) over the members, float64."""
    p = torch.softmax(member_logits.double(), dim=-1)
    smoothed = (1.0 - GAMMA) * p + GAMMA / p.shape[-1]
    entropy = -(smoothed * torch.log(smoothed)).sum(-1)
    return p.sum(0), entropy.sum(0)


@torch.no_grad()
def split_sums(model: Model, stacked: Dict[str, torch.Tensor], images: torch.Tensor, mean, std,
               batch: int, precision: Precision = Precision()):
    """``sums`` over a whole split of uint8 NHWC images, in blocks of ``batch``."""
    probs: List[torch.Tensor] = []
    ents: List[torch.Tensor] = []
    for start in range(0, images.shape[0], batch):
        x = normalize(images[start:start + batch], mean, std)
        p, e = sums(logits(model, stacked, x, precision))
        probs.append(p)
        ents.append(e)
    return torch.cat(probs), torch.cat(ents)
