"""The inputs a run hands to the program and to the reference alike, made
from ``--seed`` on the device in a few large calls: uint8 NHWC images and
their labels, token ids, and weights (a chain's starting point, or an
ensemble's members) at each leaf's initial scale.

Sub-seeds are sha256 of the seed and a tag, so the same seed gives the same
inputs in every run, and different tags give unrelated streams.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import torch

from .reference.layers import Leaf


def sub_seed(seed: int, *tags) -> int:
    text = "/".join(["portbench", str(int(seed))] + [str(t) for t in tags])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") & (2 ** 63 - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, *tags))
    return gen


def images(seed: int, tag: str, n: int, image, classes: int, device):
    """``n`` uniform uint8 images of shape ``image`` (H, W, C), NHWC, and
    uniform labels below ``classes``, on ``device``."""
    gen = generator(device, seed, "images", tag)
    x = torch.randint(0, 256, (n,) + tuple(image), generator=gen, device=device,
                      dtype=torch.uint8)
    y = torch.randint(0, classes, (n,), generator=gen, device=device, dtype=torch.int64)
    return x, y


def tokens(seed: int, tag: str, n: int, length: int, vocab: int, device) -> torch.Tensor:
    """``n`` sequences of ``length`` uniform int64 token ids below ``vocab``,
    (n, length), on ``device``."""
    gen = generator(device, seed, "tokens", tag)
    return torch.randint(0, vocab, (n, length), generator=gen, device=device, dtype=torch.int64)


def weights(leaves: List[Leaf], seed: int, tag: str, device, count: int = 1,
            jitter: float = 0.0) -> Dict[str, torch.Tensor]:
    """``count`` sets of every leaf, stacked on a leading axis of ``count``:
    weights drawn N(0, std**2) at the leaf's initial scale (``Leaf.std``),
    BatchNorm scales 1 and shifts and running means 0 and running variances 1,
    each moved by ``jitter`` times a normal (running variances by a factor
    exp(jitter z)): one draw of normals for all of them, each leaf a view
    of it scaled in place."""
    total = sum(leaf.numel for leaf in leaves)
    z = torch.randn((count, total), generator=generator(device, seed, "weights", tag),
                    device=device)
    out, offset = {}, 0
    for leaf in leaves:
        zl = z[:, offset: offset + leaf.numel].view((count,) + leaf.shape)
        offset += leaf.numel
        if leaf.init in ("fan_out_normal", "uniform"):
            out[leaf.name] = zl.mul_(leaf.std)
        elif leaf.name.endswith("running_var"):
            out[leaf.name] = zl.mul_(jitter).exp_()
        else:
            out[leaf.name] = zl.mul_(jitter).add_(1.0 if leaf.init == "ones" else 0.0)
    return out
