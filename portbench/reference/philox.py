"""The standard normals of SGHMC's Langevin noise, as the served update draws
them: Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011) keyed by the step's 64-bit seed and counted by the
element's group of four, each pair of its four words turned into two
normals by Box-Muller (the upper 24 bits of a word as a uniform in [0, 1),
the first uniform floored at 1e-12; z0 = r cos(2 pi u2), z1 = r sin(2 pi u2)).
Element e of the flat parameter vector takes component e % 4 of group e / 4.

Plain integer arithmetic on int64 tensors: a 32-bit product is split in
16-bit halves so that nothing overflows.
"""

from __future__ import annotations

import math

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mul32(m: int, x: torch.Tensor):
    """(high, low) 32-bit words of m * x for m, x < 2**32."""
    a = m * (x & 0xFFFF)
    b = m * (x >> 16)
    low = (a + ((b & 0xFFFF) << 16)) & _MASK
    high = (b + (a >> 16)) >> 16
    return high, low


def philox4x32_10(x0, x1, x2, x3, k0: int, k1: int):
    """The four 32-bit words Philox4x32-10 gives the counter (x0, x1, x2, x3)
    (int64 tensors holding 32-bit words) under the key (k0, k1)."""
    for _ in range(10):
        hi0, lo0 = _mul32(_M0, x0)
        hi1, lo1 = _mul32(_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return x0, x1, x2, x3


def _box_muller(a: torch.Tensor, b: torch.Tensor):
    u1 = ((a >> 8).to(torch.float64) * 2.0 ** -24).clamp_min(1e-12)
    u2 = (b >> 8).to(torch.float64) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(2.0 * math.pi * u2), r * torch.sin(2.0 * math.pi * u2)


def normals(seed: int, total: int, device) -> torch.Tensor:
    """(total,) float32 standard normals of elements 0..total-1 under
    ``seed`` (taken as an unsigned 64-bit word)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    groups = -(-total // 4)
    g = torch.arange(groups, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    w0, w1, w2, w3 = philox4x32_10(g & _MASK, g >> 32, zero, zero, seed & _MASK, seed >> 32)
    z0, z1 = _box_muller(w0, w1)
    z2, z3 = _box_muller(w2, w3)
    return torch.stack([z0, z1, z2, z3], dim=1).reshape(-1)[:total].to(torch.float32)
