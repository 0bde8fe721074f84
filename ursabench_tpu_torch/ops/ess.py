"""Elliptical slice sampling: one transition.

Counterpart of ``ursabench_tpu/ops/ess.py``, which runs the bracket-shrink
loop as one compiled ``lax.while_loop``. Here the loop is a Python loop:
each proposal is a full-data evaluation of ``lnpdf``, and whether it is
accepted decides the next proposal, so every proposal costs one host read
(one device sync): its comparison with the slice height. The bracket's
angles are scalars on the host, in float32 as the JAX package computes
them.

``elliptical_slice_chains`` is the lock-step transition of C chains (the
JAX package's vmapped while loop): one batched ``lnpdf`` over the chains
still bracketing and one host read of their accept mask a proposal; an
accepted chain is frozen and draws no more uniforms. Each chain draws from
its own stream, so it lands where ``elliptical_slice`` on that stream
does.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

_TWO_PI = np.float32(2.0 * math.pi)


def _uniforms(generator: Optional[torch.Generator],
              uniforms: Optional[Sequence[float]]) -> Iterator[np.float32]:
    if uniforms is not None:
        yield from (np.float32(u) for u in uniforms)
        raise ValueError("elliptical_slice ran out of injected uniforms")
    while True:
        yield np.float32(torch.rand((), generator=generator).item())


def elliptical_slice(
    initial_theta: torch.Tensor,
    prior_sample: torch.Tensor,
    lnpdf: Callable[[torch.Tensor], torch.Tensor],
    cur_lnpdf: Optional[torch.Tensor] = None,
    max_iters: int = 1000,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[Sequence[float]] = None,
):
    """One ESS transition from ``initial_theta`` along the ellipse through
    ``prior_sample`` (a draw from the Gaussian prior). Returns ``(theta,
    lnpdf, iters)``: the new point, its log density (a 0-dim tensor) and
    the number of proposals evaluated (JAX's bracket count).

    The first angle is drawn on [0, 2pi) and brackets the whole ellipse; a
    rejected angle shrinks the bracket toward it (an angle <= 0 moves the
    min side); after ``max_iters`` proposals the transition stays put.

    The randomness is ``generator``'s (a CPU generator: the uniforms are
    host scalars), or ``uniforms``: the slice height's, the first angle's,
    then one per proposal, as the JAX package's key splits draw them. The
    samplers never pass ``uniforms``; the parity tests do."""
    draws = _uniforms(generator, uniforms)
    if cur_lnpdf is None:
        cur_lnpdf = lnpdf(initial_theta)
    hh = cur_lnpdf + float(np.log(next(draws)))  # the slice height, on the device
    phi = next(draws) * _TWO_PI
    phi_min, phi_max = phi - _TWO_PI, phi
    for iters in range(1, max_iters + 1):
        xx = initial_theta * float(np.cos(phi)) + prior_sample * float(np.sin(phi))
        val = lnpdf(xx)
        u = next(draws)
        if bool(val > hh):
            return xx, val, iters
        if phi > 0:
            phi_max = phi
        else:
            phi_min = phi
        phi = u * (phi_max - phi_min) + phi_min
    return initial_theta, cur_lnpdf, max_iters


def elliptical_slice_chains(
    initial_theta: torch.Tensor,
    prior_sample: torch.Tensor,
    lnpdf: Callable[[torch.Tensor], torch.Tensor],
    cur_lnpdf: Optional[torch.Tensor] = None,
    max_iters: int = 1000,
    generators: Optional[Sequence[torch.Generator]] = None,
    uniforms: Optional[Sequence[Sequence[float]]] = None,
):
    """``elliptical_slice`` for C chains in lock step: ``initial_theta`` and
    ``prior_sample`` are (C, D), ``lnpdf`` maps (C', D) points to (C',) log
    densities, ``cur_lnpdf`` is (C,). Returns ``(theta, lnpdf, iters)``:
    (C, D), (C,) and each chain's proposal count (a list). Chain c's
    uniforms come from ``generators[c]`` or ``uniforms[c]``, in
    ``elliptical_slice``'s order; each chain gives up after ``max_iters``
    proposals of its own."""
    chains = initial_theta.shape[0]
    draws = [_uniforms(None if generators is None else generators[c],
                       None if uniforms is None else uniforms[c]) for c in range(chains)]
    if cur_lnpdf is None:
        cur_lnpdf = lnpdf(initial_theta)
    device = initial_theta.device
    heights = torch.from_numpy(np.log(np.array([next(d) for d in draws], np.float32)))
    hh = cur_lnpdf + heights.to(device)
    phi = np.array([next(d) for d in draws], np.float32) * _TWO_PI
    phi_min, phi_max = phi - _TWO_PI, phi.copy()
    theta, lp = initial_theta.clone(), cur_lnpdf.clone()
    iters = np.zeros(chains, np.int64)
    active = np.arange(chains)
    for it in range(1, max_iters + 1):
        rows = torch.from_numpy(active).to(device)
        cos = torch.from_numpy(np.cos(phi[active])).to(device)[:, None]
        sin = torch.from_numpy(np.sin(phi[active])).to(device)[:, None]
        xx = initial_theta[rows] * cos + prior_sample[rows] * sin
        val = lnpdf(xx)
        ok = (val > hh[rows]).cpu().numpy()  # the proposal's one host read
        iters[active] = it
        u = np.array([next(draws[c]) for c in active], np.float32)
        if ok.any():
            hit = torch.from_numpy(np.flatnonzero(ok)).to(device)
            theta[rows[hit]] = xx[hit]
            lp[rows[hit]] = val[hit]
        rej, u = active[~ok], u[~ok]
        up = phi[rej] > 0
        phi_max[rej[up]] = phi[rej[up]]
        phi_min[rej[~up]] = phi[rej[~up]]
        phi[rej] = u * (phi_max[rej] - phi_min[rej]) + phi_min[rej]
        active = rej
        if not active.size:
            break
    return theta, lp, iters.tolist()
