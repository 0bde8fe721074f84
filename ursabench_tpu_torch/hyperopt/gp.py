"""Exact Gaussian process for Bayesian optimization, in PyTorch.

Counterpart of ``ursabench_tpu/hyperopt/gp.py``: a Matern-5/2 ARD kernel, a
Gaussian likelihood with a noise floor, standardized targets, and the
marginal log-likelihood fitted by 200 steps of Adam (lr 5e-2; torch's Adam
is optax's: bias-corrected, eps outside the square root). The UCB
acquisition (beta 0.1) takes random candidates, keeps the best
``num_restarts`` and climbs from each with Adam, clipped to the bounds
every step. The restarts are one (R, d) leaf: each query point's posterior
is independent of the others', so the gradient of the summed UCB gives each
restart its own ascent, as the JAX package's ``vmap(ascend)`` does.

Everything is float32 on the device of the tensors given; ``GP`` and
``init_params`` take the card unless the caller names another device, and
raise when it is absent. A kernel matrix
that is not positive definite yields NaN, not an exception (the Cholesky
factor is ``cholesky_ex``'s, masked where it failed, with no host sync):
the search loops then fall back to a uniform draw, as they do in the JAX
package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..inference.base import resolve_device

MIN_NOISE = 1e-3  # the noise floor
JITTER = 1e-6


class GPParams(NamedTuple):
    raw_lengthscale: torch.Tensor  # (d,)
    raw_outputscale: torch.Tensor  # ()
    raw_noise: torch.Tensor  # ()


def init_params(d: int, device=None) -> GPParams:
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return GPParams(torch.zeros(d, **f32), torch.tensor(0.5, **f32), torch.tensor(-2.0, **f32))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def _matern52(x1, x2, lengthscale, outputscale):
    """The Matern-5/2 ARD kernel matrix of (n, d) x (m, d)."""
    s1, s2 = x1 / lengthscale, x2 / lengthscale
    d2 = torch.clamp(torch.sum(s1 ** 2, -1)[:, None] + torch.sum(s2 ** 2, -1)[None, :]
                     - 2.0 * s1 @ s2.T, min=0.0)
    r = torch.sqrt(d2 + 1e-12)
    sqrt5r = math.sqrt(5.0) * r
    return outputscale * (1 + sqrt5r + 5.0 / 3.0 * d2) * torch.exp(-sqrt5r)


def _transform(p: GPParams):
    return (_softplus(p.raw_lengthscale) + 1e-4, _softplus(p.raw_outputscale) + 1e-4,
            _softplus(p.raw_noise) + MIN_NOISE)


def _cholesky(k: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor, NaN where the factorization failed."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))


def _factor(p: GPParams, x: torch.Tensor, y: torch.Tensor):
    ls, os_, noise = _transform(p)
    n = x.shape[0]
    k = _matern52(x, x, ls, os_) + (noise + JITTER) * torch.eye(n, dtype=x.dtype,
                                                                 device=x.device)
    chol = _cholesky(k)
    alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
    return ls, os_, chol, alpha


def neg_mll(p: GPParams, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    _, _, chol, alpha = _factor(p, x, y)
    n = x.shape[0]
    return (0.5 * y @ alpha + torch.sum(torch.log(torch.diagonal(chol)))
            + 0.5 * n * math.log(2 * math.pi))


def fit(x: torch.Tensor, y: torch.Tensor, p0: GPParams, steps: int = 200) -> GPParams:
    """Adam on the negative marginal log-likelihood from ``p0`` (the warm
    start). Returns detached parameters."""
    leaves = [t.detach().clone().requires_grad_(True) for t in p0]
    opt = torch.optim.Adam(leaves, lr=5e-2)
    for _ in range(steps):
        opt.zero_grad(set_to_none=False)
        neg_mll(GPParams(*leaves), x, y).backward()
        opt.step()
    return GPParams(*(t.detach() for t in leaves))


def posterior(p: GPParams, x: torch.Tensor, y: torch.Tensor, xq: torch.Tensor):
    """The posterior mean and standard deviation at the query points."""
    ls, os_, chol, alpha = _factor(p, x, y)
    kq = _matern52(xq, x, ls, os_)
    mean = kq @ alpha
    v = torch.linalg.solve_triangular(chol, kq.T, upper=False)
    var = torch.clamp(os_ - torch.sum(v ** 2, dim=0), min=1e-12)
    return mean, torch.sqrt(var)


def standardize(y: torch.Tensor) -> torch.Tensor:
    """(y - mean) / std (ddof 1; 1 for one point or a spread under 1e-9)."""
    mu = y.mean()
    sd = y.std(unbiased=True) if y.shape[0] > 1 else torch.ones((), dtype=y.dtype,
                                                                device=y.device)
    sd = torch.where(sd < 1e-9, torch.ones_like(sd), sd)
    return (y - mu) / sd


def uniform_points(bounds: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """``n`` points drawn uniformly in ``bounds`` ((d, 2), search units)."""
    lo, hi = bounds[:, 0], bounds[:, 1]
    u = torch.rand((n, bounds.shape[0]), generator=gen, device=gen.device,
                   dtype=torch.float32).to(bounds.device)
    return lo + (hi - lo) * u


class GP:
    """Fit on (x, y) at construction (``steps`` Adam steps from ``p0``, or
    from ``init_params``); optimize the UCB within bounds."""

    def __init__(self, x, y, p0: GPParams | None = None, device=None, steps: int = 200):
        x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=resolve_device(device))
        self.x = x.reshape(x.shape[0], -1)
        self.y = standardize(torch.as_tensor(np.asarray(y), dtype=torch.float32,
                                             device=self.x.device).reshape(-1))
        p0 = p0 if p0 is not None else init_params(self.x.shape[1], self.x.device)
        self.params = fit(self.x, self.y, GPParams(*(t.to(self.x.device) for t in p0)), steps)

    def ucb(self, xq: torch.Tensor, beta: float = 0.1) -> torch.Tensor:
        mean, std = posterior(self.params, self.x, self.y, xq)
        return mean + math.sqrt(beta) * std

    def ascend(self, bounds: torch.Tensor, candidates: torch.Tensor, beta: float = 0.1,
               num_restarts: int = 20, ascent_steps: int = 50):
        """The best ``num_restarts`` of ``candidates`` by UCB, each climbed
        by Adam for ``ascent_steps`` steps, clipped to ``bounds`` every step.
        Returns (endpoints (R, d), their UCB (R,))."""
        lo, hi = bounds[:, 0], bounds[:, 1]
        with torch.no_grad():
            vals = self.ucb(candidates, beta)
        top = candidates[torch.argsort(-vals)[:num_restarts]]
        xx = top.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([xx], lr=5e-2)
        for _ in range(ascent_steps):
            opt.zero_grad(set_to_none=False)
            (-self.ucb(xx, beta).sum()).backward()
            opt.step()
            with torch.no_grad():
                xx.copy_(torch.minimum(torch.maximum(xx, lo), hi))
        with torch.no_grad():
            return xx.detach(), self.ucb(xx, beta)

    def optimize_ucb(self, bounds: torch.Tensor, gen: torch.Generator, beta: float = 0.1,
                     raw_samples: int = 200, num_restarts: int = 20,
                     ascent_steps: int = 50) -> torch.Tensor:
        xs, vs = self.ascend(bounds, uniform_points(bounds, raw_samples, gen), beta,
                             num_restarts, ascent_steps)
        return xs[torch.argmax(vs)]

    def optimize_ucb_batch(self, bounds: torch.Tensor, gen: torch.Generator, q: int,
                           beta: float = 0.1, raw_samples: int = 200,
                           num_restarts: int = 20, ascent_steps: int = 50,
                           min_dist: float = 1e-3) -> np.ndarray:
        """The top ``q`` distinct UCB ascent endpoints (a greedy filter at
        ``min_dist`` of the bounds' span), filled up with uniform draws if
        too few are distinct: the batch a sweep evaluates together."""
        xs, vs = self.ascend(bounds, uniform_points(bounds, raw_samples, gen), beta,
                             num_restarts, ascent_steps)
        xs_np, order = xs.cpu().numpy(), np.argsort(-vs.cpu().numpy())
        span = (bounds[:, 1] - bounds[:, 0]).cpu().numpy()
        picked = []
        for i in order:
            if all(np.linalg.norm((xs_np[i] - xs_np[j]) / span) > min_dist for j in picked):
                picked.append(int(i))
            if len(picked) == q:
                break
        while len(picked) < q:
            xs_np = np.vstack([xs_np, uniform_points(bounds, 1, gen).cpu().numpy()])
            picked.append(len(xs_np) - 1)
        return xs_np[picked]
