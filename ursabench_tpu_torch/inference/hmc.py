"""Full-batch Hamiltonian Monte Carlo: leapfrog trajectories and a
Metropolis-Hastings accept.

Counterpart of ``ursabench_tpu/inference/hmc.py``, which documents the
reference protocol: prior precision ``tau``, output precision 1, ``L``
leapfrog steps of ``step_size``, a diagonal mass ``mass``, and the kept
draws ``chain[burn:]`` of the trajectory including its initial point
(Python's slice semantics, so ``burn = -1`` keeps the last draw). The
log target is ``-CE_sum(train; theta) - 0.5 * tau * ||theta||^2``.

The potential runs over the device-resident train split in ``grad_batch``
index batches, the last one filled up with index 0 and those rows masked
out of the cross entropy. The network is in eval mode, so BatchNorm uses
the init's running statistics. The CE sum is Kahan-accumulated in float32;
the gradient sums the batches' gradients in the flat gradient buffer.
TF32 is off inside every potential and gradient evaluation (the flags are
restored after): the accept compares energy differences built from float32
gradients, as in the JAX package.

Each trajectory is the half-step leapfrog, one gradient per step. The last
step's gradient pass also yields the CE sum at the proposal, which the
JAX package evaluates in a separate forward pass. The log ratio is formed
from differences only: the carried CE sums, and the prior and kinetic
terms as ``sum((a - b) * (a + b))`` (``_sq_diff_sum``), never as
``H_cur - H_new`` from absolute energies, which float32 cannot resolve at
a few hundred thousand parameters. The accept stays on the device
(``torch.where``); ``accept_rate`` is read once, after the last draw.

Chains have their own inits (chain 0 keeps the first). With
``chain_strategy`` ``"scan"`` they advance in turn each draw, C gradient
passes a leapfrog step; with ``"vmap"`` one batched potential
(``engine.ChainForward`` over the (C, P) thetas) serves every chain, with
per-chain Kahan sums, squared differences and accepts. Both draw each
chain's momentum and accept uniform from the one generator in chain order
before its trajectory, so they consume the same stream. The ensemble is
draw-major, chains within a draw, with the init's BatchNorm buffers
broadcast to every member. Draws advance in
chunks of ``draw_chunk``; after each chunk a checkpoint is written when
``enable_auto_checkpoint``'s interval (counted in draws) divides the draws
done.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.transforms import normalize
from ..models.common import dropout_generator, dropout_layers
from ..util import make_generator
from .base import _Inference
from .engine import (ChainForward, _padded_batches, backward_into_views, flatten_parameters,
                     stacked_leaves)
from .ensemble import Ensemble

_MESH = ("HMC over a device mesh (its data-parallel potential) is not ported yet "
         "(ROADMAP.md open item 15c)")


def _sq_diff_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a**2) - sum(b**2)`` over the last axis as ``sum((a - b) * (a +
    b))``: each summand scales with the move ``a - b``, so float32 keeps the
    energy difference's bits at any parameter count."""
    return torch.sum((a - b) * (a + b), dim=-1)


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off in cuDNN and cuBLAS for the block; the flags are restored
    after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class HMC(_Inference):
    _DEFAULT_HYP = {
        "step_size": 0.001, "num_samples": 10, "L": 1, "tau": 0.1,
        "burn": -1, "mass": 1.0,
    }

    def __init__(self, hyperparameters, model=None, train=None,
                 model_loss="multi_class_linear_output", seed=0, chains=1,
                 device=None, chain_strategy="auto", mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MESH)
        super().__init__(hyperparameters, model, train, model_loss, seed, chains,
                         device, chain_strategy)
        if hyperparameters is None:
            hyperparameters = dict(self._DEFAULT_HYP)
        self._images, self._labels = train.device_tensors(self.device)
        self._params, self._grads = flatten_parameters(self.module)
        if self._resolved_chain_strategy == "vmap":  # the chains' thetas, batched
            self._chain_params = torch.zeros(self.chains, self._params.numel(),
                                             device=self.device)
            self._chain_grads = torch.zeros_like(self._chain_params)
            self._leaves = stacked_leaves(self.module, self._chain_params, self._chain_grads)
            self._forward = ChainForward(self.module)
        self._has_dropout = bool(dropout_layers(self.module))
        self._resume_state = None
        self._setup(hyperparameters)

    def _setup(self, hyp):
        self.hyperparameters = hyp
        self.step_size = float(hyp["step_size"])
        self.num_samples = int(hyp["num_samples"])
        self.L = int(hyp["L"])
        self.tau = float(hyp["tau"])
        self.burn = int(hyp["burn"])
        self.mass = float(hyp["mass"])
        self.draw_chunk = int(hyp.get("draw_chunk", 10))
        if self.L < 1 or self.draw_chunk < 1:
            raise ValueError(f"HMC needs L >= 1 and draw_chunk >= 1, got {self.L}, "
                             f"{self.draw_chunk}")
        n, bsz = self.train.n, min(self.train.n, int(hyp.get("grad_batch", 4096)))
        batches = _padded_batches(n, bsz, lambda idx, pad: torch.full_like(idx[:pad], -1),
                                  self.device)
        self._valid = (batches >= 0).to(torch.float32)
        self._batches = batches.clamp_min(0)
        run = self.next_seed()
        theta0 = []
        for c in range(self.chains):
            self.fresh_variables(self.module, run, c)
            theta0.append(self._params.detach().clone())
        self._theta0 = torch.stack(theta0)  # (C, P)
        self._buffers = {k: b.detach().clone() for k, b in self.module.named_buffers()}
        self._gen = make_generator(self.device, run, "hmc")
        self.accept_rate: Optional[float] = None
        self.draws_done = 0

    def update_hyp(self, hyperparameters):
        self._setup(hyperparameters)

    # -- potential ---------------------------------------------------------------

    def _ce_sum(self, theta: torch.Tensor, grad: bool) -> torch.Tensor:
        """The Kahan-accumulated CE sum over the train split at ``theta``
        (P,), a 0-dim tensor; with ``grad``, its gradient is left in
        ``self._grads``."""
        module = self.module
        with torch.no_grad():
            self._params.copy_(theta)
        if grad:
            self._grads.zero_()
        module.eval()
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        comp = torch.zeros_like(total)
        with float32_matmuls(), torch.set_grad_enabled(grad):
            for bi in range(self._batches.shape[0]):
                b = self._batches[bi]
                x = normalize(self._images.index_select(0, b), self.train.spec)
                gen = make_generator(self.device, 0, bi) if self._has_dropout else None
                with dropout_generator(module, gen):
                    logits = module(x.permute(0, 3, 1, 2).contiguous())
                ce = F.cross_entropy(logits.to(torch.float32), self._labels.index_select(0, b),
                                     reduction="none")
                s = torch.sum(ce * self._valid[bi])
                if grad:
                    s.backward()
                val = s.detach() - comp
                t = total + val
                comp = (t - total) - val
                total = t
        return total

    def _ce_sums(self, theta: torch.Tensor, grad: bool) -> torch.Tensor:
        """``_ce_sum`` of every chain at once: (C,) Kahan-accumulated CE sums
        at the (C, P) ``theta``, one batched forward (and backward) a batch
        of the split; with ``grad`` the (C, P) gradient is left in
        ``self._chain_grads``."""
        module, chains = self.module, theta.shape[0]
        with torch.no_grad():
            self._chain_params.copy_(theta)
        if grad:
            self._chain_grads.zero_()
        module.eval()
        total = torch.zeros(chains, dtype=torch.float32, device=self.device)
        comp = torch.zeros_like(total)
        with float32_matmuls(), torch.set_grad_enabled(grad):
            for bi in range(self._batches.shape[0]):
                b = self._batches[bi]
                x = normalize(self._images.index_select(0, b), self.train.spec)
                x = x.permute(0, 3, 1, 2).contiguous()
                layers, masks = ((), ())
                if self._has_dropout:  # one stream for every chain, as in _ce_sum
                    layers, masks = self._forward.masks(
                        x, [make_generator(self.device, 0, bi)])
                logits, _ = self._forward(self._leaves, x, x_batched=False, layers=layers,
                                          masks=masks)
                y = self._labels.index_select(0, b).repeat(chains)
                ce = F.cross_entropy(logits.to(torch.float32).flatten(0, 1), y,
                                     reduction="none").view(chains, -1)
                s = torch.sum(ce * self._valid[bi], dim=1)
                if grad:
                    backward_into_views(s.sum())
                val = s.detach() - comp
                t = total + val
                comp = (t - total) - val
                total = t
        return total

    def _grad_u(self, theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(CE sum, gradient of the potential) at ``theta``: (P,) for one
        chain, or every chain's at once from (C, P) under ``"vmap"``."""
        if theta.dim() == 2:
            ce = self._ce_sums(theta, grad=True)
            return ce, self._chain_grads + self.tau * theta
        ce = self._ce_sum(theta, grad=True)
        return ce, self._grads + self.tau * theta

    # -- transition --------------------------------------------------------------

    def _transition(self, theta: torch.Tensor, ll_cur: torch.Tensor,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """One HMC transition of one chain from ``theta`` (P,) with carried
        CE sum ``ll_cur`` (or of every chain at once from (C, P) and (C,),
        under ``"vmap"``). Returns ``(theta, ll, accepted, log_ratio,
        proposal)``, ``proposal`` = (theta_new, p0, p_new, ll_new). The
        momentum and the accept uniform come from the sampler's generator,
        each chain's in turn, or from ``draws = (p0, u)`` (the parity tests
        pass JAX's)."""
        if draws is None:
            rows = [self._momentum_and_uniform(t) for t in theta.view(-1, theta.shape[-1])]
            p0, u = (torch.stack(col).view(theta.shape[:-1] + col[0].shape)
                     for col in zip(*rows))
        else:
            p0, u = draws
        eps, inv_mass = self.step_size, 1.0 / self.mass
        _, g = self._grad_u(theta)
        p = p0 - 0.5 * eps * g
        th = theta
        for _ in range(self.L):
            th = th + eps * inv_mass * p
            ll_new, g = self._grad_u(th)
            p = p - eps * g
        p_new = p + 0.5 * eps * g  # the loop took a full step at the end
        log_ratio = ((ll_cur - ll_new)
                     - 0.5 * self.tau * _sq_diff_sum(th, theta)
                     - 0.5 * inv_mass * _sq_diff_sum(p_new, p0))
        accept = torch.log(u) < log_ratio
        return (torch.where(accept[..., None], th, theta), torch.where(accept, ll_new, ll_cur),
                accept, log_ratio, (th, p0, p_new, ll_new))

    def _momentum_and_uniform(self, theta: torch.Tensor):
        """One chain's momentum draw and accept uniform, in that order."""
        p0 = torch.randn(theta.shape, generator=self._gen,
                         device=self.device) * math.sqrt(self.mass)
        return p0, torch.rand((), generator=self._gen, device=self.device)

    def _draw(self, theta: torch.Tensor, ll: torch.Tensor):
        """One transition of every chain: (C, P), (C,) -> the same and the
        (C,) accepts; in turn, or batched under ``"vmap"``."""
        if self._resolved_chain_strategy == "vmap":
            return self._transition(theta, ll)[:3]
        rows = [self._transition(theta[c], ll[c])[:3] for c in range(self.chains)]
        return tuple(torch.stack(col) for col in zip(*rows))

    def _initial_ce_sums(self, theta: torch.Tensor) -> torch.Tensor:
        if self._resolved_chain_strategy == "vmap":
            return self._ce_sums(theta, grad=False)
        return torch.stack([self._ce_sum(t, grad=False) for t in theta])

    # -- mid-chain checkpoints ----------------------------------------------------

    def _restore_checkpoint(self, path: str) -> None:
        from ..utils_checkpoint import load_pytree

        self._resume_state = load_pytree(path)
        self.draws_done = int(self._resume_state["draws_done"])

    def _save_chain(self, theta, ll, trajectory, accepts, done) -> None:
        if not self._checkpoint_due(done):
            return
        from ..utils_checkpoint import generator_states, save_pytree

        save_pytree(self._ckpt_path, {
            "theta": theta, "ll": ll, "generators": generator_states({"hmc": self._gen}),
            "trajectory": torch.stack(trajectory), "accepts": torch.stack(accepts),
            "draws_done": done,
        })

    def _resume(self):
        from ..utils_checkpoint import set_generator_states

        r, self._resume_state = self._resume_state, None
        set_generator_states({"hmc": self._gen}, r["generators"])
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return (to(r["theta"]), to(r["ll"]), list(to(r["trajectory"])),
                list(to(r["accepts"])), int(r["draws_done"]))

    # -- sampling ----------------------------------------------------------------

    def sample(self, num_samples=None, debug=False) -> Ensemble:
        if num_samples is None:
            num_samples = self.num_samples
        r = self._resume_state
        if r is not None and int(r["draws_done"]) <= num_samples:
            theta, ll, trajectory, accepts, done = self._resume()
        else:
            theta = self._theta0.clone()
            ll = self._initial_ce_sums(theta)
            trajectory, accepts, done = [theta], [], 0
        chunk = min(self.draw_chunk, num_samples)
        while done < num_samples:
            for _ in range(min(chunk, num_samples - done)):
                theta, ll, acc = self._draw(theta, ll)
                trajectory.append(theta)
                accepts.append(acc)
                done += 1
            self.draws_done = done
            self._save_chain(theta, ll, trajectory, accepts, done)
        self.accept_rate = float(torch.stack(accepts).float().mean())
        if debug:
            print("HMC acceptance rate:", self.accept_rate)
        kept = torch.stack(trajectory)[self.burn:]  # (kept, C, P)
        flat = kept.reshape(-1, kept.shape[-1])  # draw-major, chains within a draw
        S = flat.shape[0]
        state, offset = {}, 0
        for name, p in self.module.named_parameters():
            state[name] = flat[:, offset: offset + p.numel()].reshape((S,) + tuple(p.shape))
            offset += p.numel()
        for name, b in self._buffers.items():
            state[name] = b.expand((S,) + tuple(b.shape))
        return Ensemble(self.module, state, S)
