"""SG-MCMC parameter updates on flat parameter buffers.

Counterpart of ``ursabench_tpu/ops/sgmcmc.py``. The JAX package updates a
pytree leaf by leaf; here each model's parameters, momentum and gradients
are views into one flat float32 buffer each (``inference.engine``), so one
call updates the whole model, in place:

    d   = grad + wd_over_n * p
    buf = momentum * (first step ? d : buf) - lr * d
    buf += noise_on * sqrt(2*(1-momentum)*lr) / n_train * N(0,1)
    p  += buf

``momentum == 0`` gives SGLD. The hyperparameters may be (K,) tensors, one
value per row of (K, P) buffers: a sweep's K configurations in one call.
On CUDA tensors the step is kernel K1
(``kernels/sghmc.py``), which makes its normals in the kernel; on CPU
tensors it is the plain version, with normals from a generator seeded by
``seed``. A buffer that is a block of a larger one (a rank's chains on a
device mesh) passes its first element's global index ``offset`` and the
larger buffer's size ``total``: it then draws the normals the whole buffer
would draw there, on either path.
"""

from __future__ import annotations

import torch

from ..kernels.sghmc import sghmc_update_flat, sghmc_update_flat_reference


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def sghmc_scalars(*, lr, momentum, wd_over_n, n_train, noise_on,
                  is_first_step, device) -> torch.Tensor:
    """The kernel's scalars on ``device``: (lr, momentum, wd_over_n,
    noise_scale, is_first), noise_scale = sqrt(2(1-m)lr)/n_train*noise_on;
    a float32[5] from 0-dim values, an (K, 5) table, one row a config, when
    any of them is a (K,) tensor. Tensor inputs stay on the device; nothing
    is read back."""
    lr, momentum = _f32(lr, device), _f32(momentum, device)
    noise_scale = torch.sqrt(2.0 * (1.0 - momentum) * lr) / _f32(n_train, device)
    noise_scale = noise_scale * _f32(noise_on, device)
    first = torch.full((), float(bool(is_first_step)), dtype=torch.float32,
                       device=device)
    columns = torch.broadcast_tensors(lr, momentum, _f32(wd_over_n, device),
                                      noise_scale, first)
    return torch.stack(columns, dim=-1)


def sghmc_update(
    params: torch.Tensor,
    momentum_buf: torch.Tensor,
    grads: torch.Tensor,
    *,
    lr,
    momentum,
    wd_over_n,
    n_train,
    noise_on,
    is_first_step: bool,
    seed: int,
    noise: torch.Tensor | None = None,
    offset: int = 0,
    total: int | None = None,
):
    """One SGHMC/SGLD step over flat buffers, in place. Returns
    ``(params, momentum_buf)``. With (K,) hyperparameters the buffers are
    (K, P) and row k takes config k's (one launch, K1's per-row table).

    ``noise`` (CPU only) supplies the standard normals, so a test can hand
    in the JAX package's draw. ``offset`` and ``total`` (default: the
    buffer's own size) place the buffer in a larger one of ``total``
    elements: on the CPU the normals of all ``total`` are drawn and the
    block's taken, so the block's noise is what the whole buffer's is."""
    scalars = sghmc_scalars(lr=lr, momentum=momentum, wd_over_n=wd_over_n,
                            n_train=n_train, noise_on=noise_on,
                            is_first_step=is_first_step, device=params.device)
    if params.is_cuda:
        if noise is not None:
            raise ValueError("the CUDA kernel draws its own normals; "
                             "noise= is for CPU tensors")
        return sghmc_update_flat(params, momentum_buf, grads, scalars, seed, offset)
    if noise is None:
        n = params.numel()
        total = n if total is None else int(total)
        if not 0 <= offset <= total - n:
            raise ValueError(f"a block of {n} at {offset} does not fit in {total}")
        gen = torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))
        noise = torch.randn(total, generator=gen)[offset: offset + n].view(params.shape)
    return sghmc_update_flat_reference(params, momentum_buf, grads, scalars, noise)


@torch.no_grad()
def sgd_momentum_update(
    params: torch.Tensor,
    momentum_buf: torch.Tensor,
    grads: torch.Tensor,
    *,
    lr,
    momentum,
    weight_decay,
    is_first_step: bool,
):
    """``torch.optim.SGD(momentum=m, weight_decay=wd)`` on flat buffers, in
    place: d = g + wd*p; buf = d on the first step, else m*buf + d;
    p -= lr*buf."""
    d = grads + weight_decay * params
    v_new = d if is_first_step else momentum * momentum_buf + d
    momentum_buf.copy_(v_new)
    params.sub_(lr * v_new)
    return params, momentum_buf
