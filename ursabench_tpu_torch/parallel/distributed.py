"""Start-up of several processes and the ('chain', 'data') layout rules.

Counterpart of ``ursabench_tpu/parallel/distributed.py``. The JAX package
runs one process over every device of a host; here each device is one
process, a rank of ``torch.distributed``: NCCL between CUDA ranks, gloo
between CPU ranks. ``initialize`` joins the process group (a no-op in one
process); the layout functions apply the JAX package's divisor rules to the
world size where JAX counts ``jax.devices()``.

``auto_layout``, ``chain_layout`` and ``make_layout`` are pure functions of
(chains, batch size, n) that need no process group; ``auto_mesh``,
``chain_mesh`` and ``mesh.make_mesh`` turn their result into a ``Mesh``,
which spans the whole world (so ``n_devices``, where given, is its size).
As ``auto_mesh`` returns None on one device in the JAX package, every layout
function returns None where nothing is sharded, and nothing changes.

Launch several processes with ``torchrun --nproc_per_node N ...``: it sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT, which
``initialize()`` reads.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def world_size() -> int:
    """The number of ranks of the process group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group of several ranks; a no-op in one process.

    ``coordinator_address`` is rank 0's ``host:port`` (a ``tcp://`` URL is
    made of it) or an init URL such as ``file:///path``; without it the
    group starts from torchrun's variables, and without those (one process)
    nothing happens. ``num_processes`` and ``process_id`` default to
    WORLD_SIZE and RANK. The backend defaults to NCCL when CUDA is present
    and gloo otherwise; on CUDA each rank's device becomes
    ``cuda:LOCAL_RANK`` (modulo the visible cards). Calling it again once
    the group exists does nothing."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "WORLD_SIZE" not in os.environ:
        return
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    size = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    me = int(os.environ["RANK"] if process_id is None else process_id)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", me))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=me,
                            timeout=datetime.timedelta(seconds=timeout_s))


def auto_layout(chains: int, batch_size: Optional[int] = None,
                n: int = 1) -> Optional[Tuple[int, int]]:
    """``(chain, data)`` over n devices for ``chains`` chains: the chain
    axis is the largest divisor of n that also divides ``chains``; the rest
    is data parallelism, shrunk until it divides ``batch_size`` when one is
    given. None when nothing is sharded (n = 1, or chains 1 and a batch size
    coprime with every divisor of n). The JAX package's ``auto_mesh``."""
    if n <= 1:
        return None
    cd = next(d for d in range(min(chains, n), 0, -1) if n % d == 0 and chains % d == 0)
    dd = n // cd
    if batch_size is not None:
        while dd > 1 and batch_size % dd:
            dd -= 1
    return None if cd * dd <= 1 else (cd, dd)


def chain_layout(chains: int, n: int = 1) -> int:
    """The chain axis of a chain-only layout: min(chains, n), shrunk until
    it divides ``chains``. The JAX package's ``chain_mesh``."""
    use = min(chains, n)
    while chains % use:
        use -= 1
    return use


def make_layout(n: int, chain_devices: Optional[int] = None) -> Tuple[int, int]:
    """``(chain, data)`` over all n devices: ``chain_devices`` or, by
    default, the largest power of two dividing n, halved while it exceeds
    n / chain (a square-ish split). The JAX package's ``make_mesh``."""
    if chain_devices is None:
        chain_devices = 1
        while chain_devices * 2 <= n and n % (chain_devices * 2) == 0:
            chain_devices *= 2
        while chain_devices > 1 and chain_devices > n // chain_devices:
            chain_devices //= 2
    if chain_devices < 1 or n % chain_devices:
        raise ValueError(f"{chain_devices} chain devices do not divide {n}")
    return chain_devices, n // chain_devices


def auto_mesh(chains: int, batch_size: Optional[int] = None,
              n_devices: Optional[int] = None):
    """``auto_layout`` over ``n_devices`` (default: the world size) as a
    ``Mesh``, or None where nothing is sharded."""
    from .mesh import Mesh

    layout = auto_layout(chains, batch_size, world_size() if n_devices is None else n_devices)
    return None if layout is None else Mesh(*layout)


def chain_mesh(chains: int, n_devices: Optional[int] = None):
    """A chain-only ``Mesh`` of ``chain_layout`` ranks (data axis 1): pass it
    to a sampler's ``mesh=`` with ``chains`` a multiple of its size."""
    from .mesh import Mesh

    return Mesh(chain_layout(chains, world_size() if n_devices is None else n_devices), 1)
