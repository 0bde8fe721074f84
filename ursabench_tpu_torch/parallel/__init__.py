"""The device mesh: one process per device under ``torch.distributed``,
laid out as a ('chain', 'data') grid of ranks. The epoch samplers, the
sweeps and the tasks take a ``Mesh`` (``mesh=``); ``experiment.py --mesh``
builds one over the world with ``auto_mesh`` or ``chain_mesh``.

Counterpart of ``ursabench_tpu/parallel``, with the same exports."""

from .distributed import auto_mesh, chain_mesh, initialize
from .mesh import Mesh, make_mesh, shard_ensemble_eval

__all__ = [
    "Mesh", "make_mesh", "shard_ensemble_eval",
    "auto_mesh", "chain_mesh", "initialize",
]
