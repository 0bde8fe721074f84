from .base import _Inference
from .distill import EntropyHead, distill_ensemble
from .ensemble import Ensemble
from .sgd_map import SGD, DeepEnsemble, MCdropout
from .sgmcmc import SGHMC, SGLD, cSGHMC, cSGLD
from .subspaces import Subspace, SubspaceModel
from .swa import SWA
from .swag import SWAG
from .vectorized import MethodSweep, SGHMCSweep

__all__ = ["DeepEnsemble", "Ensemble", "EntropyHead", "MCdropout", "MethodSweep", "SGD",
           "SGHMC", "SGHMCSweep", "SGLD", "SWA", "SWAG", "Subspace", "SubspaceModel",
           "_Inference", "cSGHMC", "cSGLD", "distill_ensemble"]

# samplers of the JAX package that are not ported yet -> their ROADMAP.md item
_NOT_PORTED = {"HMC": 10, "PCASubspaceSampler": 10}


def get_inference(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md open item {_NOT_PORTED[name]})")
    import sys

    mod = sys.modules[__name__]
    if not hasattr(mod, name):
        raise KeyError(f"Unknown inference method '{name}'")
    return getattr(mod, name)
