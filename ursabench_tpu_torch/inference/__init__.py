from .base import _Inference
from .distill import EntropyHead, distill_ensemble
from .ensemble import Ensemble
from .hmc import HMC
from .pca_subspace import PCASubspaceSampler
from .sgd_map import SGD, DeepEnsemble, MCdropout
from .sgmcmc import SGHMC, SGLD, cSGHMC, cSGLD
from .subspaces import Subspace, SubspaceModel
from .swa import SWA
from .swag import SWAG
from .vectorized import MethodSweep, SGHMCSweep

__all__ = ["DeepEnsemble", "Ensemble", "EntropyHead", "HMC", "MCdropout", "MethodSweep",
           "PCASubspaceSampler", "SGD", "SGHMC", "SGHMCSweep", "SGLD", "SWA", "SWAG",
           "Subspace", "SubspaceModel", "_Inference", "cSGHMC", "cSGLD", "distill_ensemble"]


def get_inference(name: str):
    import sys

    mod = sys.modules[__name__]
    if not hasattr(mod, name):
        raise KeyError(f"Unknown inference method '{name}'")
    return getattr(mod, name)
