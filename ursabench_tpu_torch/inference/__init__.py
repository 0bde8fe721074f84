from .ensemble import Ensemble
from .sgd_map import SGD, DeepEnsemble, MCdropout
from .sgmcmc import SGHMC, SGLD, cSGHMC, cSGLD
from .subspaces import Subspace, SubspaceModel
from .swa import SWA
from .swag import SWAG

__all__ = ["DeepEnsemble", "Ensemble", "MCdropout", "SGD", "SGHMC", "SGLD", "SWA", "SWAG",
           "Subspace", "SubspaceModel", "cSGHMC", "cSGLD"]
