from .ensemble import Ensemble
from .sgmcmc import SGHMC, SGLD

__all__ = ["Ensemble", "SGHMC", "SGLD"]
