from . import ess, metrics, sgmcmc

__all__ = ["ess", "metrics", "sgmcmc"]
