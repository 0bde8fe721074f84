from . import metrics, sgmcmc

__all__ = ["metrics", "sgmcmc"]
