from .common import BatchNorm2d, ModelCfg, get_model, register
from .preresnet import PreResNet  # importing registers the PreResNet configs

__all__ = ["BatchNorm2d", "ModelCfg", "PreResNet", "get_model", "register"]
