from .common import BatchNorm2d, Conv2d, ModelCfg, get_model, register
from .preresnet import PreResNet  # importing registers the PreResNet configs
from .resnet_imagenet import INResNet, TVResNet  # and the ImageNet-style ResNets

__all__ = ["BatchNorm2d", "Conv2d", "INResNet", "ModelCfg", "PreResNet", "TVResNet",
           "get_model", "register"]
