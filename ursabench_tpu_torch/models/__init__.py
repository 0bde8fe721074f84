from .common import (BatchNorm2d, Conv2d, Dropout, Linear, ModelCfg, dropout_generator,
                     dropout_twin, get_model, list_models, register)
from .lenet import LeNet5  # importing registers LeNet5MNIST
from .mlp import MLP  # importing registers the MLP configs
from .preresnet import PreResNet  # the PreResNet configs
from .resnet_cifar import CifarResNet  # the option-A CIFAR ResNets
from .resnet_imagenet import INResNet, TVResNet  # the ImageNet-style ResNets
from .wideresnet import WideResNet  # and WideResNet-28x10

__all__ = ["BatchNorm2d", "CifarResNet", "Conv2d", "Dropout", "INResNet", "LeNet5", "Linear",
           "MLP", "ModelCfg", "PreResNet", "TVResNet", "WideResNet", "dropout_generator",
           "dropout_twin", "get_model", "list_models", "register"]
