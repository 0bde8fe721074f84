"""Hand-written GPU kernels, each beside its plain PyTorch version."""

from . import sghmc

__all__ = ["sghmc"]
