"""Hand-written GPU kernels, each beside its plain PyTorch version."""

from . import int8_gemv, sghmc, stream_probe

__all__ = ["int8_gemv", "sghmc", "stream_probe"]
