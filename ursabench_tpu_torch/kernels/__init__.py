"""Hand-written GPU kernels, each beside its plain PyTorch version."""

from . import conv1x1, eval_epilogue, int8_gemv, sghmc, stream_probe

__all__ = ["conv1x1", "eval_epilogue", "int8_gemv", "sghmc", "stream_probe"]
