"""The eval-mode epilogue of a 16-bit WideResNet block as two kernels, built
from ``csrc/eval_epilogue.cu``.

Replaces no TPU kernel (XLA fuses the chain there). Over channels-last bf16
activations:

- ``fused_batchnorm_eval_relu(t, weight, bias, running_mean, running_var,
  eps, conv_bias)``: ``relu(bf16(BatchNorm(float32(t))))`` with the running
  statistics, where ``t`` is the input, or ``bf16(t + bf16(conv_bias))``
  when the previous conv's bias is folded in;
- ``bias_residual_add(y, bias, r, r_bias)``: ``bf16(bf16(y + bf16(bias)) +
  r)``, where ``r`` is the block input, or ``bf16(r + bf16(r_bias))`` for a
  shortcut conv's output without its bias.

The ``*_reference`` twins are the unfused op sequences, which define where
the results round to bf16; the wrappers take them for CPU tensors. For a
CUDA tensor a wrapper launches its kernel on the current stream, without
synchronising, or raises: bf16 activations, channels-last contiguous and
16-byte aligned, with a multiple of 8 channels, at most 2,048; float32
parameters of one per channel, contiguous, on the same device. The
kernels normalize as aten's own eval kernel does, bit for bit; cuDNN's NHWC
kernel, which the twin runs on the card, rounds its float32 another way, so
some 2e-5 of the results differ from it, by one bf16 ulp, or by a few where
the normalization cancels to near 0. ``.launches`` on each wrapper
counts the launches that ran (``tracing.count``: a captured one at each
replay of its graph).

The library is built and loaded by ``kernels/build.py`` at first use.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .. import tracing
from .build import CSRC, Library, load

SOURCE = CSRC / "eval_epilogue.cu"
MAX_CHANNELS = 2048  # 256 threads of 8 channels: a block holds a whole row
__all__ = ["MAX_CHANNELS", "SOURCE", "bias_residual_add", "bias_residual_add_reference",
           "fused_batchnorm_eval_relu", "fused_batchnorm_eval_relu_reference", "load_library"]

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library. Raises on failure."""
    library = load(SOURCE)
    fn = library.lib.fused_batchnorm_eval_relu_bf16
    fn.argtypes = [_P] * 6 + [ctypes.c_float, _P, ctypes.c_longlong, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    fn = library.lib.bias_residual_add_bf16
    fn.argtypes = [_P] * 5 + [ctypes.c_longlong, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return library


def fused_batchnorm_eval_relu_reference(t: torch.Tensor, weight: torch.Tensor,
                                        bias: torch.Tensor, running_mean: torch.Tensor,
                                        running_var: torch.Tensor, eps: float,
                                        conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unfused sequence: the conv's bias add, the eval BatchNorm in
    float32, its cast back and ReLU."""
    if conv_bias is not None:
        t = t + conv_bias.to(t.dtype).view(1, -1, 1, 1)
    out = F.batch_norm(t.to(torch.float32), running_mean, running_var, weight, bias,
                       False, 0.0, eps)
    return F.relu(out.to(t.dtype))


def bias_residual_add_reference(y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor,
                                r_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unfused sequence: the conv's bias add, the shortcut conv's, the
    residual add."""
    y = y + bias.to(y.dtype).view(1, -1, 1, 1)
    if r_bias is not None:
        r = r + r_bias.to(r.dtype).view(1, -1, 1, 1)
    return y + r


def _check_activation(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} must be a channels-last contiguous (N, C, H, W) tensor")
    if t.shape != like.shape or t.device != like.device:
        raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, expected "
                         f"{tuple(like.shape)} on {like.device}")
    c = t.shape[1]
    if c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"{name} has {c} channels: a multiple of 8 up to {MAX_CHANNELS} "
                         f"expected")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_parameter(name: str, v: Optional[torch.Tensor], like: torch.Tensor) -> int:
    """The parameter's pointer (0 for None) after its checks."""
    if v is None:
        return 0
    if v.device != like.device or v.dtype != torch.float32 or not v.is_contiguous() \
            or v.shape != (like.shape[1],):
        raise ValueError(f"{name} must be a contiguous float32 ({like.shape[1]},) tensor on "
                         f"{like.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    return v.data_ptr()


def _launch(name: str, device: torch.device, *args) -> None:
    """Calls the library's ``name`` with ``args`` and the current stream of
    ``device`` (made the current device for the call where it is not);
    raises if the launch failed."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(name, device, *args)
    err = getattr(load_library().lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def fused_batchnorm_eval_relu(t: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              running_mean: torch.Tensor, running_var: torch.Tensor,
                              eps: float,
                              conv_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu`` of the eval BatchNorm of ``t`` (with ``conv_bias``, the
    previous conv's bias, added first) as one kernel; a new channels-last
    bf16 tensor."""
    if t.device.type == "cpu":
        return fused_batchnorm_eval_relu_reference(t, weight, bias, running_mean, running_var,
                                                   eps, conv_bias)
    _check_activation("t", t, t)
    ptrs = [_check_parameter(name, v, t) for name, v in (
        ("conv_bias", conv_bias), ("weight", weight), ("bias", bias),
        ("running_mean", running_mean), ("running_var", running_var))]
    out = torch.empty_like(t, memory_format=torch.channels_last)
    _launch("fused_batchnorm_eval_relu_bf16", t.device, t.data_ptr(), *ptrs, float(eps),
            out.data_ptr(), t.numel() // t.shape[1], t.shape[1] // 8)
    tracing.count(fused_batchnorm_eval_relu)
    return out


fused_batchnorm_eval_relu.launches = 0  # kernel launches since the last reset (tracing.count)


def bias_residual_add(y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor,
                      r_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y`` plus its conv's ``bias``, plus the residual ``r`` (plus its
    shortcut conv's ``r_bias``), as one kernel; a new channels-last bf16
    tensor."""
    if bias is None:
        raise ValueError("bias must be the conv's float32 bias, got None")
    if y.device.type == "cpu":
        return bias_residual_add_reference(y, bias, r, r_bias)
    _check_activation("y", y, y)
    _check_activation("r", r, y)
    b, rb = _check_parameter("bias", bias, y), _check_parameter("r_bias", r_bias, y)
    out = torch.empty_like(y, memory_format=torch.channels_last)
    _launch("bias_residual_add_bf16", y.device, y.data_ptr(), b, r.data_ptr(), rb,
            out.data_ptr(), y.numel() // y.shape[1], y.shape[1] // 8)
    tracing.count(bias_residual_add)
    return out


bias_residual_add.launches = 0  # kernel launches since the last reset (tracing.count)
