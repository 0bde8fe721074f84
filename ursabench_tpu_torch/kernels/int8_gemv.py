"""Kernels K2, K4b and K4d: the int8 weight-streaming GEMV, built from
``csrc/int8_gemv.cu``.

``int8_matvec(w_q8, scales, x, variant=...)`` quantizes ``x`` per tensor in
plain torch and runs the GEMV; it is the counterpart of three TPU functions:

- ``benchmarks/pallas_int8.py::int8_matvec`` (K2) -> ``variant="mma"``;
- ``benchmarks/pallas_matvec_probe.py::matvec_row`` (K4b):
  ``kernel="mxu"`` -> ``variant="mma_row"``, ``kernel="vpu"`` ->
  ``variant="dp4a"``;
- ``benchmarks/pallas_matvec_probe2.py::vpu_matvec`` (K4d) ->
  ``variant="dp4a"``.

The TPU functions take a ``tile_n`` that sets their grid; the CUDA kernel's
grid is its own (16 rows a block), so there is none here, and any N >= 1 is
accepted (rows past the last block of 16 are masked).

``int8_gemv`` is the kernel alone on an already quantized ``xq``: on CUDA
tensors it launches the kernel, on CPU tensors it runs
``int8_gemv_reference``, the plain PyTorch version, and it raises on
anything else. ``int8_gemv.launches[variant]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import CSRC, Library, load

SOURCE = CSRC / "int8_gemv.cu"
VARIANTS = ("mma", "mma_row", "dp4a")
K_MULTIPLE = 64  # bytes of K per warp step in the kernel
MAX_K = 131072  # keeps |acc| <= K * 127 * 127 < 2**31 and xq in shared memory

__all__ = ["SOURCE", "VARIANTS", "int8_gemv", "int8_gemv_reference",
           "int8_matvec", "load_library", "quantize_activation"]


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library. Raises on failure."""
    library = load(SOURCE)
    fn = library.lib.int8_gemv
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return library


def quantize_activation(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization of ``x``, as the TPU functions
    do it outside their kernels (``pallas_int8.py:67-69``): returns ``(xq,
    x_scale)``, an int8 tensor and a float32[1] on ``x``'s device."""
    x = x.to(torch.float32)
    x_scale = torch.clamp_min(x.abs().max(), 1e-12).reshape(1) / 127.0
    xq = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    return xq, x_scale


def _check(w_q8, scales, xq, x_scale, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if w_q8.dim() != 2:
        raise ValueError(f"w_q8 must be (N, K), got shape {tuple(w_q8.shape)}")
    n, k = w_q8.shape
    for name, t, dtype, shape in (("w_q8", w_q8, torch.int8, (n, k)),
                                  ("scales", scales, torch.float32, (n,)),
                                  ("xq", xq, torch.int8, (k,)),
                                  ("x_scale", x_scale, torch.float32, (1,))):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != w_q8.device:
            raise ValueError(f"{name} is on {t.device}, w_q8 on {w_q8.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n < 1 or k < K_MULTIPLE or k % K_MULTIPLE or k > MAX_K:
        raise ValueError(f"need N >= 1 and K a multiple of {K_MULTIPLE} up to "
                         f"{MAX_K}, got ({n}, {k})")


def int8_gemv_reference(w_q8: torch.Tensor, scales: torch.Tensor,
                        xq: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the exact integer dot as a float64 product
    (exact, |acc| < 2**53), then the kernel's float32 epilogue,
    ``f32(acc) * scale * x_scale``, one rounding per product."""
    acc = w_q8.to(torch.float64) @ xq.to(torch.float64)
    return acc.to(torch.float32) * scales * x_scale


def int8_gemv(w_q8: torch.Tensor, scales: torch.Tensor, xq: torch.Tensor,
              x_scale: torch.Tensor, variant: str = "mma") -> torch.Tensor:
    """``y[n] = f32(sum_k w_q8[n, k] * xq[k]) * scales[n] * x_scale`` for
    w_q8 (N, K) int8, scales (N,) float32, xq (K,) int8, x_scale float32[1].
    CUDA tensors launch the kernel ``variant`` on the current stream without
    synchronising; CPU tensors take the plain version."""
    _check(w_q8, scales, xq, x_scale, variant)
    if w_q8.device.type == "cpu":
        return int8_gemv_reference(w_q8, scales, xq, x_scale)
    if not w_q8.is_cuda:
        raise ValueError(f"int8_gemv takes CUDA or CPU tensors, got {w_q8.device}")
    if (w_q8.data_ptr() | xq.data_ptr()) % 16:
        raise ValueError("w_q8 and xq must be 16-byte aligned")
    n, k = w_q8.shape
    y = torch.empty(n, dtype=torch.float32, device=w_q8.device)
    fn = load_library().lib.int8_gemv
    with torch.cuda.device(w_q8.device):
        stream = torch.cuda.current_stream(w_q8.device).cuda_stream
        err = fn(w_q8.data_ptr(), xq.data_ptr(), scales.data_ptr(),
                 x_scale.data_ptr(), y.data_ptr(), n, k, VARIANTS.index(variant),
                 stream)
    if err != 0:
        raise RuntimeError(f"int8_gemv ({variant}) launch failed with CUDA error {err}")
    int8_gemv.launches[variant] += 1
    return y


int8_gemv.launches = {v: 0 for v in VARIANTS}  # kernel launches since the last reset


def int8_matvec(w_q8: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                variant: str = "mma") -> torch.Tensor:
    """``(w_q8 * scales[:, None]) @ x`` as one int8 weight stream: ``x``
    (K,) float32 is quantized per tensor, then ``int8_gemv``. Returns (N,)
    float32."""
    xq, x_scale = quantize_activation(x)
    return int8_gemv(w_q8, scales, xq, x_scale, variant)
