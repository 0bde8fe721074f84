"""Kernels K3a and K3b: the forward and the weight gradient of a 1x1
convolution as bf16 GEMMs, built from ``csrc/conv1x1.cu``.

On channels-last activations flattened to rows (M = N*H*W; a stride-2 1x1
conv first takes the top-left tap, ``x[:, ::2, ::2, :]``):

- ``conv1x1_mm(x, w)`` (K3a): ``x (M, K) @ w (K, N)``, float32 accumulation,
  one rounding to bf16; the counterpart of
  ``benchmarks/rn50_conv1x1_pallas_probe.py::pallas_mm``;
- ``conv1x1_wgrad(x, g)`` (K3b): ``x^T g``, (K, N), summed over M in float32
  and rounded once; the counterpart of ``pallas_wgrad``. M is split across
  blocks and the float32 partials (``wgrad_splits`` chunks) are summed in a
  second pass, in a fixed order: two runs give the same bits.

The TPU functions take an M tile ``tm`` that must divide M; the CUDA kernels
tile M themselves and mask the last tile, so any M >= 1 is accepted. K and
N must be multiples of 16. On CUDA tensors the wrappers launch the kernel
(``.launches`` counts the calls), on CPU tensors they run the plain PyTorch
versions ``conv1x1_mm_reference`` / ``conv1x1_wgrad_reference``, and they
raise on anything else, on a failed build and on a failed launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import CSRC, Library, load

SOURCE = CSRC / "conv1x1.cu"
MULTIPLE = 16  # K and N: whole 16 x 16 fragments
SPLIT_ROWS = 32  # rows of M per step of a K3b block
BLOCK_TILE = (128, 64)  # the (K, N) tile of dw one K3b block owns
BLOCKS_PER_SM = 2  # K3b aims at this many blocks per SM

__all__ = ["SOURCE", "conv1x1_mm", "conv1x1_mm_reference", "conv1x1_wgrad",
           "conv1x1_wgrad_reference", "load_library", "wgrad_splits"]


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library. Raises on failure."""
    library = load(SOURCE)
    fn = library.lib.conv1x1
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return library


def conv1x1_mm_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3a: a float32 product, rounded once."""
    return (x.float() @ w.float()).to(x.dtype)


def conv1x1_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3b: a float32 ``x^T g``, rounded once."""
    return (x.float().T @ g.float()).to(x.dtype)


def wgrad_splits(m: int, k: int, n: int, sms: int) -> int:
    """How many chunks K3b cuts M into: enough blocks for ``BLOCKS_PER_SM``
    on each of ``sms`` SMs over the (K, N) tiles, no chunk shorter than one
    32-row step, and no empty chunk (the kernel rounds each chunk up to a
    multiple of 32 rows, ``ceil(ceil(m / splits) / 32) * 32``)."""
    tiles = -(-k // BLOCK_TILE[0]) * -(-n // BLOCK_TILE[1])
    want = max(1, -(-BLOCKS_PER_SM * sms // tiles))
    splits = max(1, min(want, -(-m // SPLIT_ROWS), 65535))
    chunk = -(-(-(-m // splits)) // SPLIT_ROWS) * SPLIT_ROWS
    return -(-m // chunk)


def _check(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Two 2-D bf16 contiguous tensors on one device, sharing M (wgrad) or K
    (mm), K and N multiples of 16."""
    for label, t in (("first", a), ("second", b)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the {label} operand must be bfloat16, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name}: the {label} operand must be 2-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the {label} operand must be contiguous")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    shared = (a.shape[1], b.shape[0]) if name == "conv1x1_mm" else (a.shape[0], b.shape[0])
    if shared[0] != shared[1]:
        raise ValueError(f"{name}: shapes {tuple(a.shape)} and {tuple(b.shape)} do not match")
    m = a.shape[0]
    k, n = a.shape[1], b.shape[1]
    if m < 1 or k < MULTIPLE or n < MULTIPLE or k % MULTIPLE or n % MULTIPLE:
        raise ValueError(f"{name}: need M >= 1 and K, N multiples of {MULTIPLE}, got "
                         f"M={m}, K={k}, N={n}")
    if m >= 2 ** 31 or k * n >= 2 ** 31:
        raise ValueError(f"{name}: M={m}, K={k}, N={n} exceed the kernel's int range")


def _launch(name: str, op: int, a, b, out, partial, m, k, n, splits) -> None:
    if (a.data_ptr() | b.data_ptr() | out.data_ptr()) % 16:
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    fn = load_library().lib.conv1x1
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(op, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 0 if partial is None else partial.data_ptr(), m, k, n, splits, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def conv1x1_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = bf16(x @ w)`` for x (M, K) and w (K, N) bf16: the forward of a
    1x1 conv on channels-last rows, w the kernel as (C_in, C_out). CUDA
    tensors launch K3a on the current stream without synchronising; CPU
    tensors take the plain version."""
    _check("conv1x1_mm", x, w)
    if x.device.type == "cpu":
        return conv1x1_mm_reference(x, w)
    if not x.is_cuda:
        raise ValueError(f"conv1x1_mm takes CUDA or CPU tensors, got {x.device}")
    (m, k), n = x.shape, w.shape[1]
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    _launch("conv1x1_mm", 0, x, w, y, None, m, k, n, 0)
    conv1x1_mm.launches += 1
    return y


conv1x1_mm.launches = 0  # kernel launches since the last reset


def conv1x1_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dw = bf16(x^T g)`` for x (M, K) and g (M, N) bf16: the weight
    gradient of a 1x1 conv, (C_in, C_out), from its input rows and the
    gradient of its output rows. CUDA tensors launch K3b (a partial-sum
    kernel and a fixed-order reduction) on the current stream without
    synchronising; CPU tensors take the plain version."""
    _check("conv1x1_wgrad", x, g)
    if x.device.type == "cpu":
        return conv1x1_wgrad_reference(x, g)
    if not x.is_cuda:
        raise ValueError(f"conv1x1_wgrad takes CUDA or CPU tensors, got {x.device}")
    (m, k), n = x.shape, g.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = wgrad_splits(m, k, n, sms)
    partial = torch.empty(splits, k, n, dtype=torch.float32, device=x.device)
    dw = torch.empty(k, n, dtype=x.dtype, device=x.device)
    _launch("conv1x1_wgrad", 1, x, g, dw, partial, m, k, n, splits)
    conv1x1_wgrad.launches += 1
    return dw


conv1x1_wgrad.launches = 0  # kernel launches since the last reset
