"""Kernels K4a and K4c: the stream probe, built from ``csrc/stream_probe.cu``.

``stream_probe(w_q8, i, tile_n=..., out_cols=1)`` is the counterpart of
``benchmarks/pallas_matvec_probe.py::dma_only`` (K4a, output (G, 1)) and
``out_cols=128`` that of ``benchmarks/pallas_matvec_probe2.py::dma_only``
(K4c, output (G, 128), columns 1..127 zero where the TPU leaves them unset).
For each of the G = N / tile_n row tiles it returns the TPU probes' value
``out[g, 0] = sum(w_q8[g*tile_n : g*tile_n + 32, :128]) + i`` and, so that
the kernel must read every byte, ``tile_sum[g]``, the int32 sum of the whole
tile.

On CUDA tensors it launches the kernel, on CPU tensors it runs
``stream_probe_reference``, and it raises on anything else.
``stream_probe.launches[out_cols]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import CSRC, Library, load

SOURCE = CSRC / "stream_probe.cu"
LAYOUTS = (1, 128)  # out_cols of K4a and K4c
MAX_TILE_BYTES = 2 ** 24  # keeps |tile_sum| < 128 * 2**24 = 2**31

__all__ = ["LAYOUTS", "SOURCE", "load_library", "stream_probe",
           "stream_probe_reference"]


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library. Raises on failure."""
    library = load(SOURCE)
    fn = library.lib.stream_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return library


def _check(w_q8, tile_n, out_cols):
    if out_cols not in LAYOUTS:
        raise ValueError(f"out_cols must be one of {LAYOUTS}, got {out_cols}")
    if w_q8.dtype != torch.int8 or w_q8.dim() != 2 or not w_q8.is_contiguous():
        raise ValueError(f"w_q8 must be a contiguous (N, K) int8 tensor, got "
                         f"{w_q8.dtype} {tuple(w_q8.shape)}")
    n, k = w_q8.shape
    if tile_n < 32 or n < tile_n or n % tile_n or k < 128 or k % 16:
        raise ValueError(f"need tile_n >= 32 dividing N, K >= 128 and K % 16 == 0, "
                         f"got ({n}, {k}) with tile_n={tile_n}")
    if tile_n * k > MAX_TILE_BYTES:
        raise ValueError(f"a tile of {tile_n} x {k} bytes exceeds {MAX_TILE_BYTES}")


def stream_probe_reference(w_q8: torch.Tensor, i: int = 0, *, tile_n: int = 512,
                           out_cols: int = 1):
    """The plain PyTorch version: ``(out, tile_sum)`` from integer sums."""
    _check(w_q8, tile_n, out_cols)
    n, k = w_q8.shape
    tiles = w_q8.view(n // tile_n, tile_n, k)
    corner = tiles[:, :32, :128].sum(dim=(1, 2), dtype=torch.int64)
    out = torch.zeros(n // tile_n, out_cols, dtype=torch.float32, device=w_q8.device)
    out[:, 0] = corner.to(torch.float32) + float(i)
    return out, tiles.sum(dim=(1, 2), dtype=torch.int64).to(torch.int32)


def _splits(device: torch.device, groups: int, tile_bytes: int) -> int:
    """Blocks per tile: about two blocks per SM in all, and at least 4 KB
    of 16-byte loads (one per thread, four times) per block."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    wanted = -(-2 * sms // groups)
    return max(1, min(wanted, tile_bytes // (256 * 16 * 4)))


def stream_probe(w_q8: torch.Tensor, i: int = 0, *, tile_n: int = 512,
                 out_cols: int = 1):
    """Read every byte of ``w_q8`` (N, K) int8, tile by (tile_n, K) tile.
    Returns ``(out, tile_sum)``: out (N / tile_n, out_cols) float32 with the
    TPU probes' corner sum plus ``i`` in column 0, tile_sum (N / tile_n,)
    int32. CUDA tensors launch the kernel on the current stream without
    synchronising; CPU tensors take the plain version."""
    _check(w_q8, tile_n, out_cols)
    if w_q8.device.type == "cpu":
        return stream_probe_reference(w_q8, i, tile_n=tile_n, out_cols=out_cols)
    if not w_q8.is_cuda:
        raise ValueError(f"stream_probe takes CUDA or CPU tensors, got {w_q8.device}")
    if w_q8.data_ptr() % 16:
        raise ValueError("w_q8 must be 16-byte aligned")
    n, k = w_q8.shape
    groups = n // tile_n
    out = torch.empty(groups, out_cols, dtype=torch.float32, device=w_q8.device)
    tile_sum = torch.zeros(groups, dtype=torch.int32, device=w_q8.device)
    splits = _splits(w_q8.device, groups, tile_n * k)
    fn = load_library().lib.stream_probe
    with torch.cuda.device(w_q8.device):
        stream = torch.cuda.current_stream(w_q8.device).cuda_stream
        err = fn(w_q8.data_ptr(), out.data_ptr(), tile_sum.data_ptr(), groups,
                 tile_n, k, int(i), out_cols, splits, stream)
    if err != 0:
        raise RuntimeError(f"stream_probe launch failed with CUDA error {err}")
    stream_probe.launches[out_cols] += 1
    return out, tile_sum


stream_probe.launches = {c: 0 for c in LAYOUTS}  # kernel launches since the last reset
