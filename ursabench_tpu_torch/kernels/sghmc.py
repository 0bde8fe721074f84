"""Kernel K1: the fused SGHMC update, built from ``csrc/sghmc_update.cu``.

Replaces the TPU kernel ``benchmarks/pallas_sgmcmc.py::sghmc_update_flat``.
``sghmc_update_flat`` launches the CUDA kernel on CUDA tensors and raises on
anything else; ``sghmc_update_flat_reference`` is the plain PyTorch version
of the same step, with the normals passed in.

The scalars are a float32[5] for the whole buffer, or a table of R rows of 5
for a buffer of R rows (row r of the (R, P) buffer takes table row r: a
sweep's K configurations, ``inference/vectorized.py``). A (1, 5) table is
the float32[5]: the same launch and the same random stream.

A buffer may be a block of a larger one (the rows of chains c0.. that one
rank of a device mesh holds): ``offset`` is the global index of its first
element, and element i then draws the normal of global element offset + i,
as the whole buffer's launch would.

The seed is a Python int, or a one-element int64 CUDA tensor that the
kernel reads from device memory when it runs (a second C entry of the same
kernel): a CUDA graph that captured the launch then takes each replay's
seed from that tensor. The two give the same bits for the same seed.
``sghmc_update_flat.launches`` counts launches that ran: a captured one at
each replay of its graph (``tracing.count``).

The library is built and loaded by ``kernels/build.py`` at first use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from .build import BUILD_DIR, CSRC, NVCC_FLAGS, Library, load

SOURCE = CSRC / "sghmc_update.cu"
__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCE", "load_library",
           "sghmc_update_flat", "sghmc_update_flat_reference", "table_rows"]


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library. Raises on failure."""
    library = load(SOURCE)
    fn = library.lib.sghmc_update_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = library.lib.sghmc_update_f32_dseed
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return library


def table_rows(scalars: torch.Tensor) -> int:
    """The rows R of a scalar table: 1 for a float32[5], R for (R, 5)."""
    if scalars.dim() == 1 and scalars.numel() == 5:
        return 1
    if scalars.dim() == 2 and scalars.shape[1] == 5 and scalars.shape[0] >= 1:
        return scalars.shape[0]
    raise ValueError(f"scalars must be (5,) or (R, 5), got {tuple(scalars.shape)}")


def _check(p, v, g, scalars):
    for name, t in (("params", p), ("momentum", v), ("grads", g),
                    ("scalars", scalars)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, params on {p.device}")
    if v.shape != p.shape or g.shape != p.shape:
        raise ValueError(f"buffers of one shape expected, got "
                         f"{tuple(p.shape)} {tuple(v.shape)} {tuple(g.shape)}")
    rows = table_rows(scalars)
    if p.numel() % rows:
        raise ValueError(f"{rows} rows of scalars for {p.numel()} elements")
    return rows


def _check_seed(seed: torch.Tensor, p: torch.Tensor) -> None:
    if not seed.is_cuda or seed.device != p.device:
        raise ValueError(f"a seed tensor must be a CUDA tensor on {p.device}, got {seed.device}")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError(f"a seed tensor must hold one int64, got {seed.numel()} "
                         f"{seed.dtype}")


def sghmc_update_flat(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                      scalars: torch.Tensor, seed, offset: int = 0):
    """One SGHMC/SGLD step in place on contiguous float32 CUDA buffers.

    ``scalars`` is a device float32[5], (lr, momentum, wd_over_n,
    noise_scale, is_first), or an (R, 5) table of them, row r for row r of
    the buffers seen as (R, numel / R). ``seed`` keys the in-kernel Philox
    stream (element i of the flat buffer draws from (seed, offset + i)) and
    must differ between steps; ``offset`` is the global index of element 0
    when the buffer is a block of a larger one. Launches on the current
    stream, without synchronising. Returns ``(p, v)``.

    ``seed`` may be a one-element int64 tensor on ``p``'s device: the
    kernel then reads it when it runs (its bits as an unsigned 64-bit
    integer), which is what a captured launch needs."""
    rows = _check(p, v, g, scalars)
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    lib = load_library().lib
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        args = (p.data_ptr(), v.data_ptr(), g.data_ptr(), scalars.data_ptr(), p.numel(), rows)
        if isinstance(seed, torch.Tensor):
            _check_seed(seed, p)
            err = lib.sghmc_update_f32_dseed(*args, seed.data_ptr(), int(offset), stream)
        else:
            err = lib.sghmc_update_f32(*args, int(seed) & (2 ** 64 - 1), int(offset), stream)
    if err != 0:
        raise RuntimeError(f"sghmc_update_f32 launch failed with CUDA error {err}")
    tracing.count(sghmc_update_flat)
    return p, v


sghmc_update_flat.launches = 0  # kernel launches since the last reset (tracing.count)


def sghmc_update_flat_reference(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                                scalars: torch.Tensor, noise: torch.Tensor):
    """The plain PyTorch version of ``sghmc_update_flat``, in place, with the
    standard normals ``noise`` given (as many as ``p`` holds). Same
    operations in the same order; an (R, 5) table applies its rows as (R, 1)
    columns to the buffers seen as (R, numel / R)."""
    rows = table_rows(scalars)
    lr, momentum, wd_over_n, noise_scale, is_first = scalars.reshape(rows, 5, 1).unbind(1)
    pr, vr, gr = p.view(rows, -1), v.view(rows, -1), g.view(rows, -1)
    d = gr + wd_over_n * pr
    v_prev = torch.where(is_first > 0.5, d, vr)
    v_new = momentum * v_prev - lr * d
    v_new = v_new + noise_scale * noise.reshape(rows, -1)
    vr.copy_(v_new)
    pr.add_(v_new)
    return p, v
