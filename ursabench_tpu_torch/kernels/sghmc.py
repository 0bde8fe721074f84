"""Kernel K1: the fused SGHMC update, built from ``csrc/sghmc_update.cu``.

Replaces the TPU kernel ``benchmarks/pallas_sgmcmc.py::sghmc_update_flat``.
``sghmc_update_flat`` launches the CUDA kernel on CUDA tensors and raises on
anything else; ``sghmc_update_flat_reference`` is the plain PyTorch version
of the same step, with the normals passed in.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``ursabench_tpu_torch/_build/`` under a name that carries the source's
hash, and bound with ``ctypes``. Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sghmc_update.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


@dataclass(frozen=True)
class Library:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was reused


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library. Raises on failure."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    path = BUILD_DIR / f"libsghmc_update-{digest}.so"
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    fn = lib.sghmc_update_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return Library(lib, path, seconds)


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
    if p.dim() != 1 or v.shape != p.shape or g.shape != p.shape:
        raise ValueError(f"flat buffers of one size expected, got "
                         f"{tuple(p.shape)} {tuple(v.shape)} {tuple(g.shape)}")
    if scalars.numel() != 5:
        raise ValueError(f"scalars must hold 5 values, got {scalars.numel()}")


def sghmc_update_flat(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                      scalars: torch.Tensor, seed: int):
    """One SGHMC/SGLD step in place on flat float32 CUDA buffers.

    ``scalars`` is a device float32[5]: (lr, momentum, wd_over_n,
    noise_scale, is_first). ``seed`` keys the in-kernel Philox stream and
    must differ between steps. Launches on the current stream, without
    synchronising. Returns ``(p, v)``."""
    _check(p, v, g, scalars)
    fn = load_library().lib.sghmc_update_f32
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), v.data_ptr(), g.data_ptr(), scalars.data_ptr(),
                 p.numel(), int(seed) & (2 ** 64 - 1), stream)
    if err != 0:
        raise RuntimeError(f"sghmc_update_f32 launch failed with CUDA error {err}")
    sghmc_update_flat.launches += 1
    return p, v


sghmc_update_flat.launches = 0  # kernel launches since the last reset


def sghmc_update_flat_reference(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                                scalars: torch.Tensor, noise: torch.Tensor):
    """The plain PyTorch version of ``sghmc_update_flat``, in place, with the
    standard normals ``noise`` given. Same operations in the same order."""
    lr, momentum, wd_over_n, noise_scale, is_first = scalars.unbind()
    d = g + wd_over_n * p
    v_prev = torch.where(is_first > 0.5, d, v)
    v_new = momentum * v_prev - lr * d
    v_new = v_new + noise_scale * noise
    v.copy_(v_new)
    p.add_(v_new)
    return p, v
