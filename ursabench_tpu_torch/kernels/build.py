"""Build the libraries of ``csrc/`` and load them with ``ctypes``.

Each source is compiled on its own into a shared library with a plain C
interface, at first use, into ``ursabench_tpu_torch/_build/`` under a name
that carries the source's hash: an edited source builds anew, an unchanged
one is reused. A ``.cu`` source is a kernel, compiled by ``nvcc`` for
``sm_90a``; a ``.cc`` source is host code (the data pipeline,
``csrc/dataio.cc``), compiled by the host's C++ compiler with the flags of
``native/Makefile``. ``build`` starts one compiler per missing library, all
at once, and waits for them all; ``ptxas_report`` gives what ptxas said of
each kernel it compiled in this process (registers, shared memory, spills).
Nothing is built or loaded at import.
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
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-shared"]


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


def _command(source: Path, out: Path) -> list:
    if source.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)]
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler to build {source.name}: set CXX or put g++ on PATH")
    return [cxx, *HOST_FLAGS, "-o", str(out), str(source), "-lpthread"]


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


_BUILD_SECONDS: Dict[Path, float] = {}
_PTXAS: Dict[Path, str] = {}


def build(sources: Sequence[Path]) -> Dict[Path, float]:
    """Compile every source whose library is missing, one compiler each,
    all started together. Returns ``{source: seconds}`` (0.0 for a library
    that was already built). Raises with the compiler's output if any
    build fails."""
    jobs = {}
    for source in sources:
        path = library_path(source)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(_command(source, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[source] = (proc, tmp, path, time.perf_counter())
    failures = []
    for source, (proc, tmp, path, t0) in jobs.items():
        _, stderr = proc.communicate()
        _BUILD_SECONDS[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{Path(proc.args[0]).name} failed on {source.name} "
                            f"({proc.returncode}):\n{stderr}")
        else:
            _PTXAS[source] = stderr
            os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {source: _BUILD_SECONDS.get(source, 0.0) for source in sources}


def ptxas_report(source: Path) -> Dict[str, str]:
    """``{kernel: "N registers, ... spill ..."}`` from ptxas's ``-v`` report of
    ``source``, for the kernels built in this process (empty if its library
    was reused)."""
    report, kernel = {}, None
    for line in _PTXAS.get(source, "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel is not None and ("spill" in line or "Used" in line):
            report[kernel] = " ".join(filter(None, (report.get(kernel), line.split(":")[-1].strip())))
    return report


@functools.lru_cache(maxsize=None)
def load(source: Path) -> Library:
    """Build ``source`` if needed and load its library. Raises on failure."""
    seconds = build([source])[source]
    path = library_path(source)
    return Library(ctypes.CDLL(str(path)), path, seconds)
