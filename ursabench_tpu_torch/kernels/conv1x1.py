"""Kernels K3a and K3b: the forward and the weight gradient of a 1x1
convolution as bf16 GEMMs, built from ``csrc/conv1x1.cu``.

On channels-last activations flattened to rows (M = N*H*W; a stride-2 1x1
conv first takes the top-left tap, ``x[:, ::2, ::2, :]``):

- ``conv1x1_mm(x, w)`` (K3a): ``x (M, K) @ w (K, N)``, float32 accumulation,
  one rounding to bf16; the counterpart of
  ``benchmarks/rn50_conv1x1_pallas_probe.py::pallas_mm``;
- ``conv1x1_wgrad(x, g)`` (K3b): ``x^T g``, (K, N), summed over M in float32
  and rounded once; the counterpart of ``pallas_wgrad``. M is cut into
  contiguous splits, each CTA sums one split of one dw tile, and the float32
  partials are summed in split order inside the same launch: two runs give
  the same bits.

Both kernels run a persistent grid of at most one CTA per SM. What each CTA
computes, and in which order, is decided here (``mm_plan``,
``wgrad_plan``) and passed to the kernel; ``tile_order`` and
``split_ranges`` spell the plan out for the tests.

The TPU functions take an M tile ``tm`` that must divide M; the CUDA kernels
tile M themselves (TMA fills past the last row with zeros and drops stores
past it), so any M >= 1 is accepted. K and N must be multiples of 16. On
CUDA tensors the wrappers launch the kernel (``.launches`` counts the
calls), on CPU tensors they run the plain PyTorch versions
``conv1x1_mm_reference`` / ``conv1x1_wgrad_reference``, and they raise on
anything else, on a failed build and on a failed launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch

from .build import CSRC, Library, load

SOURCE = CSRC / "conv1x1.cu"
MULTIPLE = 16  # K and N: whole k16 steps; TMA rows of a multiple of 16 bytes
TILE_ROWS = 128  # rows of a tile of y (K3a) or dw (K3b): 64 a consumer warpgroup
STEP = 64  # rows of M a K3b stage; every split but the last is a multiple of it
L2_REREAD_BYTES = 4e8  # K3b's switch to 128-column tiles (wgrad_plan)

__all__ = ["SOURCE", "Plan", "conv1x1_mm", "conv1x1_mm_reference", "conv1x1_wgrad",
           "conv1x1_wgrad_reference", "load_library", "mm_plan", "split_ranges",
           "tile_order", "wgrad_plan"]


@dataclass(frozen=True)
class Plan:
    """How a launch cuts its work. ``tile`` is the (rows, cols) block of the
    output a CTA computes at a time, ``grid`` the number of tiles along each
    axis, ``ctas`` the persistent grid. K3b also cuts M into ``splits``
    ranges of ``chunk`` rows, the last one ending at M."""

    tile: Tuple[int, int]
    grid: Tuple[int, int]
    ctas: int
    splits: int = 1
    chunk: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def mm_plan(m: int, k: int, n: int, sms: int) -> Plan:
    """K3a: tiles of 128 rows of y by 64 columns (N <= 64), 256 (N >= 1024:
    fewer re-reads of x from L2, a gain of up to 9% at ResNet-50's four such
    shapes on an H100, against losses of up to 28% where N is 256 or 512;
    PERF.md) or else 128, one CTA an SM at most."""
    tile = (TILE_ROWS, 64 if n <= 64 else 256 if n >= 1024 else 128)
    grid = (_cdiv(m, tile[0]), _cdiv(n, tile[1]))
    return Plan(tile, grid, min(grid[0] * grid[1], sms))


@functools.lru_cache(maxsize=256)
def wgrad_plan(m: int, k: int, n: int, sms: int) -> Plan:
    """K3b: dw tiles of 128 rows by 64 columns, or by 128 where 64-column
    tiles would have the CTAs re-read at least ``L2_REREAD_BYTES`` of x and
    g from L2 (x once per column tile, g once per row tile): 128 columns
    halve x's re-reads but double the splits' partials. On an H100 the
    threshold picks the faster width, or one within 3% of it, at 15 of
    ResNet-50's 16 1x1 shapes (PERF.md). M is cut into as many splits as
    leave one (split, tile) unit per SM, none shorter than one 64-row stage
    and none empty: fewer, longer splits write fewer float32 partials. With
    more tiles than SMs there is one split and the CTAs loop over tiles."""
    reread = 2 * m * (k * _cdiv(n, 64) + n * _cdiv(k, TILE_ROWS))
    tile = (TILE_ROWS, 128 if n > 64 and reread >= L2_REREAD_BYTES else 64)
    grid = (_cdiv(k, tile[0]), _cdiv(n, tile[1]))
    tiles = grid[0] * grid[1]
    want = max(1, min(sms // tiles, _cdiv(m, STEP)))
    chunk = _cdiv(_cdiv(m, want), STEP) * STEP
    splits = _cdiv(m, chunk)
    return Plan(tile, grid, min(tiles * splits, sms), splits, chunk)


def tile_order(plan: Plan) -> List[List[Tuple[int, int, int]]]:
    """What each CTA computes, in order, as (split, tile row, tile col): the
    kernels walk units u = cta, cta + ctas, ... below splits * tiles, unit u
    being split u // tiles and tile u % tiles, tiles numbered row by row (so
    the column tiles of one row tile run at once on neighbouring CTAs)."""
    tiles = plan.grid[0] * plan.grid[1]
    return [[(u // tiles, u % tiles // plan.grid[1], u % plan.grid[1])
             for u in range(c, plan.splits * tiles, plan.ctas)]
            for c in range(plan.ctas)]


def split_ranges(plan: Plan, m: int) -> List[Tuple[int, int]]:
    """The [begin, end) rows of M of each K3b split, in split order."""
    return [(s * plan.chunk, min(m, (s + 1) * plan.chunk)) for s in range(plan.splits)]


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library. Raises on failure."""
    library = load(SOURCE)
    fn = library.lib.conv1x1
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return library


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _arrivals(index: int) -> torch.Tensor:
    """K3b's grid-barrier counter on one device: zeroed once, and left at 0
    by every launch that uses it."""
    return torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", index))


def conv1x1_mm_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3a: a float32 product, rounded once."""
    return (x.float() @ w.float()).to(x.dtype)


def conv1x1_wgrad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K3b: a float32 ``x^T g``, rounded once."""
    return (x.float().T @ g.float()).to(x.dtype)


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


def _launch(name: str, op: int, a, b, out, partial, arrivals, m, k, n, plan: Plan) -> None:
    if (a.data_ptr() | b.data_ptr() | out.data_ptr()) % 16:
        raise ValueError(f"{name}: operands must be 16-byte aligned")
    fn = load_library().lib.conv1x1
    index = a.device.index
    # the kernel launches on the runtime's current device: switch only if the
    # operands live elsewhere (on the H100's host the device guard costs 2-5
    # us a call and torch.cuda.current_stream 4-8 us; the raw pointer 0.1 us)
    guard = (torch.cuda.device(index) if index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        err = fn(op, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 0 if partial is None else partial.data_ptr(),
                 0 if arrivals is None else arrivals.data_ptr(), m, k, n, *plan.tile,
                 plan.ctas, plan.splits, plan.chunk, torch._C._cuda_getCurrentRawStream(index))
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
    plan = mm_plan(m, k, n, _sms(x.device.index))
    _launch("conv1x1_mm", 0, x, w, y, None, None, m, k, n, plan)
    conv1x1_mm.launches += 1
    return y


conv1x1_mm.launches = 0  # kernel launches since the last reset


def conv1x1_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dw = bf16(x^T g)`` for x (M, K) and g (M, N) bf16: the weight
    gradient of a 1x1 conv, (C_in, C_out), from its input rows and the
    gradient of its output rows. CUDA tensors launch K3b (one launch,
    cooperative when M is split) on the current stream without
    synchronising; CPU tensors take the plain version. Two K3b launches
    must not run at once on one device: they share its barrier counter."""
    _check("conv1x1_wgrad", x, g)
    if x.device.type == "cpu":
        return conv1x1_wgrad_reference(x, g)
    if not x.is_cuda:
        raise ValueError(f"conv1x1_wgrad takes CUDA or CPU tensors, got {x.device}")
    (m, k), n = x.shape, g.shape[1]
    index = x.device.index
    plan = wgrad_plan(m, k, n, _sms(index))
    partial = arrivals = None
    if plan.splits > 1:
        partial = torch.empty(plan.splits, k, n, dtype=torch.float32, device=x.device)
        arrivals = _arrivals(index)
    dw = torch.empty(k, n, dtype=x.dtype, device=x.device)
    _launch("conv1x1_wgrad", 1, x, g, dw, partial, arrivals, m, k, n, plan)
    conv1x1_wgrad.launches += 1
    return dw


conv1x1_wgrad.launches = 0  # kernel launches since the last reset
