"""A stretch of a run's own work under ``torch.profiler``, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

The events come from the profiler's Kineto results (CUPTI's device
activities and the host's operator and runtime events, on one clock). The
device is busy where some device activity (a kernel, a copy, a fill) runs:
the union of their intervals, not their sum. The traced window runs from
the first event to the last. Each idle gap of the device is put down to the
innermost host event under way at its midpoint (of those begun, the last
that has not ended), or to "host, untraced" where none is.

``KERNEL_CLASSES`` began as a copy of the kernel-class table of the port's
``profiling/step_profile.py`` and now differs from it: it has an
``attention`` class (flash, fused multi-head and SDPA kernels) ahead of
"convolutions and GEMMs", so an attention kernel, whose names often hold
``gemm`` or ``cutlass`` too, is not counted as a GEMM. A kernel's class is
the first whose substrings its name holds.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

KERNEL_CLASSES = (
    ("K1 (sghmc_update)", ("sghmc_update",)),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("layout transforms", ("nchwToNhwc", "nhwcToNchw", "transpose")),
    ("attention", ("flash", "fmha", "sdpa", "attention")),
    ("convolutions and GEMMs", ("conv", "gemm", "sm90_", "sm80_", "cutlass", "xmma", "wgrad",
                                "dgrad", "implicit")),
    ("dropout and random", ("bernoulli", "philox", "random", "distribution")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index", "copy", "fill")),
)
UNTRACED = "host, untraced"


def kernel_class(name: str) -> str:
    low = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k.lower() in low for k in keys):
            return label
    return "other"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device: Dict[str, Tuple[int, float]]  # name -> (count, seconds)
    gaps: Dict[str, float]  # what the host was doing -> idle seconds of the device

    def kernels(self, substring: str) -> Tuple[int, float]:
        """(count, seconds) of the device activities whose name holds ``substring``."""
        count, seconds = 0, 0.0
        for name, (n, s) in self.device.items():
            if substring in name:
                count, seconds = count + n, seconds + s
        return count, seconds

    def device_ops(self, top: int = 10) -> List[list]:
        by_class: Dict[str, float] = defaultdict(float)
        for name, (_, s) in self.device.items():
            by_class[kernel_class(name)] += s
        return [[k, v] for k, v in sorted(by_class.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]]


def idle_pct(trace: Trace) -> float:
    """100 less the device's busy share of the traced window."""
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def reduce(events) -> Trace:
    """A ``Trace`` from Kineto events (``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``)."""
    device, host = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((start, start + dur, e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append((start, start + dur, e.name()))
    if not device:
        raise RuntimeError("the traced stretch ran nothing on the device")
    stamps = [t for s, e, _ in device + host for t in (s, e)]
    t0, t1 = min(stamps), max(stamps)
    busy = _union([(s, e) for s, e, _ in device])
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, e, name in device:
        per_name[name][0] += 1
        per_name[name][1] += (e - s) * 1e-9
    idle = []
    edge = t0
    for s, e in busy:
        if s > edge:
            idle.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        idle.append((edge, t1))
    host.sort()
    gaps: Dict[str, float] = defaultdict(float)
    active: List[tuple] = []  # host events begun by the gap, in order of start
    nxt = 0
    for gs, ge in idle:  # in order of time
        mid = (gs + ge) // 2
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        while active and active[-1][1] <= mid:
            active.pop()
        gaps[active[-1][2] if active else UNTRACED] += (ge - gs) * 1e-9
    return Trace(window_s=(t1 - t0) * 1e-9, busy_s=sum(e - s for s, e in busy) * 1e-9,
                 device={k: (int(v[0]), float(v[1])) for k, v in per_name.items()},
                 gaps=dict(gaps))


def traced(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` (work that ends on the device) under the profiler and reduce
    what it recorded."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return reduce(prof.profiler.kineto_results.events())
