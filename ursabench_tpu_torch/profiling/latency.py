"""Ensemble latency profiling: the trtprof protocol on the GPU.

Counterpart of ``ursabench_tpu/profiling/latency.py``. An "engine" is the
posterior-mean forward of an S-member ensemble in fp32, bf16 or int8
(weight-only, see ``quantize.py``), and the protocol is the reference's: 30
warm-up calls, 10 timed calls per batch, a 10-batch burn-in in the aggregate.
Results land in a JSON cache keyed by configuration, so an interrupted
sweep resumes, and ``tables.make_latex_table`` renders them.

Two engines time two things:

- the per-call engine (``build_engine``) runs the forward eagerly, and each
  timed call ends with the device->host copy of its result, as the
  reference times HtoD -> execute -> DtoH per call;
- the device engine (``build_amortized_engine``) captures one forward in a
  CUDA graph with static input and output buffers and replays it ``loop_k``
  times between two CUDA events: the quotient is the device's time per
  forward, without the host's dispatch. Every replay reads the stored
  weights again, and the int8 engine dequantizes them again.

Engines take NCHW float32 batches, the layout of the port's models.
fp32 rows assume TF32 is off (``main`` turns it off).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, vmap

# the member-layout rule lives with the ensembles it lays out
from ..inference.ensemble import MEMBER_STRATEGIES, member_cost, resolve_member_strategy
from .hw import device_name, device_peaks, forward_flops
from .quantize import dequantize_state, quantize_state

WARM_UP_ITERS = 30  # trtprof prof.py:141-150
REPS_PER_BATCH = 10  # trtprof prof.py:153-171
BURN_IN_BATCHES = 10  # trtprof run_prediction.py:70

PRECISIONS = ("fp32", "bf16", "int8")


@dataclass(frozen=True)
class ProfileConfig:
    model: str
    dataset: str
    precision: str  # 'fp32' | 'bf16' | 'int8' (weight-only, see quantize.py)
    ensemble_size: int
    batch_size: int

    def key(self) -> str:
        return (f"{self.model}.{self.dataset}.{self.precision}"
                f".ensemble{self.ensemble_size}.bs{self.batch_size}")


def _member(tree, i: int):
    """Member ``i`` of a (possibly nested) dict of stacked tensors."""
    if isinstance(tree, dict):
        return {k: _member(v, i) for k, v in tree.items()}
    return tree[i]


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _float32_heads(module: nn.Module) -> set:
    """The parameters of the plain ``nn.Linear`` heads, which take the conv
    models' float32 pooled features. ``models.common.Linear`` (the MLPs' and
    LeNet's layers) takes its input's dtype instead."""
    return {f"{name}.{p}" for name, m in module.named_modules()
            if type(m) is nn.Linear for p, _ in m.named_parameters(recurse=False)}


def _prep_forward(module: nn.Module, state, precision: str,
                  member_strategy: str = "vmap"):
    """Returns ``(fn, stored)``: ``fn(stored, x)`` maps an NCHW batch to the
    (B, C) float32 posterior-mean probabilities of the stacked ensemble
    ``state`` (every entry (S, ...)), and ``stored`` is what the engine
    keeps in device memory.

    - fp32 keeps ``state``; bf16 casts every float entry and the input to
      bfloat16; int8 stores the weights as per-output-channel int8 and
      dequantizes them to bfloat16 inside the forward, per member.
    - The conv models pool in float32 before their linear head. The JAX
      engine feeds those float32 features to a flax Dense with bfloat16
      weights, which promotes to float32, so the head runs in float32 on
      bf16-rounded weights. The engine does the same: it upcasts the decoded
      weights of those heads to float32 and leaves the features be. The
      MLPs and LeNet stay in bfloat16 throughout, as flax promotes a
      bfloat16 input and bfloat16 weights to bfloat16.
    - ``member_strategy`` "scan" runs the members one after another and sums
      their probabilities; "vmap" runs them as one ``torch.func.vmap`` over
      the stacked state."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if member_strategy not in MEMBER_STRATEGIES:
        raise ValueError(f"member_strategy must be one of {MEMBER_STRATEGIES}, "
                         f"got {member_strategy!r}")
    dtype = torch.float32 if precision == "fp32" else torch.bfloat16
    if precision == "int8":
        stored = quantize_state(state, member_axis=True)
        decode = lambda st: dequantize_state(st, dtype)  # noqa: E731
    else:
        stored = {k: v.to(dtype) if v.is_floating_point() else v
                  for k, v in state.items()}
        decode = lambda st: st  # noqa: E731
    head = _float32_heads(module)
    n_members = next(_tensors(stored)).shape[0]
    module.eval()

    def probs_of(st, x):
        weights = decode(st)
        if dtype != torch.float32:
            weights = {k: v.to(torch.float32) if k in head else v
                       for k, v in weights.items()}
        logits = functional_call(module, weights, (x,))
        return torch.exp(torch.log_softmax(logits.to(torch.float32), dim=-1))

    @torch.no_grad()
    def fn(stored, x):
        x = x.to(dtype)
        if member_strategy == "scan":
            total = probs_of(_member(stored, 0), x)
            for i in range(1, n_members):
                total = total + probs_of(_member(stored, i), x)
            return total / n_members
        return vmap(probs_of, in_dims=(0, None))(stored, x).mean(0)

    return fn, stored


def _example_input(batch_size: int, input_shape, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(0)
    return torch.randn((batch_size,) + tuple(input_shape), generator=gen).to(device)


def _attach_cost(engine, module, state, stored, x):
    """FLOPs of one ensemble forward (S times one member's, counted by
    ``FlopCounterMode``) and ``cost_bytes``, a count of the bytes a forward
    must move at least: the stored weights in their storage dtype (int8
    values and their float32 scales for int8), the input and the output.
    Activations are not counted, so it is a lower bound (it replaces XLA's
    estimate of bytes accessed)."""
    n_members = next(iter(state.values())).shape[0]
    engine.cost_flops = float(n_members * forward_flops(module, x))
    num_classes = [m for m in module.modules() if isinstance(m, nn.Linear)][-1].out_features
    engine.cost_bytes = float(sum(t.numel() * t.element_size() for t in _tensors(stored))
                              + x.numel() * x.element_size()
                              + x.shape[0] * num_classes * 4)


def build_engine(module: nn.Module, state, batch_size: int, input_shape,
                 precision: str = "fp32", member_strategy: str = "vmap"):
    """The per-call engine: ``(engine, x)`` where ``engine(xb)`` returns the
    posterior-mean probabilities of an NCHW batch on the state's device and
    ``x`` is an example batch there. ``engine.cost_flops`` and
    ``engine.cost_bytes`` are per forward."""
    device = next(iter(state.values())).device
    module.to(device)
    fn, stored = _prep_forward(module, state, precision, member_strategy)
    x = _example_input(batch_size, input_shape, device)
    engine = lambda xb: fn(stored, xb)  # noqa: E731
    _attach_cost(engine, module, state, stored, x)
    return engine, x


class _GraphEngine:
    """One forward captured in a CUDA graph, replayed ``loop_k`` times per
    call on static input and output buffers."""

    def __init__(self, fn: Callable, stored, x: torch.Tensor, loop_k: int):
        self.fn, self.stored, self.loop_k = fn, stored, loop_k
        self.x = x.clone()
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(3):  # warm-up outside the capture, as torch asks
                fn(stored, self.x)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(stored, self.x)

    def __call__(self, xb: torch.Tensor) -> torch.Tensor:
        """``loop_k`` replays on ``xb``; returns the static output buffer."""
        self.x.copy_(xb)
        for _ in range(self.loop_k):
            self.graph.replay()
        return self.out

    def replay(self, xb: torch.Tensor) -> torch.Tensor:
        """One replay on ``xb``; returns a copy of its output."""
        self.x.copy_(xb)
        self.graph.replay()
        return self.out.clone()

    def eager(self, xb: torch.Tensor) -> torch.Tensor:
        """The same forward, run eagerly."""
        return self.fn(self.stored, xb)


def build_amortized_engine(module: nn.Module, state, batch_size: int, input_shape,
                           precision: str = "fp32", loop_k: int = 100,
                           member_strategy: str = "vmap"):
    """The device engine: ``(engine_k, x)``, where ``engine_k(xb)`` replays
    a CUDA graph of one forward ``loop_k`` times (``time_amortized`` times
    it with CUDA events and divides). ``engine_k.cost_flops`` and
    ``.cost_bytes`` are per forward. Needs the state on a CUDA device."""
    device = next(iter(state.values())).device
    if device.type != "cuda":
        raise ValueError(f"the device engine needs a CUDA device, got {device}")
    module.to(device)
    fn, stored = _prep_forward(module, state, precision, member_strategy)
    x = _example_input(batch_size, input_shape, device)
    engine_k = _GraphEngine(fn, stored, x, loop_k)
    _attach_cost(engine_k, module, state, stored, x)
    return engine_k, x


def time_engine(engine, x, num_batches: int = 20):
    """Warm-up plus per-batch timed calls; returns ``(mean, std)`` seconds
    per call over the batches after the burn-in. Each call ends with the
    device->host copy of its result, which waits for the device."""
    for _ in range(WARM_UP_ITERS):
        engine(x).cpu()
    lats = []
    for _ in range(num_batches):
        t0 = time.perf_counter()
        for _ in range(REPS_PER_BATCH):
            engine(x).cpu()
        lats.append((time.perf_counter() - t0) / REPS_PER_BATCH)
    lats = np.asarray(lats[BURN_IN_BATCHES:] if len(lats) > BURN_IN_BATCHES else lats)
    return float(lats.mean()), float(lats.std())


def time_amortized(engine_k, x, reps: int = 5):
    """Time the device engine: two warm calls, then ``reps`` calls of
    ``loop_k`` replays each between two CUDA events; returns ``(mean,
    std)`` seconds per forward."""
    for _ in range(2):
        engine_k(x)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    lats = []
    for _ in range(reps):
        start.record()
        engine_k(x)
        stop.record()
        stop.synchronize()
        lats.append(start.elapsed_time(stop) / 1e3 / engine_k.loop_k)
    lats = np.asarray(lats)
    return float(lats.mean()), float(lats.std())


def _cost_fields(flops, bytes_, latency_s, device=None) -> dict:
    """Achieved TFLOP/s, percent of the bf16 peak, and bytes/s for a
    per-forward latency. The percent-of-peak key divides by the device's
    bf16 peak for every precision (fp32 and int8 rows read as percent of the
    bf16 number), as its name says. ``hbm_*`` fields rest on the counted
    lower bound ``bytes_``. Only a CUDA device's latency gets these fields."""
    out = {}
    if not flops or not latency_s or torch.device(device).type != "cuda":
        return out
    achieved = flops / latency_s
    out["achieved_tflops"] = round(achieved / 1e12, 2)
    peak, hbm_peak = device_peaks(device)
    if peak:
        out["mfu_pct_of_bf16_peak"] = round(achieved / peak * 100, 1)
    if bytes_:
        out["hbm_bytes_accessed"] = int(bytes_)
        out["hbm_gb_per_sec"] = round(bytes_ / latency_s / 1e9, 1)
        if hbm_peak:
            out["hbm_bw_pct_of_peak"] = round(bytes_ / latency_s / hbm_peak * 100, 1)
    return out


def _resolve_spec(cfg: ProfileConfig, mcfg):
    """(input_shape as (C, H, W), num_classes). The input follows the model
    config's eval transform; 'ImageNet' is the trtprof rn50 engine setting,
    224x224 inputs and a 1000-way head."""
    if cfg.dataset == "ImageNet":
        return (3, 224, 224), 1000
    from ..data.sources import DATASET_PROFILES

    classes = DATASET_PROFILES.get(cfg.dataset, (None, None, 10))[2]
    h, w, c = mcfg.transform_test.shape
    return (c, h, w), classes


def random_ensemble(model: str, num_classes: int, ensemble_size: int, device):
    """An ensemble of ``ensemble_size`` freshly initialised members (the
    JAX package's initialisers, member i drawn from a CPU generator seeded
    with ``derive_seed(0, "member", i)``) on ``device``."""
    from .. import models
    from ..inference.ensemble import Ensemble
    from ..util import make_generator

    mcfg = models.get_model(model)
    states = []
    for i in range(ensemble_size):
        m = mcfg.build(num_classes)
        m.init_parameters(make_generator("cpu", 0, "member", i))
        states.append({k: v.detach().clone() for k, v in m.state_dict().items()})
    ens = Ensemble.from_list(mcfg.build(num_classes), states)
    ens.module.to(device)
    ens.state = {k: v.to(device) for k, v in ens.state.items()}
    return ens


def _device(device) -> torch.device:
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profiling on 'cuda' needs a CUDA device")
    return device


def _traced(fn, path: str, device: torch.device):
    """``fn()`` under ``torch.profiler`` (the CPU's activity, and the GPU's
    on a CUDA device), its Chrome trace written to ``path``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return out


def profile_config(cfg: ProfileConfig, amortize_k: int = 0, per_call: bool = True,
                   member_strategy: str = "vmap", device=None,
                   trace_dir: Optional[str] = None) -> dict:
    """Measure one engine configuration on ``device`` (default: the GPU).

    ``per_call=True`` runs the per-call protocol (every call pays the host's
    dispatch and a device->host copy); with ``trace_dir`` it runs under
    ``torch.profiler`` and the trace goes to ``<trace_dir>/<cfg.key()>.json``
    (``trace_path`` in the result). ``amortize_k=K`` also (or, with
    ``per_call=False``, only) times the device engine, K graph replays per
    timing, and records ``graph_max_abs_diff``, the largest difference
    between a replay and the eager forward on the same batch."""
    from .. import models

    device = _device(device)
    mcfg = models.get_model(cfg.model)
    input_shape, num_classes = _resolve_spec(cfg, mcfg)
    ens = random_ensemble(cfg.model, num_classes, cfg.ensemble_size, device)
    member_strategy = resolve_member_strategy(
        member_strategy, cfg.ensemble_size, cfg.batch_size, input_shape, cfg.precision,
        *member_cost(cfg.model, num_classes, input_shape))
    out = {**asdict(cfg), "device": device_name(device),
           "amortized_member_strategy": member_strategy}
    flops = bytes_ = None
    if per_call:
        engine, x = build_engine(ens.module, ens.state, cfg.batch_size, input_shape,
                                 cfg.precision, member_strategy)
        if trace_dir:
            out["trace_path"] = os.path.join(trace_dir, f"{cfg.key()}.json")
            mean, std = _traced(lambda: time_engine(engine, x), out["trace_path"], device)
        else:
            mean, std = time_engine(engine, x)
        out.update(latency_mean_s=mean, latency_std_s=std,
                   images_per_sec=cfg.batch_size / mean)
        flops, bytes_ = engine.cost_flops, engine.cost_bytes

    if amortize_k:
        engine_k, x = build_amortized_engine(
            ens.module, ens.state, cfg.batch_size, input_shape, cfg.precision,
            loop_k=amortize_k, member_strategy=member_strategy)
        diff = float((engine_k.replay(x) - engine_k.eager(x)).abs().max())
        amean, astd = time_amortized(engine_k, x)
        if flops is None:
            flops, bytes_ = engine_k.cost_flops, engine_k.cost_bytes
        out.update(
            amortized_latency_s=amean, amortized_latency_std_s=astd,
            amortized_loop_k=engine_k.loop_k,
            amortized_images_per_sec=cfg.batch_size / amean,
            graph_max_abs_diff=diff,
            **_cost_fields(flops, bytes_, amean, device),
        )
    elif per_call:
        out.update(**_cost_fields(flops, bytes_, out["latency_mean_s"], device))
    return out


def profile_prediction(cfg: ProfileConfig, splits, num_classes: int,
                       sampler=None, device=None) -> dict:
    """Metrics and latency together, as trtprof's run_prediction.py does:
    the Prediction task in latency mode over a test split with a sampled
    (or freshly initialised, ``random_ensemble``) ensemble, the per-batch
    latencies aggregated after the 10-batch burn-in. ``num_batches`` is the
    number of timed batches."""
    from .. import tasks

    device = _device(device)
    if sampler is not None:
        ensemble = sampler.sample(num_samples=cfg.ensemble_size)
    else:
        ensemble = random_ensemble(cfg.model, num_classes, cfg.ensemble_size, device)
    task = tasks.Prediction({"in_distribution_test": splits["test"]}, num_classes,
                            metric_list="ALL", latency_mode=True)
    task.update_statistics(ensemble, output_performance=False)
    metrics = task.get_performance_metrics()
    lats = np.asarray(task.latencies[BURN_IN_BATCHES:]
                      if len(task.latencies) > BURN_IN_BATCHES else task.latencies)
    return {
        **asdict(cfg),
        "latency_mean_s": float(lats.mean()),
        "latency_std_s": float(lats.std()),
        "num_batches": len(task.latencies),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "device": device_name(ensemble.device),
    }


def run_sweep(configs, cache_path: str, amortize_k: int = 0, per_call: bool = True,
              member_strategy: str = "vmap", trace_dir: Optional[str] = None) -> dict:
    """JSON-cached sweep with resume. A cached entry is measured again only
    for the mode it lacks, or when ``amortize_k`` exceeds the cached one."""
    cache = {}
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            cache = json.load(f)
    for cfg in configs:
        prev = cache.get(cfg.key(), {})
        need_call = per_call and "latency_mean_s" not in prev
        need_amort = amortize_k and (
            "amortized_latency_s" not in prev
            or prev.get("amortized_loop_k", 0) < amortize_k)
        if not (need_call or need_amort):
            print("cached:", cfg.key())
            continue
        print("profiling:", cfg.key(),
              f"(per_call={need_call}, amortize_k={amortize_k if need_amort else 0})")
        res = profile_config(cfg, amortize_k=amortize_k if need_amort else 0,
                             per_call=need_call, member_strategy=member_strategy,
                             trace_dir=trace_dir)
        if not need_amort and "amortized_latency_s" in prev:
            # the cost fields of a cached device-engine run stay: they rest on
            # the device time, not on the per-call time
            for k in ("achieved_tflops", "mfu_pct_of_bf16_peak", "hbm_bytes_accessed",
                      "hbm_gb_per_sec", "hbm_bw_pct_of_peak"):
                res.pop(k, None)
        cache[cfg.key()] = {**prev, **res}
        with open(cache_path, "w") as f:
            json.dump(cache, f, indent=1)
    return cache


def main(argv: Optional[list] = None) -> dict:
    p = argparse.ArgumentParser(description="ensemble latency sweep on the GPU")
    p.add_argument("--models", nargs="*", default=["PreResNet20"])
    p.add_argument("--dataset", type=str, default="CIFAR10")
    p.add_argument("--precisions", nargs="*", default=["fp32", "bf16"],
                   choices=PRECISIONS)
    p.add_argument("--ensemble_sizes", nargs="*", type=int, default=[1, 6])
    p.add_argument("--batch_sizes", nargs="*", type=int, default=[1, 128])
    p.add_argument("--cache", type=str, default="latency_cache.json")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler trace of each per-call timing here")
    p.add_argument("--amortize_k", type=int, default=0,
                   help="also time the device engine, K CUDA-graph replays")
    p.add_argument("--no_per_call", action="store_true",
                   help="skip the per-call protocol timing")
    p.add_argument("--member_strategy", choices=["vmap", "scan", "auto"],
                   default="auto",
                   help="ensemble members batched (vmap) or one after another (scan); "
                        "auto: the faster one as measured on an H100")
    p.add_argument("--table", action="store_true", help="print the LaTeX table")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("ursabench_tpu_torch.profiling.latency needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    configs = [ProfileConfig(m, args.dataset, prec, s, b)
               for m in args.models for prec in args.precisions
               for s in args.ensemble_sizes for b in args.batch_sizes]
    cache = run_sweep(configs, args.cache, amortize_k=args.amortize_k,
                      per_call=not args.no_per_call,
                      member_strategy=args.member_strategy, trace_dir=args.trace_dir)
    if args.table:
        from .tables import make_latex_table

        print(make_latex_table(cache))
    return cache


if __name__ == "__main__":
    main()
