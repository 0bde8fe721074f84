"""One run of one benchmark cell of ``ursabench_tpu_torch`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: set-up (the cell's inputs and weights made on the device from
``--seed``, the program built and every shape the cell uses warmed up,
its first steps recorded for the check), then the measured window of
``--seconds``, then (``--trace 1``) a stretch of the same work under
``torch.profiler``, then the check: the program's state freed, the
reference run on the same inputs, and each checked number compared with
its limit. The last line on standard output is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number beside its
limit, which also end standard error.

The run exits with a code other than 0 and prints no result when CUDA or
the cell's cards are missing, when the card has no peaks in
``peaks.PEAKS``, or when JAX, flax or the JAX package is loaded once the
window, the metric readers and the check have run.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # before torch is imported: set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_CACHE = Path(__file__).resolve().parent / ".cache"
# the program's and the libraries' kernel caches, at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(_CACHE / _sub)
if __name__ == "__main__":
    # a run's compiled bytecode of every module imported from here on
    # (torch's too) there as well: an interpreter that writes none
    # (PYTHONDONTWRITEBYTECODE) compiles torch from source in every run,
    # 5-6 s that swing by seconds
    sys.pycache_prefix = str(_CACHE / "pyc")
    sys.dont_write_bytecode = False

import torch  # noqa: E402

IMPORTED = time.perf_counter()

from . import core, peaks  # noqa: E402
from .trace import traced  # noqa: E402


class Refused(RuntimeError):
    """The run cannot give a result (no card, an unknown card, JAX loaded)."""


def _device_check(chips: int) -> str:
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
    card = torch.cuda.get_device_name(0)
    peaks.peaks(card)  # raises for a card not in the table
    return card


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             registry: core.Registry = None, device=None, started: float = STARTED) -> dict:
    """One run; returns the result line's fields and the checks. With
    ``device`` given, the look for the card is skipped (a test's run on the
    CPU), and the peaks are the first card's of the table."""
    registry = registry or core.Registry()
    workload = registry.json("workloads", name)
    if device is None:
        card = _device_check(int(workload["chips"]))
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.cuda.init()
    else:
        device, card = torch.device(device), next(iter(peaks.PEAKS))
    cell = core.Cell.load(registry, name, seed, device)
    # the configuration's precision: float32 matrix products and convolutions
    # in TF32 only where it says so
    tf32 = bool(cell.config.get("allow_tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    driver = cell.driver()
    marks = [("torch imported", IMPORTED), ("card ready", time.perf_counter())]
    driver.setup(marks)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    # where set-up went, on standard error: each phase's seconds
    stamps = [("start", started)] + marks + [("the rest", started + setup_s)]
    print("set-up: " + ", ".join(f"{n} {t - t0:.3f} s" for (_, t0), (n, t)
                                 in zip(stamps, stamps[1:])), file=sys.stderr)
    window = driver.window(float(seconds))
    tr = traced(driver.trace_slice) if trace else None
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = core.Run(cell, setup_s, window, peaks.peaks(card), tr)
    metrics = {}
    for m in registry.metrics(name, trace):
        value = registry.module("metrics", m["name"]).read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = core.judge(driver.check(), workload["limits"])
    # last, once the metric readers and the check have run too
    banned = core.banned_modules()
    if banned:
        raise Refused(f"modules of JAX or the JAX package are loaded: {banned}")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card,
           "count": int(workload["chips"]), "memory_peak_bytes": int(memory)}
    breakdown = None
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    return {"correct": all(c["ok"] for c in checks.values()) and window["failed"] == 0,
            "attempted": window["attempted"], "failed": window["failed"], "metrics": metrics,
            "device": dev, "breakdown": breakdown, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except Refused as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}"
              f"{'' if c['ok'] else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(core.result_line(**out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
