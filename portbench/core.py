"""What every run shares: finding a cell's files by name, the look for the
card, the check that nothing of JAX is loaded, the comparison of each
checked number with its limit, and the result line.

Everything that belongs to one cell, configuration, traffic mix, traffic
kind or metric sits in a file of its own under a root directory, found by
name: ``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<kind>.py``, ``metrics/<metric>.py``
and ``reference/<architecture>.py`` (a configuration's ``"reference"``).
A ``Registry`` looks in its roots in order (the package's own directory
last), so a cell, a configuration, a mix, a kind, a metric or a reference
architecture is added by adding files. The CPU twins' root
(``tests/tiny/``) holds each kind's faults, ``faults/<kind>.py``, too.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

PACKAGE = Path(__file__).resolve().parent
CHECKOUT = PACKAGE.parent
# top-level module names no run may hold once its window has closed
BANNED = ("jax", "jaxlib", "flax", "ursabench_tpu")


def banned_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is banned: ``ursabench_tpu_torch`` is not
    ``ursabench_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


class Registry:
    def __init__(self, roots: Sequence[Path] = (), benchmark: Optional[Path] = None):
        self.roots = [Path(r) for r in roots] + [PACKAGE]
        self.benchmark_path = Path(benchmark) if benchmark else CHECKOUT / "BENCHMARK.json"
        self._modules: Dict[Path, ModuleType] = {}

    def path(self, kind: str, name: str, suffix: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under {[str(r) for r in self.roots]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        path = self.path(kind, name, ".py")
        if path not in self._modules:
            spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def model(self, cfg: dict):
        """The reference model of configuration ``cfg``: the ``Architecture``
        of the module ``reference/<cfg["reference"]>.py``."""
        return self.module("reference", cfg["reference"]).Architecture(cfg)

    def benchmark(self) -> dict:
        return json.loads(self.benchmark_path.read_text())

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
        ones, else the end-to-end ones, as ``BENCHMARK.json`` lists them (a
        metric without ``workloads`` in every cell that reports its
        ``moves``, or in every cell)."""
        bench = self.benchmark()
        ends = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return ends
        moved = {m["name"] for m in ends}
        return [m for m in bench["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


@dataclass
class Cell:
    """One cell's files, and the run's seed and device."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: object
    registry: Registry

    @classmethod
    def load(cls, registry: Registry, name: str, seed: int, device) -> "Cell":
        workload = registry.json("workloads", name)
        return cls(name, workload, registry.json("configs", workload["config"]),
                   registry.json("traffic", workload["traffic"]), int(seed), device, registry)

    def driver(self):
        return self.registry.module("drivers", self.traffic["kind"]).Driver(self)

    def model(self):
        """The reference model of the cell's configuration."""
        return self.registry.model(self.config)


def image_spec(cfg: dict, augment: bool):
    """The program's ``ImageSpec`` of configuration ``cfg``: its normalization,
    and with ``augment`` its crop and flip."""
    from ursabench_tpu_torch.data.transforms import ImageSpec

    crop, flip = (int(cfg["crop_pad"]), bool(cfg["flip"])) if augment else (0, False)
    return ImageSpec(int(cfg["image"][0]), int(cfg["image"][2]), tuple(cfg["mean"]),
                     tuple(cfg["std"]), crop, flip)


def served_model(cfg: dict):
    """The program's model of configuration ``cfg``, computing in its
    precision (bf16: flax's compute dtype, float32 parameters)."""
    import torch
    from ursabench_tpu_torch import models

    dtype = {"fp32": None, "bf16": torch.bfloat16}[cfg["precision"]]
    return models.get_model(cfg["model"]).build(int(cfg["num_classes"]), dtype=dtype,
                                                **cfg.get("model_kwargs", {}))


@dataclass
class Run:
    """What a run's metric readers read: the cell, the set-up's seconds, the
    window's record, the trace (a traced run's) and the card's peaks."""

    cell: Cell
    setup_s: float
    window: dict
    peaks: dict
    trace: Optional[object] = None


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the workload gives a limit, beside it; a number passes at
    or under its limit (a missing or non-finite number fails)."""
    out = {}
    for name, limit in limits.items():
        value = values.get(name)
        ok = value is not None and value == value and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: Optional[dict] = None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    return json.dumps(line)
