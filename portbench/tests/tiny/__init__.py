"""The CPU twins of the benchmark's cells: each cell's run at a tiny size,
as files in this directory, which is a root of the harness's registry.

A cell's twin is ``workloads/tiny.<cell>.json``: a tiny configuration under
``configs/`` (the cell's architecture, cut to run in seconds on the CPU), a
tiny mix under ``traffic/`` of the cell's traffic kind, and the limits of
the run on the CPU. A cell added to ``BENCHMARK.json`` brings its twin as
files; a test fails for a cell that has none. The faults a cell of a kind
can have are ``faults/<kind>.py`` (``FAULTS``); a test fails for a twinned
kind that has none.

A traffic kind is added as files too: its driver, ``drivers/<kind>.py``
(for SG-MCMC over other data than images, a ``Driver`` that subclasses the
``sampler`` kind's and overrides its data methods), its faults,
``faults/<kind>.py``, and a twin of a cell of that kind here.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from portbench import core

ROOT = Path(__file__).resolve().parent


def tiny_name(cell: str) -> str:
    return f"tiny.{cell}"


def twin(cell: str) -> Optional[dict]:
    """The twin's workload of benchmark cell ``cell``, or None where it has none."""
    path = ROOT / "workloads" / f"{tiny_name(cell)}.json"
    return json.loads(path.read_text()) if path.is_file() else None


def kind(cell: str) -> str:
    """The traffic kind of ``cell``'s twin."""
    return json.loads((ROOT / "traffic" / f"{twin(cell)['traffic']}.json").read_text())["kind"]


def kind_faults(kind: str, registry: Optional[core.Registry] = None) -> dict:
    """The faults of traffic kind ``kind``: ``FAULTS`` of ``faults/<kind>.py``
    under the registry's roots (by default this directory's and the
    package's), or none where the kind has no such file."""
    registry = registry or core.Registry([ROOT])
    try:
        registry.path("faults", kind, ".py")
    except FileNotFoundError:
        return {}
    return registry.module("faults", kind).FAULTS


def write_root(root: Path) -> core.Registry:
    """A ``BENCHMARK.json`` of the twins under ``root`` (the benchmark's
    metrics, each listing the twins of its cells), and a registry that finds
    it, the twins' files and the package's own drivers, metrics and
    reference architectures."""
    bench = json.loads((core.CHECKOUT / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"] if twin(w["name"]) is not None]
    bench["workloads"] = []
    for cell in cells:
        w = twin(cell)
        bench["workloads"].append({"name": tiny_name(cell),
                                   **{k: w[k] for k in ("config", "traffic", "chips", "why")}})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_name(c) for c in m["workloads"] if c in cells]
    path = Path(root) / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return core.Registry([ROOT], path)
