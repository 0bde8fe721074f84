"""The ``bma_requests`` traffic kind: one client in a closed loop, sending
BMA requests one after another (the next is issued once the last one's
logits are on the host), each the next ``batch_size`` test images (cycling
through the test set, wrapping at its end), answered by the ensemble's
eager forward of every member (``Ensemble.logits_all``) and the copy of its
logits to the host, as the prediction task's latency mode serves a batch.

Set-up makes the test images and the members from the seed, normalizes each
request's batch on the device (NCHW, as the latency mode hands it over
before its clock starts) and serves ``warmup`` requests. A request's
latency runs from its issue to its logits on the host; its enqueue time to
the return of ``logits_all``, before the copy waits on the card. The window
sends requests until ``--seconds`` have passed. A sample of the batches,
drawn from the seed, keeps every answer it got for the check, which
compares each with the reference's logits of that batch.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from portbench import core
from portbench.reference import bma
from portbench.reference.layers import Precision
from portbench.drivers.bma_pass import ensemble, test_split


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.model = cell.model()
        self.batch = int(cell.traffic["batch_size"])

    def setup(self, marks: list) -> None:
        """Set-up; appends ``(phase, time it ended)`` to ``marks``."""
        from ursabench_tpu_torch.data.transforms import normalize

        cfg, tr = self.cell.config, self.cell.traffic
        x, _, self.members = test_split(self.cell, self.model)
        spec = core.image_spec(cfg, augment=False)
        n = x.shape[0]
        self.rows = [torch.arange(j * self.batch, (j + 1) * self.batch, device=x.device) % n
                     for j in range(-(-n // self.batch))]
        self.requests = [normalize(x.index_select(0, r), spec).permute(0, 3, 1, 2).contiguous()
                         for r in self.rows]
        self.images = x.cpu()
        del x
        rng = random.Random(self.cell.seed)
        self.checked = set(rng.sample(range(len(self.requests)),
                                      min(int(tr["checked_batches"]), len(self.requests))))
        self.ensemble = ensemble(self.cell, self.members)
        self.members = {k: v.cpu() for k, v in self.members.items()}
        marks.append(("inputs and ensemble", time.perf_counter()))
        self.sent = 0
        self.kept = {j: [] for j in self.checked}
        for _ in range(int(tr["warmup"])):
            self._request()
        marks.append(("warm-up requests", time.perf_counter()))
        self.kept = {j: [] for j in self.checked}

    def _request(self):
        """One request: (latency s, enqueue s); the answers of the checked
        batches are kept."""
        j = self.sent % len(self.requests)
        self.sent += 1
        t0 = time.perf_counter()
        logits = self.ensemble.logits_all(self.requests[j])
        t1 = time.perf_counter()
        host = logits.cpu()
        t2 = time.perf_counter()
        if j in self.kept:
            self.kept[j].append(host)
        return t2 - t0, t1 - t0

    def window(self, seconds: float) -> dict:
        """Requests until ``seconds`` have passed. A request that raises ends
        the run; one that answers wrong is the check's to find."""
        lat, enq = [], []
        t0 = time.perf_counter()
        while True:
            latency, enqueue = self._request()
            lat.append(latency)
            enq.append(enqueue)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "requests": len(lat), "latencies": lat, "enqueue": enq,
                "images": len(lat) * self.batch, "attempted": len(lat), "failed": 0,
                "batch": self.batch, "members": int(self.cell.traffic["members"]),
                "forward_images": len(lat) * self.batch * int(self.cell.traffic["members"])}

    def trace_slice(self) -> None:
        for _ in range(int(self.cell.traffic["traced_requests"])):
            self._request()

    def release(self) -> None:
        del self.ensemble, self.requests
        gc.collect()

    def reference(self, precision: Precision = Precision()) -> dict:
        cfg, dev = self.cell.config, self.cell.device
        members = {k: v.to(dev) for k, v in self.members.items()}
        out = {}
        for j in sorted(self.checked):
            x = bma.normalize(self.images[self.rows[j].cpu()].to(dev), cfg["mean"], cfg["std"])
            out[j] = bma.logits(self.model, members, x, precision).cpu()
        return out

    def check(self) -> dict:
        return gaps(self.kept, self.reference())

    def calibrate(self, control: str) -> dict:
        """After set-up: one request for each batch, ``release``, then the
        checked numbers of the program and of the reference in the
        ``control`` precision, each against the reference."""
        for _ in range(len(self.requests)):
            self._request()
        self.release()
        exact = self.reference()
        return {"program": gaps(self.kept, exact),
                "control": gaps({j: [v] for j, v in self.reference(Precision(control)).items()},
                                exact)}


def gaps(kept: dict, reference: dict) -> dict:
    """The widest gap of an answer's logits from the reference's, over the
    root mean square of the reference's logits of that batch; a checked batch
    that got no answer in the window counts as missing nothing."""
    worst = 0.0
    for j, answers in kept.items():
        ref = reference[j].double()
        rms = float(ref.pow(2).mean().sqrt())
        for a in answers:
            gap = float((a.double() - ref).abs().max()) / rms
            worst = max(worst, gap) if np.isfinite(gap) else float("inf")
    return {"logit_gap": worst}
