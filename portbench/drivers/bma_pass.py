"""The ``bma_pass`` traffic kind: the BMA pass of an ensemble over the test
split (``tasks.base.accumulate_split``: the ensemble's pass program, one
captured step replayed a batch at a time), repeated.

Set-up makes the test split and ``members`` members from the seed, builds
the ensemble with the mix's ``member_strategy``, and runs the pass twice:
the first builds, warms up and captures its step, the second replays it.
The window runs whole passes until ``--seconds`` have passed; each pass
ends with its sums on the host. The check compares every pass's averaged
probabilities and entropies, row by row, with the reference's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import core, inputs
from portbench.reference import bma
from portbench.reference.layers import Precision
from portbench.reference.models import Model


def test_split(cell, model: Model):
    """The test images and labels from the seed, and the members."""
    cfg, tr = cell.config, cell.traffic
    x, y = inputs.images(cell.seed, "test", int(cfg["n_test"]), cfg["image"],
                         int(cfg["num_classes"]), cell.device)
    members = inputs.weights(model.leaves, cell.seed, "members", cell.device,
                             count=int(tr["members"]), jitter=float(tr["member_jitter"]))
    return x, y, members


def ensemble(cell, members: dict):
    """The program's ensemble of ``members`` in the configuration's precision."""
    from ursabench_tpu_torch.inference.ensemble import Ensemble

    cfg, tr = cell.config, cell.traffic
    module = core.served_model(cfg).to(cell.device)
    served = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    if served != {k: tuple(v.shape[1:]) for k, v in members.items()}:
        raise RuntimeError("the served model's state is not the reference's, in names or shapes")
    return Ensemble(module, dict(members), int(tr["members"]),
                    member_strategy=tr["member_strategy"])


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.model = cell.model()

    def setup(self, marks: list) -> None:
        """Set-up; appends ``(phase, time it ended)`` to ``marks``."""
        from ursabench_tpu_torch.data.arrays import DataSplit
        from ursabench_tpu_torch.tasks.base import accumulate_split

        cfg, tr = self.cell.config, self.cell.traffic
        x, y, self.members = test_split(self.cell, self.model)
        self.images = x.cpu().numpy()
        self.split = DataSplit(self.images, y.cpu().numpy(), int(tr["batch_size"]),
                               core.image_spec(cfg, augment=False))
        del x, y
        self.ensemble = ensemble(self.cell, self.members)
        marks.append(("inputs and ensemble", time.perf_counter()))
        self.accumulate = accumulate_split
        for _ in range(2):
            accumulate_split(self.ensemble, self.split, smooth_probs=False)
        marks.append(("two passes", time.perf_counter()))
        self.members = {k: v.cpu() for k, v in self.members.items()}

    def _pass(self):
        return self.accumulate(self.ensemble, self.split, smooth_probs=False)

    def window(self, seconds: float) -> dict:
        self.outputs = []
        t0 = time.perf_counter()
        while True:
            self.outputs.append(self._pass())  # ends with the sums on the host
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        failed = sum(int(not (np.isfinite(p).all() and np.isfinite(e).all()))
                     for p, e in self.outputs)
        n = self.split.n
        return {"seconds": elapsed, "passes": len(self.outputs),
                "images": len(self.outputs) * n, "attempted": len(self.outputs),
                "failed": failed, "batch": self.split.batch_size,
                "members": int(self.cell.traffic["members"]),
                "forward_images": len(self.outputs) * n * int(self.cell.traffic["members"])}

    def trace_slice(self) -> None:
        self._pass()

    def release(self) -> None:
        del self.ensemble, self.accumulate
        gc.collect()

    def reference(self, precision: Precision = Precision()):
        cfg, dev = self.cell.config, self.cell.device
        members = {k: v.to(dev) for k, v in self.members.items()}
        images = torch.from_numpy(self.images).to(dev)
        p, e = bma.split_sums(self.model, members, images, cfg["mean"], cfg["std"],
                              int(self.cell.traffic["batch_size"]), precision)
        return p.cpu().numpy(), e.cpu().numpy()

    def check(self) -> dict:
        return gaps(self.outputs, self.reference(), int(self.cell.traffic["members"]))

    def calibrate(self, control: str) -> dict:
        """After set-up: one pass, ``release``, then the checked numbers of
        the program and of the reference in the ``control`` precision, each
        against the reference."""
        self.outputs = [self._pass()]
        self.release()
        exact, members = self.reference(), int(self.cell.traffic["members"])
        return {"program": gaps(self.outputs, exact, members),
                "control": gaps([self.reference(Precision(control))], exact, members)}


def gaps(outputs, reference, members: int) -> dict:
    """The widest gap, over every pass and row, of the averaged probabilities
    and of the averaged entropies from the reference's."""
    p_ref, e_ref = reference

    def widest(gap: np.ndarray) -> float:
        return float(gap.max()) if np.isfinite(gap).all() else float("inf")

    prob = max(widest(np.abs(p - p_ref) / members) for p, _ in outputs)
    ent = max(widest(np.abs(e - e_ref) / members) for _, e in outputs)
    return {"prob_gap": prob, "entropy_gap": ent}
