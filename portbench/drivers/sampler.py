"""The ``sampler`` traffic kind: SG-MCMC chains over a resident train split,
one epoch after another through the sampler's own epoch call
(``_run_epoch``: the epoch program, one captured step replayed a batch at
a time, each step ending in the update kernel).

Set-up makes the train split (uint8 images and labels from the seed), builds
the model in the configuration's precision and the sampler with the mix's
hyperparameters, puts weights made from the seed in place of its own, and
runs its first epoch, which warms up and captures the step. During that
epoch it keeps the state the check reads: the first gradient as the update
gets it (the gradient buffer after step 1) and the parameters after steps
``check_changes`` (chain 0's). The window runs whole epochs until
``--seconds`` have passed, then waits for the card: it ends on an epoch
boundary, up to one epoch and the work queued ahead of the card past
``--seconds``.

The check follows chain 0's first steps in the reference from the same
weights and the same draws: each step's loss, the first gradient by leaf,
and the change of the parameters by leaf after each step of
``check_changes``.

What depends on the data sits behind four methods: ``train_data`` (the host
inputs and labels from the seed), ``served_split`` (the program's split of
them), ``draws`` (the reference's draws of a chain's first epoch) and
``data_count`` (the N that SGHMC's prior and noise divide by), here an
image classifier's. SG-MCMC over other data is a kind of its own: a driver
file whose ``Driver`` subclasses this one and overrides them.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from portbench import core, inputs
from portbench.reference.layers import Precision, parameter_leaves
from portbench.reference.models import Model
from portbench.reference.sghmc import first_epoch_draws, sghmc_steps


def leaf_gaps(program: dict, reference: dict, names) -> list:
    """Each leaf's gap between its norm in ``program`` and in ``reference``,
    over the larger of that leaf's reference norm and the median leaf's."""
    ref = {k: float(reference[k].double().norm()) for k in names}
    median = statistics.median(ref.values())
    return [abs(float(program[k].double().norm()) - ref[k]) / max(ref[k], median)
            for k in names]


def gaps(model: Model, program: dict, reference: dict) -> dict:
    """The checked numbers of a sampler cell from the program's record of its
    first steps and the reference's (``sghmc_steps``'s): the widest relative
    gap of a step's loss; of the first gradient's and of each change's leaf
    norms the worst leaf's gap (``_gap``) and the median leaf's
    (``_gap_median``). A workload compares those it gives a limit."""
    names = [leaf.name for leaf in parameter_leaves(model.leaves)]
    g_ref = reference["grads"]
    median = statistics.median(float(g_ref[k].double().norm()) for k in names)
    # leaves whose gradient is nought to rounding in the reference move by
    # round-off and weight decay alone: left out of every comparison
    kept = [k for k in names if float(g_ref[k].double().norm()) >= 1e-3 * median]
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in
                           zip(program["losses"], reference["losses"]))}
    pairs = {"grad": (program["grads"], g_ref)}
    start = program["start"]
    for k, params in program["params"].items():
        pairs[f"change{k}"] = (
            {n: params[n].to(g_ref[n].device) - start[n].to(g_ref[n].device) for n in kept},
            {n: reference["params"][k - 1][n] - start[n].to(g_ref[n].device) for n in kept})
    for name, (prog, ref) in pairs.items():
        per_leaf = leaf_gaps(prog, ref, kept)
        out[f"{name}_gap"] = max(per_leaf)
        out[f"{name}_gap_median"] = statistics.median(per_leaf)
    return out


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg, self.tr = cell.config, cell.traffic
        self.model = cell.model()
        self.changes = [int(k) for k in self.tr["check_changes"]]
        self.steps = max(self.changes + [int(self.tr["check_losses"])])

    # -- set-up ------------------------------------------------------------------

    def setup(self, marks: list) -> None:
        """Set-up; appends ``(phase, time it ended)`` to ``marks``."""
        from ursabench_tpu_torch import inference

        cfg, tr, dev, seed = self.cfg, self.tr, self.cell.device, self.cell.seed
        self.train_inputs, self.train_labels = self.train_data()
        marks.append(("inputs", time.perf_counter()))
        split = self.served_split(self.train_inputs, self.train_labels)
        module = core.served_model(cfg)
        method = getattr(inference, tr["method"])
        self.sampler = method(dict(tr["hyperparameters"]), model=module, train=split, seed=seed,
                              chains=int(tr["chains"]), device=dev)
        leaves = parameter_leaves(self.model.leaves)
        served = [(n, tuple(p.shape)) for n, p in self.sampler.module.named_parameters()]
        if served != [(leaf.name, leaf.shape) for leaf in leaves]:
            raise RuntimeError("the served model's parameters are not the reference's, in "
                               "name, shape or order")
        start = [inputs.weights(leaves, seed, f"chain{c}", dev)
                 for c in range(len(self.sampler.modules))]
        with torch.no_grad():
            for m, w in zip(self.sampler.modules, start):
                for n, p in m.named_parameters():
                    p.copy_(w[n][0])
        self.start = {n: v[0].to("cpu", copy=True) for n, v in start[0].items()}
        del start
        marks.append(("sampler built", time.perf_counter()))
        self._first_epoch()
        marks.append(("first epoch", time.perf_counter()))
        self.batches = self.sampler.train.num_batches
        self.chains = len(self.sampler.modules)

    def _first_epoch(self) -> None:
        """The first epoch through the sampler's epoch call, keeping chain 0's
        gradient after step 1, its parameters after each step of
        ``check_changes`` and the first steps' losses."""
        program = self.sampler.epoch_program()
        names = [(leaf.name, leaf.numel, leaf.shape)
                 for leaf in parameter_leaves(self.model.leaves)]

        def leaves(flat: torch.Tensor) -> dict:
            out, offset = {}, 0
            for n, k, shape in names:
                out[n] = flat[offset: offset + k].view(shape).to("cpu", copy=True)
                offset += k
            return out

        record = {"params": {}}
        run = program._run

        def run_and_record(i: int) -> None:
            run(i)
            if i == 0:  # the state is (chains, P)
                record["grads"] = leaves(program.state.grads[0])
            if i + 1 in self.changes:
                record["params"][i + 1] = leaves(program.state.params[0])

        program._run = run_and_record
        try:
            self.sampler._run_epoch()
        finally:
            del program._run
        record["losses"] = [float(v) for v in
                            program.losses[: self.steps, 0].double().cpu()]
        record["start"] = self.start
        self.record = record

    # -- the window ----------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        cuda = self.cell.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        first = len(self.sampler.epoch_losses)
        t0 = time.perf_counter()
        epochs = 0
        while True:
            self.sampler._run_epoch()
            epochs += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        losses = torch.stack([loss.reshape(-1) for loss in self.sampler.epoch_losses[first:]])
        bad_epochs = int((~torch.isfinite(losses)).any(dim=1).sum())
        steps = epochs * self.batches
        batch = int(self.tr["batch_size"])
        return {"seconds": elapsed, "epochs": epochs, "steps": steps,
                "images": steps * batch * self.chains, "chains": self.chains,
                "attempted": steps, "failed": bad_epochs * self.batches,
                "batch": batch}

    def trace_slice(self) -> None:
        self.sampler._run_epoch()

    # -- the check -------------------------------------------------------------------

    def release(self) -> None:
        del self.sampler
        gc.collect()

    def check(self) -> dict:
        return gaps(self.model, self.record, self.reference())

    def calibrate(self, control: str) -> dict:
        """After set-up: ``release``, then the checked numbers of the program
        (its first steps, kept by set-up), of the reference in the
        ``control`` precision and of the reference with half of each batch
        left out, each against the reference."""
        self.release()
        exact = self.reference()
        return {"program": gaps(self.model, self.record, exact),
                "control": gaps(self.model, self.record_of(self.reference(Precision(control))),
                                exact),
                "half_batch": gaps(self.model, self.record_of(self.reference(half_batch=True)),
                                   exact)}

    def record_of(self, reference: dict) -> dict:
        """The reference's steps in the form of the program's record: what a
        control or a fault put in the program's place is judged by."""
        return {"losses": reference["losses"], "grads": reference["grads"],
                "params": {k: reference["params"][k - 1] for k in self.changes},
                "start": self.start}

    def reference(self, precision: Precision = Precision(), half_batch: bool = False) -> dict:
        dev = self.cell.device
        data = torch.from_numpy(self.train_inputs).to(dev)
        labels = torch.from_numpy(self.train_labels).to(dev)
        draws = self.draws(data.shape[0], dev)
        start = {k: v.to(dev) for k, v in self.start.items()}
        for leaf in self.model.leaves:
            if leaf.buffer:
                start[leaf.name] = torch.full(leaf.shape, 1.0 if leaf.init == "ones" else 0.0,
                                              device=dev)
        return sghmc_steps(self.model, start, data, labels, draws, self.tr["hyperparameters"],
                           self.data_count(), self.steps, precision, half_batch)

    # -- the data: what a kind over other data overrides ---------------------------

    def train_data(self) -> tuple:
        """The train split's inputs and labels on the host, made from the seed:
        uint8 NHWC images and their labels (numpy)."""
        cfg = self.cfg
        x, y = inputs.images(self.cell.seed, "train", int(cfg["n_train"]), cfg["image"],
                             int(cfg["num_classes"]), self.cell.device)
        return x.cpu().numpy(), y.cpu().numpy()

    def served_split(self, data, labels):
        """The program's train split of the host ``data`` and ``labels``:
        shuffled batches, normalized, cropped and flipped in the step."""
        from ursabench_tpu_torch.data.arrays import DataSplit

        return DataSplit(data, labels, int(self.tr["batch_size"]),
                         core.image_spec(self.cfg, augment=True), shuffle=True)

    def draws(self, n: int, device) -> dict:
        """The reference's draws of a chain's first epoch over ``n`` rows
        (``first_epoch_draws``), with the configuration's crop and flip."""
        return first_epoch_draws(self.cell.seed, n, int(self.tr["batch_size"]),
                                 int(self.cfg["crop_pad"]), bool(self.cfg["flip"]), device)

    def data_count(self) -> int:
        """The N that SGHMC's prior and noise divide by: the rows of the
        train split."""
        return int(self.train_inputs.shape[0])
