"""The learning-rate schedules of ursabench_tpu_torch's samplers against
torch's schedulers and the JAX package's traced schedules, in float32:
cosine annealing (SGHMC, SGD), cSGHMC's cyclic cosine with its float batch
count, the one-cycle schedule (MCdropout) and SWA's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu.inference import sgd_map as jsgd
from ursabench_tpu.inference import sgmcmc as jsgmcmc
from ursabench_tpu.inference import swa as jswa
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.inference import sgd_map, sgmcmc, swa

torch.set_num_threads(1)

LOADER = dict(batch_size=32, use_validation=False, synthetic_n_train=100,
              synthetic_n_test=16)


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _splits():
    return (jdata.loaders("MNIST", None, **LOADER)[0],) + tdata.loaders("MNIST", None, **LOADER)


def _hyps(values):
    return ({k: jnp.float32(v) for k, v in values.items()},
            {k: torch.tensor(v, dtype=torch.float32) for k, v in values.items()})


def test_sgd_cosine_matches_torch_scheduler():
    """SGD's schedule: CosineAnnealingLR over epochs + 1 epochs, eta_min
    0.01 * lr, read from the sampler's own device tensors."""
    _, ts_, c = _splits()
    ts = sgd_map.SGD({"lr": 0.1, "epochs": 9, "momentum": 0.9, "weight_decay": 5e-4},
                     model=tmodels.get_model("MLP200MNIST").build(c), train=ts_["train"],
                     device="cpu")
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=10, eta_min=0.001)
    for epoch in range(11):
        got = float(sgmcmc._cosine_hyp_lr(ts._hyp, epoch, 0, 0))
        assert got == pytest.approx(opt.param_groups[0]["lr"], rel=1e-5), epoch
        opt.step()
        sched.step()


def test_cyclic_lr_matches_jax_in_float32():
    """The samplers' own hyperparameters (float batch count 100/32 + 1),
    then every batch of three cycles: equal to float32 rounding."""
    hyp = {"lr_0": 0.05, "prior_std": 1.0, "num_samples_per_cycle": 2, "cycle_length": 4,
           "burn_in_epochs": 1, "num_cycles": 3, "alpha": 0.1}
    splits, c = jdata.loaders("MNIST", None, **LOADER)
    js = jsgmcmc.cSGHMC(hyp, model=jmodels.get_model("MLP200MNIST").build(c),
                        train=splits["train"])
    tsplits, _ = tdata.loaders("MNIST", None, **LOADER)
    ts = sgmcmc.cSGHMC(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                       train=tsplits["train"], device="cpu")
    for k, v in js._hyp_scalars.items():
        assert float(ts._hyp[k]) == float(v), k
    got, want = [], []
    for epoch in range(12):
        for bi in range(4):
            got.append(float(sgmcmc._cyclic_hyp_lr(ts._hyp, epoch, bi, 0)))
            want.append(float(jsgmcmc._cyclic_hyp_lr(js._hyp_scalars, jnp.float32(epoch),
                                                     jnp.int32(bi), 0)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-9)
    assert min(got) < 0.01 * max(got)  # the cycles reach their floor


def test_one_cycle_matches_torch_and_jax():
    max_lr, total_steps = 0.5, 100
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=max_lr)
    sched = torch.optim.lr_scheduler.OneCycleLR(opt, max_lr=max_lr, total_steps=total_steps)
    ours = sgd_map.one_cycle_lr(max_lr, total_steps)
    jax_fn = jsgd.one_cycle_lr(max_lr, total_steps)
    for step in range(total_steps):
        got = float(ours(0, 0, step))
        # the JAX package's closed form holds torch's to 2e-2 (tests/test_schedules.py)
        assert got == pytest.approx(opt.param_groups[0]["lr"], rel=2e-2), step
        # near the floor 1 + cos(pi t) cancels: the two libraries' float32
        # cosines differ there by an ulp of 1, so the bound is absolute too
        assert got == pytest.approx(float(jax_fn(0, 0, jnp.asarray(step))), rel=1e-6,
                                    abs=1e-7), step
        opt.step()
        sched.step()


def test_mcdropout_one_cycle_hyperparameters_match_jax():
    hyp = {"lr": 0.05, "epochs": 2, "dropout": 0.2, "lengthscale": 0.01,
           "num_samples": 3, "momentum": 0.9, "weight_decay": 0}
    splits, c = jdata.loaders("MNIST", None, **LOADER)
    js = jsgd.MCdropout(hyp, model=jmodels.get_model("MLP200MNIST_dropout").build(c),
                        train=splits["train"])
    tsplits, _ = tdata.loaders("MNIST", None, **LOADER)
    ts = sgd_map.MCdropout(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                           train=tsplits["train"], device="cpu", model_name="MLP200MNIST")
    for k, v in js._hyp_scalars.items():
        assert float(ts._hyp[k]) == float(v), k
    for step in range(0, 30):
        assert float(sgd_map._one_cycle_hyp_lr(ts._hyp, 0, 0, step)) == pytest.approx(
            float(jsgd._one_cycle_hyp_lr(js._hyp_scalars, 0, 0, jnp.int32(step))),
            rel=1e-6, abs=1e-7), step


def test_swa_schedule_matches_jax():
    values = {"lr_init": 0.05, "swag_lr": 0.01, "burn_in_epochs": 10.0}
    jh, th = _hyps(values)
    got = [float(swa._swa_schedule_hyp_lr(th, e, 0, 0)) for e in range(14)]
    want = [float(jswa._swa_schedule_hyp_lr(jh, jnp.float32(e), 0, 0)) for e in range(14)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(0.05) and got[-1] == pytest.approx(0.01)
