"""One SGHMC/SGLD epoch of ursabench_tpu_torch against the JAX package's
compiled epoch, from the same transferred PreResNet-8 weights, fed the JAX
permutation (rebuilt from the state's key as engine.py:230-231 does), with
the noise and augmentation off; plus the learning-rate schedule, the batch
plan and the sampler protocol."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu.inference import sgmcmc as jsgmcmc
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.inference import engine, sgmcmc
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1,
       "burn_in_epochs": 1}
LOADER = dict(batch_size=32, use_validation=False, synthetic_n_train=96,
              synthetic_n_test=40)


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _as_numpy(tree):
    return jax.tree.map(np.array, tree)


def _state_dict_from(variables, num_classes):
    m = params_from_jax(tmodels.get_model("PreResNet8").build(num_classes), variables)
    return m.state_dict()


@pytest.mark.parametrize("cls,alpha", [("SGHMC", 0.5), ("SGLD", 1.0)])
def test_epoch_matches_jax(cls, alpha):
    """alpha 0.5 rather than 0.1: the reference's first step moves the
    weights by (momentum - lr) * d, 0.85 * d at alpha 0.1, and that
    amplifies XLA:CPU's float32 gradient error in the early layers of this
    model (about 1e-5; the port's float32 gradients agree with a float64
    run to 1e-7) past 1e-4 within three steps."""
    splits, c = jdata.loaders("CIFAR10", None, **LOADER)
    jm = jmodels.get_model("PreResNet8").build(c)
    js = getattr(jsgmcmc, cls)({**HYP, "alpha": alpha}, model=jm,
                               train=splits["train"], key=jax.random.PRNGKey(0))
    start = _as_numpy({"params": js._state.params,
                       "batch_stats": js._state.batch_stats})
    _, k_perm, _, _, _ = jax.random.split(js._state.key, 5)
    perm = np.array(jax.random.permutation(k_perm, 96))
    js._state, loss_j = js._epoch_fn(js._state, jnp.float32(0.0),
                                     jnp.float32(0.0), js._hyp_scalars)
    end = _as_numpy({"params": js._state.params,
                     "batch_stats": js._state.batch_stats})

    tsplits, _ = tdata.loaders("CIFAR10", None, **LOADER)
    split = tsplits["train"]
    assert not split.spec.augments  # no transforms given: 0.5/0.5, no crop/flip
    tm = tmodels.get_model("PreResNet8").build(c)
    params, grads = engine.flatten_parameters(tm)
    params_from_jax(tm, start)
    state = engine.TrainState(tm, params, torch.zeros_like(params), grads)
    hyp = {k: torch.tensor(float(v)) for k, v in js._hyp_scalars.items()}
    images, labels = split.device_tensors("cpu")
    loss_t = engine.train_steps(
        state, images, labels, torch.from_numpy(perm).view(3, 32),
        spec=split.spec, epoch=0, noise_on=torch.tensor(0.0), hyp=hyp,
        lr_fn=sgmcmc._cosine_hyp_lr, update_fn=sgmcmc._sghmc_hyp_update,
        seeds=[1, 2, 3])

    assert state.step == 3 == int(js._state.step)
    assert float(loss_t) == pytest.approx(float(loss_j), abs=1e-4)
    want, before = _state_dict_from(end, c), _state_dict_from(start, c)
    got = tm.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
    # the epoch really changed the weights
    assert max(float((want[k] - before[k]).abs().max()) for k in want) > 1e-3


def test_cosine_lr_matches_torch_scheduler():
    lr0, eta_min, t_max = 0.1, 0.01, 20
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=lr0)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=t_max, eta_min=eta_min)
    hyp = {"lr0": torch.tensor(lr0), "eta_min": torch.tensor(eta_min),
           "t_max": torch.tensor(float(t_max))}
    for epoch in range(t_max + 1):
        got = float(sgmcmc._cosine_hyp_lr(hyp, epoch, 0, 0))
        assert got == pytest.approx(opt.param_groups[0]["lr"], rel=1e-5), epoch
        opt.step()
        sched.step()


def test_epoch_indices_pad_with_permutation_head():
    gen = torch.Generator().manual_seed(0)
    idx = engine.epoch_indices(gen, 10, 4)
    assert tuple(idx.shape) == (3, 4)
    flat = idx.reshape(-1)
    assert sorted(flat[:10].tolist()) == list(range(10))
    assert flat[10:].tolist() == flat[:2].tolist()


def _sampler(seed=0, cls=sgmcmc.SGHMC, **hyp):
    splits, c = tdata.loaders("CIFAR10", None, batch_size=16, use_validation=False,
                              synthetic_n_train=40, synthetic_n_test=8,
                              transform_train=tdata.transforms.CIFAR_TRAIN)
    return cls({**HYP, **hyp}, model=tmodels.get_model("PreResNet8").build(c),
               train=splits["train"], seed=seed, device="cpu")


def test_sampler_protocol_and_determinism():
    a = _sampler(seed=3)
    ens = a.sample()
    # burn_in + 1 epochs for the first draw, then one per draw
    assert a.epochs_run == 3 and a._state.step == 9 and len(a.epoch_losses) == 3
    assert ens.num_members == 2
    assert all(v.shape[0] == 2 for v in ens.state.values())
    assert not torch.equal(ens.member(0)["fc.weight"], ens.member(1)["fc.weight"])
    b = _sampler(seed=3).sample()
    for k in ens.state:
        assert torch.equal(ens.state[k], b.state[k]), k
    c = _sampler(seed=4).sample()
    assert not torch.equal(ens.state["fc.weight"], c.state["fc.weight"])


def test_update_hyp_resets_and_fills_device_hyperparameters():
    s = _sampler()
    tensors = dict(s._hyp)
    s.sample(num_samples=1)
    s.update_hyp({**HYP, "lr": 0.02})
    assert s.epochs_run == 0 and s._state.step == 0 and not s.burnt_in
    assert float(s._state.momentum.abs().max()) == 0.0
    for k, t in s._hyp.items():
        assert t is tensors[k]  # filled in place, not rebuilt
    assert float(s._hyp["lr0"]) == pytest.approx(0.02)
    assert float(s._hyp["eta_min"]) == pytest.approx(0.01)  # lr/2 after update_hyp


def test_sgld_pins_momentum_to_zero():
    s = _sampler(cls=sgmcmc.SGLD, alpha=0.3)
    assert s.momentum == 0.0 and float(s._hyp["momentum"]) == 0.0


def test_cuda_sampler_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    splits, c = tdata.loaders("MNIST", None, batch_size=8, use_validation=False,
                              synthetic_n_train=16, synthetic_n_test=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        sgmcmc.SGHMC(HYP, model=tmodels.get_model("PreResNet8").build(c),
                     train=splits["train"])
    # the batched strategy runs where it is asked to, an unknown one raises
    vmapped = sgmcmc.SGHMC(HYP, model=tmodels.get_model("PreResNet8").build(c),
                           train=splits["train"], chains=2, device="cpu",
                           chain_strategy="vmap")
    assert vmapped._resolved_chain_strategy == "vmap" and vmapped.device.type == "cpu"
    with pytest.raises(ValueError, match="chain_strategy"):
        sgmcmc.SGHMC(HYP, model=tmodels.get_model("PreResNet8").build(c),
                     train=splits["train"], chains=2, device="cpu",
                     chain_strategy="lockstep")


@pytest.mark.parametrize("unused,free,emptied", [(79, 2, True), (1, 75, False)])
def test_a_capture_returns_the_cache_only_when_it_outgrows_the_free_memory(
        monkeypatch, unused, free, emptied):
    """Before a capture, whose allocations cannot release the allocator's
    unused blocks, those blocks go back to the device where they hold more
    than it has free (a long process near the card's end), and stay cached
    otherwise (GB here)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 80))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: unused + 2)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 2)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: calls.append(1))
    engine._return_unused_cache(torch.device("cuda"))
    assert calls == ([1] if emptied else [])
