"""Checkpoints of ursabench_tpu_torch: a chain killed mid-run and resumed
equals the uninterrupted run bit for bit (the port's twins of
tests/test_drivers.py's SGLD, HMC and PCA-ESS resume tests, plus SGHMC
with two PreResNet-8 chains and cSGLD), and a variables file written by
either package loads into the other with equal forwards."""

import jax
import numpy as np
import pytest
import torch
from test_torch_samplers import _as_numpy, _splits

from ursabench_tpu import models as jmodels
from ursabench_tpu import utils_checkpoint as jckpt
from ursabench_tpu.inference.engine import init_variables
from ursabench_tpu_torch import inference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import utils_checkpoint as ckpt
from ursabench_tpu_torch.transfer import params_from_jax, params_to_jax

torch.set_num_threads(1)

SGLD_HYP = {"lr": 0.03, "prior_std": 1.0, "num_samples": 3, "burn_in_epochs": 1, "alpha": 0.1}
CYC_HYP = {"lr_0": 0.05, "prior_std": 1.0, "num_samples_per_cycle": 2, "cycle_length": 4,
           "burn_in_epochs": 1, "num_cycles": 1}
HMC_HYP = {"step_size": 5e-3, "num_samples": 6, "L": 1, "tau": 1.0, "burn": 0, "mass": 1.0,
           "draw_chunk": 2, "grad_batch": 64}
PCA_HYP = {"swag_lr": 0.01, "swag_wd": 1e-4, "lr_init": 0.02, "num_samples": 4,
           "swag_momentum": 0.9, "swag_burn_in_epochs": 1, "num_swag_iterates": 3, "rank": 2,
           "max_rank": 3, "temperature": 100.0, "prior_std": 1.0}


def _assert_same_ensemble(a, b):
    assert a.num_members == b.num_members and sorted(a.state) == sorted(b.state)
    for k in a.state:
        assert torch.equal(a.state[k], b.state[k]), k


@pytest.mark.parametrize("method,model,dataset,chains,hyp", [
    ("SGLD", "MLP200MNIST", "MNIST", 1, SGLD_HYP),
    ("SGHMC", "PreResNet8", "CIFAR10", 2, SGLD_HYP),
    ("cSGLD", "MLP200MNIST", "MNIST", 1, CYC_HYP),
])
def test_epoch_sampler_resume_equals_uninterrupted(tmp_path, method, model, dataset, chains,
                                                   hyp):
    _, ts_, c = _splits(dataset)
    path = str(tmp_path / "chain.npz")

    def make():
        return getattr(inference, method)(hyp, model=tmodels.get_model(model).build(c),
                                          train=ts_["train"], device="cpu", chains=chains,
                                          seed=5)

    full = make()
    draws = [full.sample_iterative() for _ in range(3)]
    part = make()
    assert not part.enable_auto_checkpoint(path, every_epochs=1)
    first = part.sample_iterative()  # checkpointed after each of its epochs
    epochs = part.epochs_run
    res = make()
    assert res.enable_auto_checkpoint(path, every_epochs=1)
    assert (res.epochs_run, res.burnt_in, res._state.step) == (epochs, part.burnt_in,
                                                               part._state.step)
    assert torch.equal(res._state.params, part._state.params)
    for got, want in zip([first] + [res.sample_iterative() for _ in range(2)], draws):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert torch.equal(res._state.momentum, full._state.momentum)


def test_restore_refuses_another_chain_count(tmp_path):
    _, ts_, c = _splits()
    path = str(tmp_path / "chain.npz")
    one = inference.SGLD(SGLD_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                         train=ts_["train"], device="cpu")
    ckpt.save_sampler_state(path, one)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["chain.npz"]  # no temporary left
    two = inference.SGLD(SGLD_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                         train=ts_["train"], device="cpu", chains=2)
    with pytest.raises(ValueError, match="params"):
        ckpt.restore_sampler_state(path, two)


def test_hmc_mid_chain_resume(tmp_path):
    """Twin of tests/test_drivers.py::test_hmc_mid_chain_checkpoint_resume:
    checkpoint every 2 draws, stop after 4 of 6, resume."""
    _, ts_, c = _splits(synthetic_n_train=64)
    path = str(tmp_path / "hmc.npz")

    def make():
        return inference.HMC(HMC_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                             train=ts_["train"], device="cpu", seed=4)

    full = make()
    ens_full = full.sample()
    part = make()
    part.enable_auto_checkpoint(path, every_epochs=2, resume=False)
    part.sample(num_samples=4)
    assert int(ckpt.load_pytree(path)["draws_done"]) == 4
    res = make()
    assert res.enable_auto_checkpoint(path, every_epochs=2) and res.draws_done == 4
    _assert_same_ensemble(res.sample(), ens_full)
    assert res.draws_done == 6 and res.accept_rate == full.accept_rate


def test_pca_ess_mid_chain_resume(tmp_path):
    """Twin of tests/test_drivers.py::test_pca_ess_mid_chain_checkpoint_resume:
    the resumed run skips the SWA phase and reprojects the saved draws."""
    _, ts_, c = _splits(synthetic_n_train=64)
    path = str(tmp_path / "ess.npz")

    def make():
        return inference.PCASubspaceSampler(
            PCA_HYP, model=tmodels.get_model("MLP200MNIST").build(c), train=ts_["train"],
            device="cpu", seed=6)

    ens_full = make().sample()
    part = make()
    part.enable_auto_checkpoint(path, every_epochs=1, resume=False)
    part.sample(num_samples=2)
    res = make()
    assert res.enable_auto_checkpoint(path, every_epochs=1) and res.draws_done == 2
    assert not res.subspace_constructed
    ens = res.sample()
    assert res.subspace_constructed and res.swa.epochs_run == 0  # no SWA epoch ran
    _assert_same_ensemble(ens, ens_full)


@pytest.mark.parametrize("name,shape", [("MLP200MNIST", (28, 28, 1)),
                                        ("PreResNet8", (32, 32, 3))])
def test_variables_files_load_in_both_packages(tmp_path, name, shape):
    jm = jmodels.get_model(name).build(10)
    variables = _as_numpy(init_variables(jm, jax.random.PRNGKey(1), shape))
    rng = np.random.default_rng(0)
    if "batch_stats" in variables:  # statistics other than the init's
        variables["batch_stats"] = jax.tree.map(
            lambda v: (np.abs(rng.normal(size=v.shape)) + 0.5).astype(np.float32),
            variables["batch_stats"])
    x = rng.normal(size=(4,) + shape).astype(np.float32)

    def forwards(jax_vars, module):
        want = np.asarray(jm.apply(jax_vars, x, train=False))
        got = module.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        return got.detach().numpy(), want

    jckpt.save_variables(str(tmp_path / "jax.npz"), variables)
    module = ckpt.load_variables(str(tmp_path / "jax.npz"), tmodels.get_model(name).build(10))
    np.testing.assert_allclose(*forwards(variables, module), rtol=0, atol=1e-5)

    module = tmodels.get_model(name).build(10)
    module.init_parameters(torch.Generator().manual_seed(3))
    for buf in module.buffers():
        buf.copy_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(4)) + 0.5)
    ckpt.save_variables(str(tmp_path / "torch.npz"), module)
    loaded = jckpt.load_variables(str(tmp_path / "torch.npz"))
    assert jax.tree.structure(loaded) == jax.tree.structure(variables)
    np.testing.assert_allclose(*forwards(loaded, module), rtol=0, atol=1e-5)
    again = params_from_jax(tmodels.get_model(name).build(10), params_to_jax(module))
    for k, v in module.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_ensemble_file_roundtrip(tmp_path):
    _, ts_, c = _splits()
    module = tmodels.get_model("MLP200MNIST_dropout").build(c)
    ens = inference.MCdropout({"lr": 0.02, "epochs": 0, "dropout": 0.1, "lengthscale": 0.01,
                               "num_samples": 2, "momentum": 0.9}, model=module,
                              train=ts_["train"], device="cpu").sample()
    path = str(tmp_path / "ens.npz")
    ckpt.save_ensemble(path, ens)
    back = ckpt.load_ensemble(path, module)
    assert back.dropout_seed == ens.dropout_seed and back.num_members == 2
    x = torch.rand(3, 1, 28, 28)
    assert torch.equal(back.logits_all(x, 1), ens.logits_all(x, 1))
