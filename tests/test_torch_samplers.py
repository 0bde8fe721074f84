"""The epoch samplers of ursabench_tpu_torch against the JAX package's:
SGD, cSGHMC/cSGLD, DeepEnsemble and SGHMC with chains, MCdropout, SWA and
SWAG, and the validation loss.

The same seeded data and the same JAX-initialised weights (through
``transfer.params_from_jax``) go into both packages; the random choices
(permutations, SWAG's normals) are drawn on the JAX side and handed to the
port. Flat vectors are compared through ``flat_permutation`` (below): the
JAX package ravels leaves in pytree order, the port in ``parameters()``
order. MLP200MNIST throughout, PreResNet-8 where BatchNorm matters.
Deterministic math agrees to 1e-5; dropout is checked in distribution."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu import util as jutil
from ursabench_tpu.inference import sgd_map as jsgd
from ursabench_tpu.inference import sgmcmc as jsgmcmc
from ursabench_tpu.inference import swa as jswa
from ursabench_tpu.inference import swag as jswag
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.inference import engine, sgd_map, sgmcmc, swa, swag
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

LOADER = dict(batch_size=32, use_validation=False, synthetic_n_train=96,
              synthetic_n_test=40)
SGD_HYP = {"lr": 0.05, "epochs": 1, "momentum": 0.9, "weight_decay": 5e-4}
CYC_HYP = {"lr_0": 0.05, "prior_std": 1.0, "num_samples_per_cycle": 2, "cycle_length": 4,
           "burn_in_epochs": 1, "num_cycles": 1, "alpha": 0.1}
SWA_HYP = {"swag_lr": 0.01, "swag_wd": 5e-4, "lr_init": 0.05, "num_samples": 3,
           "momentum": 0.9, "burn_in_epochs": 1, "num_iterates": 2}


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _as_numpy(tree):
    return jax.tree.map(np.array, tree)


def _leaf_order(tree, counter):
    """``tree`` with each leaf replaced by the flat indices it takes in the
    JAX package's ``ravel`` (dict keys sorted at every level)."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out[k] = _leaf_order(tree[k], counter)
        else:
            shape = np.shape(tree[k])
            size = int(np.prod(shape))
            out[k] = np.arange(counter[0], counter[0] + size, dtype=np.float64).reshape(shape)
            counter[0] += size
    return out


def flat_permutation(module, variables):
    """int64 ``perm`` with ``torch_flat = jax_flat[perm]``: ``jax_flat`` is
    the JAX package's ``ravel(variables["params"])``, ``torch_flat`` the
    concatenation of ``module.parameters()``; built by loading each leaf's
    indices, in float64, through ``params_from_jax``."""
    probe = params_from_jax(copy.deepcopy(module).to(torch.float64),
                            {"params": _leaf_order(variables["params"], [0]),
                             "batch_stats": variables.get("batch_stats", {})})
    return torch.cat([p.detach().reshape(-1) for p in probe.parameters()]).round().long()


def _splits(dataset="MNIST", **kw):
    kw = {**LOADER, **kw}
    js, c = jdata.loaders(dataset, None, **kw)
    ts, _ = tdata.loaders(dataset, None, **kw)
    return js, ts, c


def _perm(key, n):
    """The epoch's permutation, rebuilt from a chain's key as
    engine.py:230-231 does."""
    _, k_perm, _, _, _ = jax.random.split(key, 5)
    return np.array(jax.random.permutation(k_perm, n))


def _start(js):
    return _as_numpy({"params": js._state.params, "batch_stats": js._state.batch_stats})


def _chain(tree, c):
    return jax.tree.map(lambda x: x[c], tree)


def _run_port_epoch(ts, perms, noise_on=0.0, epoch=0):
    """One epoch of ``ts`` over the given per-chain permutations."""
    split = ts.train
    idx = torch.from_numpy(np.stack(perms)).view(len(perms), -1, split.batch_size)
    return engine.train_steps(
        ts._state, ts._images, ts._labels, idx, spec=split.spec, epoch=epoch,
        noise_on=torch.tensor(float(noise_on)), hyp=ts._hyp, lr_fn=ts._LR_FN,
        update_fn=ts._UPDATE_FN, seeds=[1] * idx.shape[1])


def _assert_module_equals(module, variables, name, atol=1e-5):
    want = params_from_jax(tmodels.get_model(name).build(10), variables).state_dict()
    got = module.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=atol,
                                   err_msg=k)


def test_sgd_epoch_matches_jax():
    js_, ts_, c = _splits()
    jm = jmodels.get_model("MLP200MNIST").build(c)
    js = jsgd.SGD(SGD_HYP, model=jm, train=js_["train"], key=jax.random.PRNGKey(0))
    start, perm = _start(js), _perm(js._state.key, 96)
    js._state, loss_j = js._epoch_fn(js._state, jnp.float32(0.0), jnp.float32(0.0),
                                     js._hyp_scalars)

    ts = sgd_map.SGD(SGD_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                     train=ts_["train"], device="cpu")
    for k, v in js._hyp_scalars.items():
        assert float(ts._hyp[k]) == pytest.approx(float(v), rel=1e-7), k
    params_from_jax(ts.module, start)
    loss_t = _run_port_epoch(ts, [perm])
    assert float(loss_t) == pytest.approx(float(loss_j), abs=1e-5)
    _assert_module_equals(ts.module, _start(js), "MLP200MNIST")
    before = params_from_jax(tmodels.get_model("MLP200MNIST").build(c), start)
    assert float((ts._state.params - engine.flatten_parameters(before)[0]).abs().max()) > 1e-3


def test_sgd_protocol():
    """epochs + 1 epochs, then none; one member; eta_min 0.01 * lr, then
    0.5 * lr after update_hyp."""
    _, ts_, c = _splits()
    ts = sgd_map.SGD(SGD_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                     train=ts_["train"], device="cpu")
    assert float(ts._hyp["eta_min"]) == pytest.approx(0.01 * 0.05)
    ens = ts.sample()
    assert ens.num_members == 1 and ts.epochs_run == 2 and ts._state.step == 6
    ts.sample_iterative()
    assert ts.epochs_run == 2
    ts.update_hyp(SGD_HYP)
    assert float(ts._hyp["eta_min"]) == pytest.approx(0.5 * 0.05) and ts.epochs_run == 0


@pytest.mark.parametrize("cls", ["cSGHMC", "cSGLD"])
def test_csghmc_noise_off_first_epoch_matches_jax(cls):
    """The first epoch of a cycle runs without noise (cycle 4, burn-in 1, 2
    samples a cycle), under the per-batch cyclic learning rate."""
    js_, ts_, c = _splits()
    jm = jmodels.get_model("MLP200MNIST").build(c)
    js = getattr(jsgmcmc, cls)(CYC_HYP, model=jm, train=js_["train"],
                               key=jax.random.PRNGKey(1))
    assert not js._noise_on()
    start, perm = _start(js), _perm(js._state.key, 96)
    js._state, loss_j = js._epoch_fn(js._state, jnp.float32(0.0), jnp.float32(0.0),
                                     js._hyp_scalars)
    ts = getattr(sgmcmc, cls)(CYC_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                              train=ts_["train"], device="cpu")
    assert not ts._noise_on() and ts.momentum == js.momentum
    params_from_jax(ts.module, start)
    loss_t = _run_port_epoch(ts, [perm], noise_on=0.0)
    assert float(loss_t) == pytest.approx(float(loss_j), abs=1e-5)
    _assert_module_equals(ts.module, _start(js), "MLP200MNIST")


def test_csghmc_noise_and_harvest_sequence_over_two_cycles():
    """The noise gate of every epoch and the epochs that end with a draw
    follow JAX's rules over 2 cycles; the member count is JAX's."""
    hyp = {**CYC_HYP, "num_cycles": 2}
    js_, ts_, c = _splits(synthetic_n_train=32)
    js = jsgmcmc.cSGHMC(hyp, model=jmodels.get_model("MLP200MNIST").build(c),
                        train=js_["train"])
    want_noise, want_harvest = [], []
    for _ in range(8):
        want_noise.append(js._noise_on())
        js.epochs_run += 1
        want_harvest.append(js._harvested())
    assert want_noise == [False, True, True, True] * 2
    assert want_harvest == [False, False, True, True] * 2

    ts = sgmcmc.cSGHMC(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                       train=ts_["train"], device="cpu", chains=2)
    seen = []
    run_epoch = ts._run_epoch

    def logged(noise_on=None):
        loss = run_epoch(noise_on)
        seen.append((noise_on, float(ts._noise_gate), ts._harvested()))
        return loss

    ts._run_epoch = logged
    ens = ts.sample()
    assert [s[0] for s in seen] == want_noise
    assert [s[1] for s in seen] == [float(v) for v in want_noise]
    assert [s[2] for s in seen] == want_harvest
    assert ens.num_members == 2 * 2 * 2  # samples a cycle x cycles x chains


def test_deep_ensemble_epoch_matches_jax_chain_by_chain():
    js_, ts_, c = _splits()
    hyp = {**SGD_HYP, "num_members": 2}
    jm = jmodels.get_model("MLP200MNIST").build(c)
    js = jsgd.DeepEnsemble(hyp, model=jm, train=js_["train"], key=jax.random.PRNGKey(2))
    start = _start(js)
    perms = [_perm(js._state.key[i], 96) for i in range(2)]
    js._state, loss_j = js._epoch_fn(js._state, jnp.float32(0.0), jnp.float32(0.0),
                                     js._hyp_scalars)
    end = _start(js)

    ts = sgd_map.DeepEnsemble(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                              train=ts_["train"], device="cpu")
    assert ts.chains == 2 and ts._state.params.shape == (2, 199210)
    for i in range(2):
        params_from_jax(ts.modules[i], _chain(start, i))
    loss_t = _run_port_epoch(ts, perms)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=0, atol=1e-5)
    for i in range(2):
        _assert_module_equals(ts.modules[i], _chain(end, i), "MLP200MNIST")
    # members in JAX's order: member i is chain i
    ens = ts._ensemble_from_draws([ts._harvest()])
    assert ens.num_members == 2
    for i in range(2):
        for k, v in ts.modules[i].state_dict().items():
            assert torch.equal(ens.member(i)[k], v), (i, k)


def test_deep_ensemble_members_are_chains():
    _, ts_, c = _splits(synthetic_n_train=32)
    ts = sgd_map.DeepEnsemble({**SGD_HYP, "num_members": 3},
                              model=tmodels.get_model("MLP200MNIST").build(c),
                              train=ts_["train"], device="cpu")
    ens = ts.sample(num_samples=7)  # ignored: one draw a member
    assert ens.num_members == 3
    w = ens.state["fc1.weight"]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])


def test_sghmc_two_chains_one_update_a_step(monkeypatch):
    """Both chains' rows go through one update call a step; an ensemble of
    S draws has S * 2 members, draw-major."""
    _, ts_, c = _splits(synthetic_n_train=64)
    calls = []
    update = sgmcmc.sghmc_update

    def counted(params, *args, **kw):
        calls.append(params.numel())
        return update(params, *args, **kw)

    monkeypatch.setattr(sgmcmc, "sghmc_update", counted)
    hyp = {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1,
           "burn_in_epochs": 0}
    ts = sgmcmc.SGHMC(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                      train=ts_["train"], device="cpu", chains=2)
    draws = [ts.sample_iterative() for _ in range(2)]
    assert calls == [2 * 199210] * (2 * 2)  # 2 epochs of 2 steps
    assert draws[0]["fc1.weight"].shape == (2, 200, 784)
    ens = ts._ensemble_from_draws(draws)
    assert ens.num_members == 4
    for s in range(2):
        for ch in range(2):
            assert torch.equal(ens.member(2 * s + ch)["fc3.bias"], draws[s]["fc3.bias"][ch])
    assert not torch.equal(draws[1]["fc1.weight"][0], draws[1]["fc1.weight"][1])
    scanned = sgmcmc.SGHMC(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                           train=ts_["train"], device="cpu", chains=2, chain_strategy="scan")
    assert scanned._resolved_chain_strategy == "scan" and ts._resolved_chain_strategy == "vmap"


def test_mcdropout_members_share_weights_and_differ():
    hyp = {"lr": 0.05, "epochs": 1, "dropout": 0.2, "lengthscale": 0.01,
           "num_samples": 3, "momentum": 0.9, "weight_decay": 0}
    js_, ts_, c = _splits(synthetic_n_train=64)
    js = jsgd.MCdropout(hyp, model=jmodels.get_model("MLP200MNIST").build(c),
                        train=js_["train"], model_name="MLP200MNIST")
    ts = sgd_map.MCdropout(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                           train=ts_["train"], device="cpu", model_name="MLP200MNIST")
    assert ts.weight_decay == pytest.approx(js.weight_decay, rel=1e-12)
    assert ts.weight_decay == pytest.approx(0.01 ** 2 * 0.8 / (2 * 64))
    assert len(tmodels.common.dropout_layers(ts.module)) == 2
    ens = ts.sample()
    assert ens.num_members == 3 and ts.epochs_run == 4  # epochs + 1, then 1 a draw
    assert all(v.stride(0) == 0 for v in ens.state.values())  # one shared weight set
    x, _ = next(ts_["test"].batches("cpu"))
    x = x.permute(0, 3, 1, 2).contiguous()
    a, b = ens.logits_all(x, 0), ens.logits_all(x, 0)
    assert torch.equal(a, b)  # the same seed and batch: the same masks
    assert not torch.allclose(a[0], a[1])  # each member its own stream
    assert not torch.allclose(a, ens.logits_all(x, 1))  # and each batch


def _collect_both(js, ts, perm, rng, k, collect_j, collect_t):
    """Feed k random iterates, drawn in JAX's order, to both samplers."""
    unravel = jutil.unraveler(js._state.params)
    ws = []
    for _ in range(k):
        w = rng.normal(size=js.num_parameters).astype(np.float32)
        js._state = js._state._replace(params=unravel(jnp.asarray(w)))
        ts._state.params.view(-1).copy_(torch.from_numpy(w)[perm])
        collect_j(), collect_t()
        ws.append(w)
    return ws


def _swa_pair(cls_j, cls_t, name="MLP200MNIST", dataset="MNIST", **kw):
    js_, ts_, c = _splits(dataset, synthetic_n_train=64)
    js = cls_j(SWA_HYP, model=jmodels.get_model(name).build(c), train=js_["train"],
               max_rank=3, pca_rank=2, **kw)
    ts = cls_t(SWA_HYP, model=tmodels.get_model(name).build(c), train=ts_["train"],
               device="cpu", max_rank=3, pca_rank=2, **kw)
    return js, ts, flat_permutation(ts.module, _start(js)).numpy()


def test_swa_moments_match_jax_with_the_phantom_zero():
    js, ts, perm = _swa_pair(jswa.SWA, swa.SWA)
    rng = np.random.default_rng(0)

    def step(sampler):
        return lambda: (setattr(sampler, "num_models_collected",
                                sampler.num_models_collected + 1), sampler._collect_model())

    ws = _collect_both(js, ts, perm, rng, 1, step(js), step(ts))
    np.testing.assert_allclose(ts.weight_mean.numpy(), ws[0][perm] / 2, rtol=1e-6)
    _collect_both(js, ts, perm, rng, 3, step(js), step(ts))
    for got, want in ((ts.weight_mean, js.weight_mean), (ts.sq_mean, js.sq_mean)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[perm], rtol=1e-5, atol=1e-6)
    mean, var, cov = ts.get_space()
    jmean, jvar, jcov = js.get_space()
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar)[perm], rtol=1e-4, atol=1e-6)
    assert float(var.min()) >= swa.SWA.VAR_CLAMP
    np.testing.assert_allclose(ts.subspace.cov_mat_sqrt.numpy(),
                               np.asarray(js.subspace.cov_mat_sqrt)[:, perm],
                               rtol=1e-5, atol=1e-5)
    assert cov.shape == (2, ts.num_parameters)
    for i in range(2):  # principal directions up to sign
        a, b = cov[i].numpy(), np.asarray(jcov)[i][perm]
        sign = np.sign(a @ b)
        np.testing.assert_allclose(a, sign * b, rtol=1e-3, atol=1e-4 * np.abs(b).max())


def test_swa_mean_with_bn_refresh_matches_jax():
    """PreResNet-8: the SWA mean's weights and its refreshed BatchNorm
    statistics, from the same mean vector."""
    js, ts, perm = _swa_pair(jswa.SWA, swa.SWA, "PreResNet8", "CIFAR10")
    mean = np.asarray(jutil.ravel(js._state.params)) * 1.5
    js.weight_mean = jnp.asarray(mean)
    ts.weight_mean = torch.from_numpy(mean[perm])
    params, bstats = js._swa_variables(update_bn=True)
    got = ts._variables_at(ts.weight_mean, update_bn=True)
    want = params_from_jax(tmodels.get_model("PreResNet8").build(10),
                           _as_numpy({"params": params, "batch_stats": bstats})).state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # the live iterate's buffers are not the refreshed ones
    assert not torch.allclose(ts.module.state_dict()["bn.running_var"], got["bn.running_var"])


def test_swag_draws_match_jax_given_its_normals():
    js, ts, perm = _swa_pair(jswag.SWAG, swag.SWAG)
    rng = np.random.default_rng(1)
    _collect_both(js, ts, perm, rng, 3, js._collect_model_correct, ts._collect_model_correct)
    assert ts.num_models_collected == 3 and ts.subspace.cov_mat_sqrt.shape[0] == 3
    for full_cov in (False, True):
        _, sub = jax.random.split(js.key)  # the key _draw_weight_sample takes
        k_diag, k_low = jax.random.split(sub)
        eps = np.array(jax.random.normal(k_diag, (js.num_parameters,)))
        z = np.array(jax.random.normal(k_low, (3,)))
        want = np.asarray(js._draw_weight_sample(full_cov))[perm]
        got = ts._draw_weight_sample(full_cov, (torch.from_numpy(eps[perm]),
                                                torch.from_numpy(z)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_swag_members():
    """True SWAG draws differ; reference_bug_compat gives identical ones."""
    _, ts_, c = _splits(synthetic_n_train=64)

    def make(**kw):
        return swag.SWAG(SWA_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                         train=ts_["train"], device="cpu", max_rank=3, pca_rank=2, **kw)

    ens = make().sample(num_samples=2, full_cov=True)
    assert ens.num_members == 2
    assert not torch.equal(ens.member(0)["fc1.weight"], ens.member(1)["fc1.weight"])
    compat = make(reference_bug_compat=True)
    ens = compat.sample(num_samples=2)
    for k in ens.state:
        assert torch.equal(ens.member(0)[k], ens.member(1)[k]), k
    assert compat.num_models_collected == 0 and compat.epochs_run == 3


def test_swa_sample_is_the_mean_repeated():
    _, ts_, c = _splits(synthetic_n_train=64)
    s = swa.SWA(SWA_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                train=ts_["train"], device="cpu", max_rank=3, pca_rank=2)
    ens = s.sample()
    assert ens.num_members == 2 and s.epochs_run == 3
    assert torch.equal(ens.member(0)["fc1.weight"], ens.member(1)["fc1.weight"])
    assert torch.allclose(ens.member(0)["fc1.weight"].reshape(-1),
                          s.weight_mean[:200 * 784])


def test_compute_val_loss_matches_jax():
    """PreResNet-8 in eval mode over 70 images at batch 32: the last batch
    is padded and masked."""
    js_, ts_, c = _splits("CIFAR10", synthetic_n_test=70)
    jm = jmodels.get_model("PreResNet8").build(c)
    js = jsgmcmc.SGHMC({"lr": 0.05, "prior_std": 1.0, "num_samples": 1, "alpha": 0.1,
                        "burn_in_epochs": 0}, model=jm, train=js_["train"],
                       key=jax.random.PRNGKey(3))
    variables = _as_numpy(jax.tree.map(lambda x: x, _start(js)))
    variables["batch_stats"] = jax.tree.map(
        lambda v: np.random.default_rng(4).uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    want = js.compute_val_loss(js_["test"], variables["params"], variables["batch_stats"])
    ts = sgmcmc.SGHMC({"lr": 0.05, "prior_std": 1.0, "num_samples": 1, "alpha": 0.1,
                       "burn_in_epochs": 0}, model=tmodels.get_model("PreResNet8").build(c),
                      train=ts_["train"], device="cpu")
    params_from_jax(ts.module, variables)
    assert ts_["test"].n % ts_["test"].batch_size != 0
    assert ts.compute_val_loss(ts_["test"]) == pytest.approx(want, rel=1e-5)
    state = {k: v.clone() for k, v in ts.module.state_dict().items()}
    engine.init_variables(ts.module, torch.Generator().manual_seed(9))
    assert ts.compute_val_loss(ts_["test"], state) == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("cls,hyp,new", [
    (sgmcmc.cSGHMC, CYC_HYP, {**CYC_HYP, "lr_0": 0.02}),
    (sgd_map.SGD, SGD_HYP, {**SGD_HYP, "lr": 0.02}),
    (sgd_map.MCdropout, {"lr": 0.05, "epochs": 1, "dropout": 0.2, "lengthscale": 0.01,
                         "num_samples": 2, "momentum": 0.9, "weight_decay": 0},
     {"lr": 0.02, "epochs": 1, "dropout": 0.2, "lengthscale": 0.01, "num_samples": 2,
      "momentum": 0.9, "weight_decay": 0}),
    (swa.SWA, SWA_HYP, {**SWA_HYP, "lr_init": 0.02}),
])
def test_update_hyp_refills_the_same_tensors(cls, hyp, new):
    _, ts_, c = _splits(synthetic_n_train=32)
    name = "MLP200MNIST_dropout" if cls is sgd_map.MCdropout else "MLP200MNIST"
    s = cls(hyp, model=tmodels.get_model(name).build(c), train=ts_["train"], device="cpu")
    tensors = dict(s._hyp)
    s._run_epoch()
    s.update_hyp(new)
    assert s.epochs_run == 0 and s._state.step == 0 and not s.burnt_in
    assert float(s._state.momentum.abs().max()) == 0.0
    for k, t in s._hyp.items():
        assert t is tensors[k], k
    key = {"lr0": 0.02, "max_lr": 0.1, "lr_init": 0.02}
    k = next(k for k in key if k in s._hyp)
    assert float(s._hyp[k]) == pytest.approx(key[k])


def test_ravel_is_a_view_of_the_flat_buffer_and_unravel_inverts_it():
    from ursabench_tpu_torch.util import ravel, unraveler

    m = tmodels.get_model("MLP200MNIST").build(10)
    copy_flat = ravel(m)  # parameters in their own storages: a copy
    params, _ = engine.flatten_parameters(m)
    flat = ravel(m)
    assert flat.data_ptr() == params.data_ptr() and torch.equal(flat, copy_flat)
    parts = unraveler(m)(flat * 2)
    for name, p in m.named_parameters():
        assert torch.equal(parts[name], p.detach() * 2), name
    js_, _, c = _splits(synthetic_n_train=32)
    js = jsgd.SGD(SGD_HYP, model=jmodels.get_model("MLP200MNIST").build(c),
                  train=js_["train"])
    start = _start(js)
    perm = flat_permutation(m, start)
    params_from_jax(m, start)
    np.testing.assert_array_equal(ravel(m).numpy(),
                                  np.asarray(jutil.ravel(start["params"]))[perm.numpy()])
