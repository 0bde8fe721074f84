"""``chain_strategy="vmap"`` in ursabench_tpu_torch: C chains as one batched
forward and backward (``engine.ChainForward``) against the chains in turn
(``"scan"``), and against the JAX package's vmapped programs.

The epoch samplers, HMC, the lock-step ESS and the sweep: the same seed
gives the same random streams (permutations, crops, flips, dropout masks,
K1's seeds, HMC's draws, ESS's uniforms) in both strategies, so the chains
agree up to float32 rounding: 2e-6 for the MLPs (the JAX package's own
``test_chain_strategy_scan_matches_vmap``), 1e-5 for PreResNet-8. Against
JAX, the tolerances of the scan parity tests (``test_torch_engine.py``,
``test_torch_samplers.py``). Then the layers under vmap (BatchNorm's
returned statistics, dropout's masks drawn outside) and the ``"auto"``
rule, pinned as ``tests/test_smoke.py`` pins JAX's."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ess import D, MU, PCA_HYP, S1, _buffers, _pca_pair, jax_uniforms
from test_torch_samplers import _assert_module_equals, _chain, _perm, _splits, _start

from ursabench_tpu import models as jmodels
from ursabench_tpu.inference import sgmcmc as jsgmcmc
from ursabench_tpu.ops.ess import elliptical_slice as jax_ess
from ursabench_tpu_torch import inference as tinference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.data.transforms import draw_augment, normalize
from ursabench_tpu_torch.inference import base, engine, hmc, pca_subspace, sgd_map, sgmcmc
from ursabench_tpu_torch.models.common import (BatchNorm2d, Dropout, batch_stats_out,
                                               dropout_generator)
from ursabench_tpu_torch.ops.ess import elliptical_slice, elliptical_slice_chains
from ursabench_tpu_torch.transfer import params_from_jax
from ursabench_tpu_torch.util import make_generator

torch.set_num_threads(1)

SGHMC_HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1,
             "burn_in_epochs": 1}
MCD_HYP = {"lr": 0.05, "epochs": 1, "dropout": 0.2, "lengthscale": 0.01, "num_samples": 2,
           "momentum": 0.9, "weight_decay": 0}
# model, dataset, sampler, hyperparameters, tolerance. PreResNet-8 at lr 0.01:
# a ReLU whose input lies within rounding of zero can fall on the other side
# in a grouped convolution than in a plain one, which moves one element of a
# gradient by up to ~1e-4; lr 0.01 keeps one such flip within the tolerance.
# In float64 at the suite's lr 0.05 the two strategies agree to 1e-12
# (test_vmap_epoch_equals_scan_epoch_in_float64): the float32 gap is rounding
EPOCH_CASES = {
    "MLP200MNIST": ("MNIST", sgmcmc.SGHMC, SGHMC_HYP, 2e-6),
    "PreResNet8": ("CIFAR10", sgmcmc.SGHMC, {**SGHMC_HYP, "lr": 0.01}, 1e-5),
    "MLP200MNIST_dropout": ("MNIST", sgd_map.MCdropout, MCD_HYP, 2e-6),
}
HMC_HYP = {"step_size": 1e-2, "num_samples": 3, "L": 3, "tau": 1.0, "burn": 0, "mass": 0.5,
           "grad_batch": 40}


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _epoch_sampler(name, strategy, chains, **loader):
    dataset, cls, hyp, _ = EPOCH_CASES[name]
    _, ts_, c = _splits(dataset, **loader)
    kw = {"model_name": "MLP200MNIST"} if cls is sgd_map.MCdropout else {}
    model = tmodels.get_model("MLP200MNIST" if kw else name).build(c)
    return cls(hyp, model=model, train=ts_["train"], device="cpu", chains=chains, seed=3,
               chain_strategy=strategy, **kw)


# -- the epoch samplers ----------------------------------------------------------

@pytest.mark.parametrize("chains", [2, 3])
@pytest.mark.parametrize("name", list(EPOCH_CASES))
def test_vmap_epoch_equals_scan_epoch(name, chains):
    """One noisy epoch (three steps; CIFAR with crop and flip) under each
    strategy from the same seed: parameters, momenta, BatchNorm running
    statistics and losses agree."""
    tol = EPOCH_CASES[name][3]
    loader = ({"transform_train": tmodels.get_model(name).transform_train}
              if name == "PreResNet8" else {})
    runs = {}
    for strategy in ("vmap", "scan"):
        s = _epoch_sampler(name, strategy, chains, **loader)
        assert s._resolved_chain_strategy == strategy
        loss = s._run_epoch(noise_on=True)
        runs[strategy] = (s, loss)
    (v, lv), (sc, ls) = runs["vmap"], runs["scan"]
    assert v.train.spec.augments == (name == "PreResNet8")
    np.testing.assert_allclose(v._state.params.numpy(), sc._state.params.numpy(), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(v._state.momentum.numpy(), sc._state.momentum.numpy(), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(lv.numpy(), ls.numpy(), rtol=0, atol=tol)
    assert v._state.step == sc._state.step == 3
    for mv, ms in zip(v.modules, sc.modules):
        for (k, a), (_, b) in zip(mv.named_buffers(), ms.named_buffers()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol, err_msg=k)
    assert float((v._state.params[0] - v._state.params[1]).abs().max()) > 1e-3


def test_vmap_epoch_equals_scan_epoch_in_float64():
    """The PreResNet-8 case of ``test_vmap_epoch_equals_scan_epoch`` at the
    suite's lr 0.05 (three steps, crop and flip, two chains), every chain
    in float64 from the same float32 start, batch plans and crops: the
    strategies agree to 1e-12 (1.6e-14 measured), so the float32 case's lr
    0.01 answers a rounding (a ReLU input within float32 rounding of zero),
    not a defect of the vmap path."""
    loader = {"transform_train": tmodels.get_model("PreResNet8").transform_train}
    _, ts_, c = _splits("CIFAR10", **loader)
    s = sgmcmc.SGHMC({**SGHMC_HYP, "lr": 0.05}, model=tmodels.get_model("PreResNet8").build(c),
                     train=ts_["train"], device="cpu", chains=2, seed=3)
    split = s.train
    idx = torch.stack([engine.epoch_indices(g, split.n, split.batch_size) for g in s._data_gens])
    draws = [draw_augment(g, tuple(idx.shape[1:]), split.spec) for g in s._data_gens]
    aug = tuple(torch.stack([d[j] for d in draws]) for j in range(3))
    images = normalize(s._images, split.spec).double()
    out = {}
    for strategy in ("scan", "vmap"):
        modules = [copy.deepcopy(m).double() for m in s.modules]
        params, grads = engine.flatten_chains(modules)
        state = engine.TrainState(modules[0], params, torch.zeros_like(params), grads,
                                  modules=modules)
        engine.train_steps(state, images, s._labels, idx, spec=split.spec, epoch=0,
                           noise_on=torch.tensor(0.0), hyp=s._hyp, lr_fn=s._LR_FN,
                           update_fn=s._UPDATE_FN, seeds=[1] * idx.shape[1], aug=aug,
                           chain_strategy=strategy)
        assert state.params.dtype == torch.float64 and state.step == 3
        out[strategy] = (state.params, [b for m in modules for b in m.buffers()])
    np.testing.assert_allclose(out["vmap"][0].numpy(), out["scan"][0].numpy(), rtol=0,
                               atol=1e-12)
    for a, b in zip(out["vmap"][1], out["scan"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    start = s._state.params.double()
    assert float((out["vmap"][0] - start).abs().max()) > 1e-3


@pytest.mark.parametrize("name,dataset,alpha,atol", [
    ("MLP200MNIST", "MNIST", 0.1, 1e-5),
    ("PreResNet8", "CIFAR10", 0.5, 1e-4),  # alpha 0.5: test_torch_engine.py says why
])
def test_vmap_epoch_matches_jax_vmap_epoch(name, dataset, alpha, atol):
    """Two chains of SGHMC, one epoch, the noise off, under the JAX
    package's vmapped epoch and the port's, from the same weights over
    JAX's per-chain permutations."""
    js_, ts_, c = _splits(dataset)
    hyp = {**SGHMC_HYP, "alpha": alpha}
    js = jsgmcmc.SGHMC(hyp, model=jmodels.get_model(name).build(c), train=js_["train"],
                       key=jax.random.PRNGKey(4), chains=2, chain_strategy="vmap")
    assert js._epoch_fn._chain_strategy == "vmap"
    start = _start(js)
    perms = [_perm(js._state.key[i], 96) for i in range(2)]
    js._state, loss_j = js._epoch_fn(js._state, jnp.float32(0.0), jnp.float32(0.0),
                                     js._hyp_scalars)
    end = _start(js)

    ts = sgmcmc.SGHMC(hyp, model=tmodels.get_model(name).build(c), train=ts_["train"],
                      device="cpu", chains=2, chain_strategy="vmap")
    for i in range(2):
        params_from_jax(ts.modules[i], _chain(start, i))
    split = ts.train
    idx = torch.from_numpy(np.stack(perms)).view(2, -1, split.batch_size)
    loss_t = engine.train_steps(
        ts._state, ts._images, ts._labels, idx, spec=split.spec, epoch=0,
        noise_on=torch.tensor(0.0), hyp=ts._hyp, lr_fn=ts._LR_FN, update_fn=ts._UPDATE_FN,
        seeds=[1] * idx.shape[1], chain_strategy="vmap")
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=0, atol=atol)
    for i in range(2):
        _assert_module_equals(ts.modules[i], _chain(end, i), name, atol=atol)


def test_vmap_step_lands_gradients_in_the_flat_buffer_without_a_copy(monkeypatch):
    """The step's gradients are the (C, P) buffer the update reads: the
    leaves' ``.grad`` are views of it, and K1's plain version runs once a
    step over all chains."""
    s = _epoch_sampler("MLP200MNIST", "vmap", 3)
    _, leaves, _ = s._state.batched()
    storage = s._state.grads.untyped_storage().data_ptr()
    grads = {k: leaf.grad for k, leaf in leaves.items()}
    assert all(g.untyped_storage().data_ptr() == storage for g in grads.values())
    calls = []
    update = sgmcmc.sghmc_update
    monkeypatch.setattr(sgmcmc, "sghmc_update",
                        lambda p, *a, **k: (calls.append(p.shape), update(p, *a, **k))[1])
    s._run_epoch()
    assert calls == [(3 * 199210,)] * 3
    assert all(leaf.grad is grads[k] for k, leaf in leaves.items())  # added in place
    assert float(s._state.grads.abs().sum(1).min()) > 0  # every chain's row was written


# -- the layers under vmap --------------------------------------------------------

@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_batchnorm_under_vmap_returns_what_the_scan_path_folds(dtype):
    """Under ``batch_stats_out`` and vmap, BatchNorm2d normalizes as
    ``F.batch_norm`` does (within 1e-6 in float32) and returns each row's
    float32 mean and biased variance; folded, they equal the running
    statistics a plain training forward leaves (flax's n/(n-1) fold)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, 5, 4, 4, generator=gen) * 2 + 1
    if dtype is not None:
        x = x.to(dtype)
    layers = [BatchNorm2d(5, dtype=dtype) for _ in range(3)]
    for i, m in enumerate(layers):
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.uniform_(-1, 1, generator=gen)
            m.running_mean.fill_(0.3 * i)
    want = [m(x[i]) for i, m in enumerate(layers)]
    fwd = engine.ChainForward(layers[0])
    params = {"weight": torch.stack([m.weight for m in layers]),
              "bias": torch.stack([m.bias for m in layers])}
    fresh = [BatchNorm2d(5, dtype=dtype) for _ in range(3)]
    for i, m in enumerate(fresh):
        m.running_mean.fill_(0.3 * i)
    got, stats = fwd(params, x, x_batched=True)
    assert len(stats) == 1 and stats[0][0].dtype == torch.float32
    for i in range(3):  # float32: 1e-6; bf16: one rounding of the float32 result
        np.testing.assert_allclose(got[i].to(want[i].dtype).float().detach().numpy(),
                                   want[i].float().detach().numpy(),
                                   rtol=0 if dtype is None else 2 ** -8, atol=1e-6)
    engine.fold_batch_stats([[m] for m in fresh], stats)
    for a, b in zip(fresh, layers):
        np.testing.assert_allclose(a.running_mean.numpy(), b.running_mean.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(a.running_var.numpy(), b.running_var.numpy(), rtol=0,
                                   atol=1e-6)
    with pytest.raises(RuntimeError, match="not called"):
        with batch_stats_out(layers[:1]):
            pass


def test_dropout_masks_drawn_outside_equal_the_generator_draws():
    """``ChainForward.masks`` draws, chain by chain and layer after layer,
    the masks a plain forward with ``dropout_generator`` draws; under vmap
    each row takes its own."""
    model = tmodels.get_model("MLP200MNIST_dropout").build(10)
    x = torch.randn(4, 1, 28, 28, generator=torch.Generator().manual_seed(1))
    fwd = engine.ChainForward(model)
    seeds = [11, 22, 33]
    layers, masks = fwd.masks(x, [make_generator("cpu", s, 5) for s in seeds])
    assert [type(m) for m in layers] == [Dropout, Dropout] and masks[0].shape == (3, 4, 200)
    flat = torch.stack([torch.cat([p.detach().reshape(-1) for p in model.parameters()])] * 3)
    got, _ = fwd(engine.stacked_views(model, flat), x, x_batched=False, layers=layers,
                 masks=masks, masks_batched=True)
    for c, s in enumerate(seeds):
        with dropout_generator(model, make_generator("cpu", s, 5)):
            want = model(x)
        assert torch.equal(got[c], want), c
    assert not torch.equal(masks[0][0], masks[0][1])


# -- HMC ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dataset", [("MLP200MNIST", "MNIST"), ("PreResNet8", "CIFAR10")])
def test_hmc_vmap_equals_scan(name, dataset):
    """HMC x2 chains from one seed: the batched potential and leapfrog give
    every draw's accepts and points of the chains in turn (theta within
    1e-5); PreResNet-8 with eval-mode BatchNorm."""
    _, ts_, c = _splits(dataset)
    runs = {}
    for strategy in ("vmap", "scan"):
        h = hmc.HMC(HMC_HYP, model=tmodels.get_model(name).build(c), train=ts_["train"],
                    device="cpu", chains=2, seed=2, chain_strategy=strategy)
        assert h._resolved_chain_strategy == strategy
        accepts, draw = [], h._draw

        def recorded(theta, ll, draw=draw, accepts=accepts):
            out = draw(theta, ll)
            accepts.append(out[2].tolist())
            return out

        h._draw = recorded
        runs[strategy] = (h.sample(), accepts)
    (ev, av), (es, as_) = runs["vmap"], runs["scan"]
    assert av == as_ and len(av) == 3
    for k in ev.state:
        np.testing.assert_allclose(ev.state[k].numpy(), es.state[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert not torch.equal(ev.member(0)["fc1.weight" if name.startswith("MLP") else
                                        "conv1.weight"],
                           ev.member(1)["fc1.weight" if name.startswith("MLP") else
                                        "conv1.weight"])


def test_hmc_batched_transition_takes_the_chains_draws_in_turn():
    """The batched transition draws chain 0's momentum and uniform, then
    chain 1's: injected as (C, P) and (C,), they reproduce it."""
    _, ts_, c = _splits("MNIST")
    h = hmc.HMC(HMC_HYP, model=tmodels.get_model("MLP200MNIST").build(c), train=ts_["train"],
                device="cpu", chains=2, seed=5, chain_strategy="vmap")
    theta = h._theta0.clone()
    ll = h._initial_ce_sums(theta)
    state = h._gen.get_state()
    out = h._transition(theta, ll)
    h._gen.set_state(state)
    draws = [h._momentum_and_uniform(theta[i]) for i in range(2)]
    again = h._transition(theta, ll, draws=(torch.stack([d[0] for d in draws]),
                                            torch.stack([d[1] for d in draws])))
    assert torch.equal(out[0], again[0]) and torch.equal(out[3], again[3])
    for i in range(2):  # and each row is the one-chain transition
        one = h._transition(theta[i], ll[i], draws=draws[i])
        np.testing.assert_allclose(out[0][i].numpy(), one[0].numpy(), rtol=0, atol=1e-5)
        assert bool(out[2][i]) == bool(one[2])


# -- lock-step ESS -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_lock_step_ess_equals_in_turn_and_jax_vmap(seed):
    """Three chains on a narrow Gaussian likelihood with JAX's per-chain
    uniforms: the lock-step transition lands on each chain's in-turn point
    with the same bracket count, and on JAX's vmapped transition."""
    rng = np.random.default_rng(seed)
    theta0 = (MU + 0.3 * rng.normal(size=(3, D))).astype(np.float32)
    prior = rng.normal(size=(3, D)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    lnpdf = lambda t: -0.5 * ((t - MU) ** 2).sum(-1) / S1 ** 2  # noqa: E731
    uniforms = [jax_uniforms(k) for k in keys]
    got, got_lp, iters = elliptical_slice_chains(torch.from_numpy(theta0),
                                                 torch.from_numpy(prior), lnpdf,
                                                 uniforms=uniforms)
    assert len(set(iters)) > 1  # the chains' brackets close at different proposals
    for c in range(3):
        t, lp, it = elliptical_slice(torch.from_numpy(theta0[c]), torch.from_numpy(prior[c]),
                                     lnpdf, uniforms=uniforms[c])
        assert it == iters[c]
        assert torch.equal(got[c], t) and float(got_lp[c]) == float(lp)
    want, want_lp = jax.vmap(lambda k, t, p: jax_ess(k, t, p, lnpdf))(
        keys, jnp.asarray(theta0), jnp.asarray(prior))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=0, atol=1e-5)


def test_lock_step_ess_max_iters_per_chain():
    """Each chain gives up after max_iters proposals of its own: chain 1's
    slice lies above every proposal, chain 0 accepts at its second."""
    theta0, prior = torch.zeros(2, D), torch.ones(2, D)
    lnpdf = lambda t: torch.where(t[..., 0] > 0.5, 0.0, -1e30)  # noqa: E731
    cur = torch.tensor([-1.0, 1.0])
    uniforms = [[0.5, 0.05] + [0.05] * 6, [0.5] * 8]
    got, lp, iters = elliptical_slice_chains(theta0, prior, lnpdf, cur, max_iters=4,
                                             uniforms=uniforms)
    assert iters == [2, 4]
    for c in range(2):
        t, v, it = elliptical_slice(theta0[c], prior[c], lnpdf, cur[c], max_iters=4,
                                    uniforms=uniforms[c])
        assert it == iters[c] and torch.equal(got[c], t) and float(lp[c]) == float(v)
    assert torch.equal(got[1], theta0[1]) and float(lp[1]) == 1.0


def test_pca_lnpdf_chains_and_lock_step_draw_match_jax_vmap():
    """The batched tempered log density equals the per-chain one and JAX's;
    one lock-step draw with JAX's per-chain uniforms lands on JAX's
    vmapped transition; the SWA's trained statistics are never written."""
    jp, tp, _ = _pca_pair()
    jp.chain_strategy = "vmap"
    jp._lnpdf_jit, jp._ess_transition = jp._build_lnpdf()
    assert jp._resolved_chain_strategy == "vmap"
    trained = _buffers(tp.module)
    thetas = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    want = np.asarray(jp._lnpdf_jit(jnp.asarray(thetas)))
    got = tp.lnpdf_chains(torch.from_numpy(thetas)).numpy()
    each = torch.stack([tp.lnpdf(torch.from_numpy(t)) for t in thetas]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, each, rtol=0, atol=1e-5)
    prior = np.random.default_rng(2).normal(size=(2, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    want_t, want_lp = jp._ess_transition(keys, jnp.asarray(thetas), jnp.asarray(prior),
                                         jnp.asarray(want))
    t, lp, _ = elliptical_slice_chains(torch.from_numpy(thetas), torch.from_numpy(prior),
                                       tp.lnpdf_chains, torch.from_numpy(want.copy()),
                                       uniforms=[jax_uniforms(k) for k in keys])
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=0, atol=1e-5)
    for k, v in _buffers(tp.module).items():
        assert torch.equal(v, trained[k]), k


def test_pca_sampler_lock_step_equals_in_turn():
    """The PCA sampler from one seed, 3 chains at a temperature that takes
    several brackets a draw: lock step and in turn give the same points and
    the same per-chain bracket counts at every draw."""
    _, ts_, c = _splits("CIFAR10", synthetic_n_train=90)
    runs = {}
    for strategy in ("vmap", "scan"):
        tp = pca_subspace.PCASubspaceSampler(
            {**PCA_HYP, "num_samples": 3, "temperature": 2.0},
            model=tmodels.get_model("PreResNet8").build(c), train=ts_["train"], device="cpu",
            chains=3, seed=4, chain_strategy=strategy)
        assert tp._resolved_chain_strategy == strategy
        ens = tp.sample()
        runs[strategy] = (ens, tp.bracket_iters)
    (ev, bv), (es, bs) = runs["vmap"], runs["scan"]
    assert bv == bs and max(max(b) for b in bs) > 1
    for k in ev.state:
        np.testing.assert_allclose(ev.state[k].numpy(), es.state[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


# -- the sweep -------------------------------------------------------------------------

@pytest.mark.parametrize("method,hyps", [
    ("SGHMC", [SGHMC_HYP, {**SGHMC_HYP, "lr": 0.02, "prior_std": 0.5, "alpha": 0.3}]),
    ("SGD", [{"lr": 0.05, "epochs": 1, "momentum": 0.9, "weight_decay": 5e-4},
             {"lr": 0.1, "epochs": 1, "momentum": 0.5, "weight_decay": 1e-3}]),
])
def test_vmap_sweep_equals_scan_sweep(method, hyps):
    """A MethodSweep under vmap (the configs as one batched forward with
    their (K,) hyperparameters) gives the scan sweep's ensembles."""
    _, ts_, c = _splits("MNIST", synthetic_n_train=64)
    out = {}
    for strategy in ("vmap", "scan"):
        sw = tinference.MethodSweep(hyps, model=tmodels.get_model("MLP200MNIST").build(c),
                                    train=ts_["train"], method=method, chain_strategy=strategy,
                                    device="cpu", seed=2)
        assert sw.sampler._resolved_chain_strategy == strategy
        out[strategy] = sw.sample()
    for a, b in zip(out["vmap"], out["scan"]):
        assert a.num_members == b.num_members
        for k in a.state:
            np.testing.assert_allclose(a.state[k].numpy(), b.state[k].numpy(), rtol=0,
                                       atol=2e-6, err_msg=k)


# -- resume and the rule -----------------------------------------------------------

def test_lock_step_pca_resume_equals_uninterrupted(tmp_path):
    """A lock-step PCA-ESS run killed after 2 of 4 draws and resumed from its
    checkpoint (the chains' own generators in it) ends where an
    uninterrupted run does."""
    _, ts_, c = _splits("MNIST", synthetic_n_train=64)
    hyp = {**PCA_HYP, "num_samples": 4, "rank": 2}

    def make():
        return pca_subspace.PCASubspaceSampler(
            hyp, model=tmodels.get_model("MLP200MNIST").build(c), train=ts_["train"],
            device="cpu", chains=2, seed=6, chain_strategy="vmap")

    want = make().sample()
    path = str(tmp_path / "pca.npz")
    first = make()
    first.enable_auto_checkpoint(path, every_epochs=2)
    first.sample(num_samples=2)
    resumed = make()
    assert resumed.enable_auto_checkpoint(path, every_epochs=2)
    got = resumed.sample()
    for k in want.state:
        np.testing.assert_allclose(got.state[k].numpy(), want.state[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_auto_rule():
    """``"auto"`` by the card's measurements (``base.resolve_chain_strategy``):
    vmap for the MLPs and LeNet5 from 2 chains, for PreResNet-20 from 8,
    never for WideResNet-28x10; one chain records no strategy; unknown
    strategies raise."""
    mnist, cifar = (28, 28, 1), (32, 32, 3)
    build = lambda name, **kw: tmodels.get_model(name).build(10, **kw)  # noqa: E731
    want = {("MLP200MNIST", mnist): "vmap vmap vmap",
            ("MLP200MNIST_dropout", mnist): "vmap vmap vmap",
            ("LeNet5MNIST", mnist): "vmap vmap vmap",
            ("PreResNet8", cifar): "scan scan vmap",
            ("PreResNet20", cifar): "scan scan vmap"}
    for (name, shape), strategies in want.items():
        got = [base.resolve_chain_strategy("auto", build(name), shape, c) for c in (2, 4, 8)]
        assert " ".join(got) == strategies, name
    with torch.device("meta"):
        wrn = build("WideResNet28x10", dtype=torch.bfloat16)
    assert base.image_flops(wrn, cifar) == pytest.approx(11.9e9, rel=0.01)
    assert base.resolve_chain_strategy("auto", wrn, cifar, 8) == "scan"
    assert base.image_flops(build("PreResNet20"), cifar) == pytest.approx(81.6e6, rel=0.01)
    for strategy in ("scan", "vmap"):
        assert base.resolve_chain_strategy(strategy, None, mnist) == strategy
    with pytest.raises(ValueError, match="chain_strategy"):
        base.resolve_chain_strategy("lockstep", None, mnist)
    _, ts_, c = _splits("MNIST", synthetic_n_train=32)
    one = sgmcmc.SGHMC(SGHMC_HYP, model=build("MLP200MNIST"), train=ts_["train"],
                       device="cpu", chain_strategy="vmap")
    assert one._resolved_chain_strategy is None
    two = sgmcmc.SGHMC(SGHMC_HYP, model=build("MLP200MNIST"), train=ts_["train"],
                       device="cpu", chains=2)
    assert two._resolved_chain_strategy == "vmap"
