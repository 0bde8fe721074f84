"""Elliptical slice sampling and the PCA-subspace sampler of
ursabench_tpu_torch against the JAX package's.

``elliptical_slice`` takes the uniforms that JAX's key splits draw (the
slice height's, the first angle's, then one per proposal) and must land on
JAX's point, log density and bracket count. The PCA sampler's tempered log
density and one ESS draw on PreResNet-8 run over 90 images in batches of
32, so the last batch is filled up with image 0, which enters train-mode
BatchNorm's statistics in both packages. Flat vectors are compared through
``flat_permutation``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_samplers import _as_numpy, _splits, flat_permutation

from ursabench_tpu import models as jmodels
from ursabench_tpu import util as jutil
from ursabench_tpu.inference import pca_subspace as jpca
from ursabench_tpu.inference.subspaces import SubspaceModel as JSubspaceModel
from ursabench_tpu.ops.ess import elliptical_slice as jax_ess
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.inference import pca_subspace
from ursabench_tpu_torch.ops.ess import elliptical_slice
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

D, MU, S1 = 4, 0.8, 0.2  # a narrow likelihood: several brackets a transition
PCA_HYP = {"swag_lr": 0.01, "swag_wd": 1e-4, "lr_init": 0.02, "num_samples": 2,
           "swag_momentum": 0.9, "swag_burn_in_epochs": 1, "num_swag_iterates": 3, "rank": 3,
           "max_rank": 3, "temperature": 100.0, "prior_std": 1.0}


def jax_uniforms(key, count=80):
    """The uniforms ``ursabench_tpu.ops.ess.elliptical_slice`` draws from
    ``key``, in the order the port consumes them."""
    k_h, k_phi, key = jax.random.split(key, 3)
    out = [jax.random.uniform(k_h), jax.random.uniform(k_phi)]
    for _ in range(count):
        key, k_u = jax.random.split(key)
        out.append(jax.random.uniform(k_u))
    return [float(u) for u in out]


def _gauss_lnpdf(theta):
    return -0.5 * ((theta - MU) ** 2).sum() / S1 ** 2


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_elliptical_slice_matches_jax(seed):
    rng = np.random.default_rng(seed)
    theta0 = (MU + 0.3 * rng.normal(size=D)).astype(np.float32)  # log densities of O(1)
    prior = rng.normal(size=D).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want, want_lp = jax_ess(key, jnp.asarray(theta0), jnp.asarray(prior), _gauss_lnpdf)
    got, got_lp, iters = elliptical_slice(torch.from_numpy(theta0), torch.from_numpy(prior),
                                          _gauss_lnpdf, uniforms=jax_uniforms(key))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert float(got_lp) == pytest.approx(float(want_lp), abs=1e-5)
    # JAX's bracket count: capped at `iters` it accepts, at `iters - 1` it stays put
    capped, _ = jax_ess(key, jnp.asarray(theta0), jnp.asarray(prior), _gauss_lnpdf,
                        max_iters=iters)
    np.testing.assert_array_equal(np.asarray(capped), np.asarray(want))
    if iters > 1:
        short, _ = jax_ess(key, jnp.asarray(theta0), jnp.asarray(prior), _gauss_lnpdf,
                           max_iters=iters - 1)
        np.testing.assert_array_equal(np.asarray(short), theta0)


def test_elliptical_slice_gives_up_after_max_iters():
    theta0, prior = torch.zeros(D), torch.ones(D)
    cur = torch.tensor(0.0)
    got, lp, iters = elliptical_slice(theta0, prior, lambda t: torch.tensor(-1e30), cur,
                                      max_iters=5, uniforms=[0.5] * 7)
    assert iters == 5 and got is theta0 and lp is cur
    with pytest.raises(ValueError, match="uniforms"):
        elliptical_slice(theta0, prior, lambda t: torch.tensor(-1e30), cur, uniforms=[0.5] * 3)


def test_ess_samples_gaussian_posterior():
    """Port twin of tests/test_mcmc_correctness.py's: prior N(0, s0^2),
    likelihood N(mu, s1^2) per dimension; 3000 transitions from the
    generator reproduce the posterior's moments within Monte-Carlo error."""
    d, s0, s1, mu = 4, 1.0, 0.7, 0.8
    post_var = 1.0 / (1.0 / s0 ** 2 + 1.0 / s1 ** 2)
    post_mean = post_var * mu / s1 ** 2
    gen = torch.Generator().manual_seed(0)

    def lnpdf(theta):
        return -0.5 * torch.sum((theta - mu) ** 2) / s1 ** 2

    theta = torch.zeros(d)
    cur = lnpdf(theta)
    draws = []
    for _ in range(3000):
        prior = s0 * torch.randn(d, generator=gen)
        theta, cur, _ = elliptical_slice(theta, prior, lnpdf, cur, generator=gen)
        draws.append(theta)
    draws = torch.stack(draws)[500:].numpy()
    assert draws.mean() == pytest.approx(post_mean, abs=0.08)
    assert draws.var() == pytest.approx(post_var, rel=0.2)


def _pca_pair(chains=2):
    """A JAX and a port PCA sampler on PreResNet-8 / 90 CIFAR-10 images
    (batch 32) with one subspace: the JAX init's weights as the mean, a
    random rank-3 cov_factor, random trained BatchNorm statistics."""
    js_, ts_, c = _splits("CIFAR10", synthetic_n_train=90)
    jp = jpca.PCASubspaceSampler(PCA_HYP, model=jmodels.get_model("PreResNet8").build(c),
                                 train=js_["train"], key=jax.random.PRNGKey(0), chains=chains)
    tp = pca_subspace.PCASubspaceSampler(
        PCA_HYP, model=tmodels.get_model("PreResNet8").build(c), train=ts_["train"],
        device="cpu", chains=chains)
    rng = np.random.default_rng(0)
    params = jp.swa._state.params
    bstats = jax.tree.map(lambda x: (np.abs(rng.normal(size=x.shape)) + 0.5).astype(np.float32),
                          _as_numpy(jp.swa._state.batch_stats))
    variables = {"params": _as_numpy(params), "batch_stats": bstats}
    perm = flat_permutation(tp.module, variables).numpy()
    mean = np.asarray(jutil.ravel(params))
    cov = (0.05 * rng.normal(size=(3, mean.size)) * np.abs(mean).mean()).astype(np.float32)
    jp.subspace = JSubspaceModel(jnp.asarray(mean), jnp.asarray(cov))
    jp.swa._state = jp.swa._state._replace(batch_stats=jax.tree.map(jnp.asarray, bstats))
    jp._lnpdf_jit, jp._ess_transition = jp._build_lnpdf()
    params_from_jax(tp.module, variables)
    tp._set_subspace(torch.from_numpy(mean[perm]), torch.from_numpy(cov[:, perm]))
    return jp, tp, perm


def _buffers(module):
    return {k: v.clone() for k, v in module.named_buffers()}


def test_pca_lnpdf_and_one_draw_match_jax():
    jp, tp, _ = _pca_pair()
    trained = _buffers(tp.module)
    thetas = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    want = np.asarray(jp._lnpdf_jit(jnp.asarray(thetas)))
    got = torch.stack([tp.lnpdf(torch.from_numpy(t)) for t in thetas]).numpy()
    assert np.abs(want).min() > 0.5  # O(1) values: the tolerance is a real one
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    prior = np.random.default_rng(2).normal(size=(2, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    want_t, want_lp = jp._ess_transition(keys, jnp.asarray(thetas), jnp.asarray(prior),
                                         jnp.asarray(want))
    for c in range(2):
        t, lp, _ = elliptical_slice(torch.from_numpy(thetas[c]), torch.from_numpy(prior[c]),
                                    tp.lnpdf, torch.tensor(want[c]),
                                    uniforms=jax_uniforms(keys[c]))
        np.testing.assert_allclose(t.numpy(), np.asarray(want_t)[c], rtol=0, atol=1e-5)
        assert float(lp) == pytest.approx(float(want_lp[c]), abs=1e-5)
    for k, v in _buffers(tp.module).items():  # the trained statistics: never written
        assert torch.equal(v, trained[k]), k


def test_pca_project_draw_with_bn_refresh_matches_jax():
    jp, tp, perm = _pca_pair()
    thetas = np.random.default_rng(3).normal(size=(2, 3)).astype(np.float32)
    params, bstats = jp._project_draw(jnp.asarray(thetas), update_bn=True)
    got = tp._project_draw(torch.from_numpy(thetas), update_bn=True)
    for c in range(2):
        want = params_from_jax(tmodels.get_model("PreResNet8").build(10), _as_numpy(
            {"params": jax.tree.map(lambda x: x[c], params),
             "batch_stats": jax.tree.map(lambda x: x[c], bstats)})).state_dict()
        for k in want:
            np.testing.assert_allclose(got[k][c].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("chains", [1, 2])
def test_pca_sample_members_and_untouched_statistics(chains):
    """num_samples draws of `chains` members each, draw-major; every chain
    moves; only the last draw's BatchNorm statistics are refreshed."""
    _, ts_, c = _splits("CIFAR10", synthetic_n_train=90)
    tp = pca_subspace.PCASubspaceSampler(
        {**PCA_HYP, "num_samples": 3}, model=tmodels.get_model("PreResNet8").build(c),
        train=ts_["train"], device="cpu", chains=chains, seed=4)
    seen = []
    lnpdf = tp.lnpdf
    tp.lnpdf = lambda t: (seen.append(_buffers(tp.module)), lnpdf(t))[1]
    ens = tp.sample()
    assert ens.num_members == 3 * chains and tp.subspace.rank == 3
    assert len(tp.bracket_iters) == 3 and all(len(b) == chains for b in tp.bracket_iters)
    assert len(seen) == sum(map(sum, tp.bracket_iters)) + chains
    trained = _buffers(tp.module)
    for snap in seen:
        for k, v in snap.items():
            assert torch.equal(v, trained[k]), k
    name = "bn.running_var"
    for i in range(3 * chains):
        refreshed = i >= 2 * chains
        assert torch.equal(ens.member(i)[name], trained[name]) != refreshed, i
    w = [ens.member(i)["conv1.weight"] for i in range(3 * chains)]
    assert not torch.equal(w[0], w[-1])
