"""The distilled tasks and the distillation trainer of ursabench_tpu_torch
against the JAX package's: PredictionDistilled and OODDetectionDistilled
on one pair transferred from flax, and ``_train_regressor``'s Adam epochs
given the permutations JAX drew; then distillation end to end on the CPU."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu import tasks as jtasks
from ursabench_tpu.inference import distill as jdistill
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import inference as tinference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import tasks as ttasks
from ursabench_tpu_torch.inference import distill as tdistill
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

SHAPE = (28, 28, 1)
LR = 1e-4
LOADER = dict(batch_size=32, use_validation=False, synthetic_n_train=100,
              synthetic_n_test=70)


class EntropyHead(fnn.Module):
    """The flax head of tests/test_tasks.py."""

    @fnn.compact
    def __call__(self, x, train=False):
        x = x.reshape((x.shape[0], -1))
        return fnn.Dense(1)(fnn.tanh(fnn.Dense(32)(x)))


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _np(tree):
    return jax.tree.map(np.array, tree)


def _loaders(dataset):
    sj, c = jdata.loaders(dataset, None, **LOADER)
    st, _ = tdata.loaders(dataset, None, **LOADER)
    return sj, st, c


def _torch_state(module, variables):
    return {k: v.clone() for k, v in params_from_jax(module, _np(variables)).state_dict().items()}


def _pairs(c):
    jm, jh = jmodels.get_model("MLP200MNIST").build(c), EntropyHead()
    pv = jinit(jm, jax.random.PRNGKey(4), SHAPE)
    pv = {"params": {**pv["params"], "Dense_2": {
        "kernel": pv["params"]["Dense_2"]["kernel"] * 8.0,
        "bias": pv["params"]["Dense_2"]["bias"]}}}
    hv = jh.init(jax.random.PRNGKey(5), np.zeros((1,) + SHAPE, np.float32))
    jpair = jtasks.DistilledPair(pred_module=jm, pred_variables=pv, unc_module=jh,
                                 unc_variables=hv)
    tm, th = tmodels.get_model("MLP200MNIST").build(c), tdistill.EntropyHead(784)
    tpair = ttasks.DistilledPair(tm, _torch_state(tm, pv), th, _torch_state(th, hv))
    return jpair, tpair


def test_distilled_tasks_match_jax():
    sj, st, c = _loaders("MNIST")
    jpair, tpair = _pairs(c)
    jt = jtasks.PredictionDistilled({"in_distribution_test": sj["test"]}, c, metric_list="ALL")
    tt = ttasks.PredictionDistilled({"in_distribution_test": st["test"]}, c, metric_list="ALL")
    jt.update_statistics(jpair, output_performance=False)
    tt.update_statistics(tpair, output_performance=False)
    assert tt.num_samples_collected == jt.num_samples_collected == 1
    np.testing.assert_allclose(tt.ensemble_proba, jt.ensemble_proba, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.expected_data_uncertainty, jt.expected_data_uncertainty,
                               rtol=1e-5, atol=1e-5)
    want, got = jt.get_performance_metrics(), tt.get_performance_metrics()
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-5), k

    oj, ot, _ = _loaders("KMNIST")
    jo = jtasks.OODDetectionDistilled({"in_distribution_test": sj["test"],
                                       "out_distribution_test": oj["test"]}, c)
    to = ttasks.OODDetectionDistilled({"in_distribution_test": st["test"],
                                       "out_distribution_test": ot["test"]}, c)
    want = jo.update_statistics(jpair, output_performance=True)
    got = to.update_statistics(tpair, output_performance=True)
    for k in ("in_proba", "out_proba", "in_data_unc", "out_data_unc"):
        np.testing.assert_allclose(getattr(to, k), getattr(jo, k), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in want:
        assert 0.0 <= got[k] <= 1.0
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    with pytest.raises(TypeError):
        to.update_statistics(object())
    with pytest.raises(TypeError):
        tt.update_statistics(object())


def _jax_perms(key, n, epochs):
    """The epochs' permutations, rebuilt from the key as distill.py's
    epoch_impl splits it."""
    perms = []
    for _ in range(epochs):
        key, k_perm = jax.random.split(key)
        perms.append(torch.from_numpy(np.array(jax.random.permutation(k_perm, n))))
    return perms


@pytest.mark.parametrize("loss_kind", ["soft_ce", "mse"])
def test_train_regressor_matches_jax(loss_kind):
    """Two epochs of Adam from the same weights over the same permutations
    (100 images at batch 32: three steps an epoch, the tail dropped). Adam
    moves every weight by about lr a step whatever its gradient's size, so
    an element whose gradient is float noise moves by up to lr either way:
    lr 1e-4 keeps six steps of that inside the 1e-4 bar."""
    sj, st, c = _loaders("MNIST")
    rng = np.random.default_rng(0)
    if loss_kind == "soft_ce":
        jm, tm = jmodels.get_model("MLP200MNIST").build(c), tmodels.get_model(
            "MLP200MNIST").build(c)
        logits = rng.normal(size=(100, c))
        targets = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    else:
        jm, tm = EntropyHead(), tdistill.EntropyHead(784)
        targets = rng.normal(size=100).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jdistill._train_regressor(jm, sj["train"], jnp.asarray(targets), loss_kind, 2, LR,
                                     key)
    params_from_jax(tm, _np(jinit(jm, key, SHAPE)))
    got = tdistill._fit(tm, st["train"], torch.from_numpy(targets), loss_kind, LR,
                        _jax_perms(key, 100, 2))
    fresh = lambda: type(tm)(**({"input_dim": 784} if loss_kind == "mse" else  # noqa: E731
                                {"hidden_size": 200, "input_dim": 784, "num_classes": c}))
    expected = _torch_state(fresh(), want)
    assert set(got) == set(expected)
    for k in expected:
        np.testing.assert_allclose(got[k].numpy(), expected[k].numpy(), rtol=0, atol=1e-4,
                                   err_msg=k)
    moved = max(float((got[k] - v).abs().max())
                for k, v in _torch_state(fresh(), jinit(jm, key, SHAPE)).items())
    assert moved > 2 * LR  # the weights did train


def test_distillation_end_to_end_on_cpu():
    """As tests/test_tasks.py::test_distillation_end_to_end: an SGLD
    ensemble on near-separable MNIST, distilled onto MLP200MNIST and a small
    head; the distilled error within 0.2 of the ensemble's."""
    splits, c = tdata.loaders("MNIST", None, batch_size=32, use_validation=False,
                              synthetic_n_train=128, synthetic_n_test=64,
                              difficulty={"separation": 25.0, "label_noise": 0.0})
    hyp = {"lr": 0.03, "prior_std": 1.0, "num_samples": 4, "burn_in_epochs": 3}
    ens = tinference.SGLD(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                          train=splits["train"], seed=0, device="cpu").sample()
    pair = tinference.distill_ensemble(ens, splits["train"],
                                       tmodels.get_model("MLP200MNIST").build(c),
                                       tinference.EntropyHead(784), epochs=15, lr=2e-3,
                                       seed=0, device="cpu")
    pred = ttasks.PredictionDistilled({"in_distribution_test": splits["test"]}, c,
                                      metric_list=["error_rate", "nll"])
    pred.update_statistics(pair, output_performance=False)
    m = pred.get_performance_metrics()
    full = ttasks.Prediction({"in_distribution_test": splits["test"]}, c,
                             metric_list=["error_rate"])
    full.update_statistics(ens, output_performance=False)
    assert m["error_rate"] <= full.get_performance_metrics()["error_rate"] + 0.2
    assert np.isfinite(m["nll"])
    ood, _ = tdata.loaders("KMNIST", None, batch_size=32, use_validation=False,
                           synthetic_n_train=8, synthetic_n_test=64)
    mo = ttasks.OODDetectionDistilled({"in_distribution_test": splits["test"],
                                       "out_distribution_test": ood["test"]}, c
                                      ).update_statistics(pair, output_performance=True)
    assert all(0.0 <= v <= 1.0 for v in mo.values())


def test_distill_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    splits, c = tdata.loaders("MNIST", None, batch_size=8, use_validation=False,
                              synthetic_n_train=16, synthetic_n_test=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinference.distill_ensemble(None, splits["train"],
                                    tmodels.get_model("MLP200MNIST").build(c),
                                    tinference.EntropyHead(784))
