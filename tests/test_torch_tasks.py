"""Metrics, the BMA pass and the Prediction task of ursabench_tpu_torch
against the JAX package: the metric formulas on identical probabilities,
then Prediction("ALL") on a 2-member PreResNet-8 ensemble transferred from
flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu import tasks as jtasks
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu.inference.ensemble import Ensemble as JEnsemble
from ursabench_tpu.ops import metrics as JM
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import tasks as ttasks
from ursabench_tpu_torch import util as tutil
from ursabench_tpu_torch.inference.ensemble import Ensemble as TEnsemble
from ursabench_tpu_torch.ops import metrics as TM
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

CRITERIA = ["entropy", "confidence", "model_uncertainty"]


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _probs(seed, n=300, c=10, quantize=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, c)) * 2.0
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    if quantize:  # coarse probabilities: many tied scores
        p = np.round(p, 1) + 1e-3
        p = p / p.sum(1, keepdims=True)
    targets = rng.integers(0, c, n)
    edu = rng.uniform(0.0, 0.5, n)
    return p.astype(np.float32), targets, edu.astype(np.float32)


@pytest.mark.parametrize("quantize", [False, True])
def test_metrics_match_jax(quantize):
    """With quantized probabilities, rows that are permutations of each
    other tie in confidence exactly, but their entropies tie only up to the
    summation order, which differs between the two packages: the entropy
    criteria are compared on the unquantized probabilities only."""
    p, t, edu = _probs(0, quantize=quantize)
    pj, tj, ej = jnp.asarray(p), jnp.asarray(t, jnp.int32), jnp.asarray(edu)
    pt, tt, et = torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(edu)
    for name in ("error_rate", "nll", "brier_score", "ece"):
        got = float(getattr(TM, name)(pt, tt))
        want = float(getattr(JM, name)(pj, tj))
        assert got == pytest.approx(want, abs=1e-6), name
    for crit in ["confidence"] if quantize else CRITERIA:
        for name in ("misclass_auroc", "misclass_aucpr"):
            got = float(getattr(TM, name)(pt, tt, crit, et))
            want = float(getattr(JM, name)(pj, tj, crit, ej))
            assert got == pytest.approx(want, abs=1e-6), (name, crit)


def test_rank_metrics_match_jax_on_ties_and_degenerate_labels():
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 200).astype(np.float32)
    scores = np.round(rng.normal(size=200), 1).astype(np.float32)  # many ties
    for fn in ("auroc", "average_precision"):
        got = float(getattr(TM, fn)(torch.from_numpy(labels), torch.from_numpy(scores)))
        want = float(getattr(JM, fn)(jnp.asarray(labels), jnp.asarray(scores)))
        assert got == pytest.approx(want, abs=1e-6), fn
    ones = torch.ones(10)
    assert np.isnan(float(TM.auroc(ones, torch.arange(10.0))))


def test_util_helpers_match_jax():
    from ursabench_tpu import util as jutil

    p, _, _ = _probs(2, n=20)
    logits = np.random.default_rng(3).normal(size=(4, 20, 10)).astype(np.float32)
    np.testing.assert_allclose(tutil.central_smoothing(torch.from_numpy(p)).numpy(),
                               np.asarray(jutil.central_smoothing(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tutil.predictive_entropy(torch.from_numpy(p)).numpy(),
                               np.asarray(jutil.predictive_entropy(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tutil.softmax_probs(torch.from_numpy(logits)).numpy(),
                               np.asarray(jutil.softmax_probs(jnp.asarray(logits))),
                               rtol=1e-6, atol=1e-7)
    assert tutil.derive_seed(7, "x") == tutil.derive_seed(7, "x") != tutil.derive_seed(7, "y")
    assert 0 <= tutil.derive_seed(7, "x") < 2 ** 63


def _sharpen(variables, scale=20.0):
    """Scale the head so the members' predictions spread out: near-uniform
    predictions of a fresh network leave near-tied uncertainty scores whose
    order float rounding decides."""
    params = dict(variables["params"])
    params["Dense_0"] = {"kernel": params["Dense_0"]["kernel"] * scale,
                         "bias": params["Dense_0"]["bias"]}
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _ensembles(num_classes, members=2):
    jm = jmodels.get_model("PreResNet8").build(num_classes)
    variables = [_sharpen(jinit(jm, jax.random.PRNGKey(k), (32, 32, 3)))
                 for k in range(members)]
    jens = JEnsemble.from_list(jm, variables)
    tm = tmodels.get_model("PreResNet8").build(num_classes)
    states = [
        {k: v.clone() for k, v in params_from_jax(
            tmodels.get_model("PreResNet8").build(num_classes),
            jax.tree.map(np.array, v)).state_dict().items()}
        for v in variables
    ]
    return jens, TEnsemble.from_list(tm, states)


def test_prediction_all_metrics_match_jax():
    # 70 test images at batch 32: the last batch is padded and sliced off
    kw = dict(batch_size=32, use_validation=False, synthetic_n_train=32,
              synthetic_n_test=70)
    sj, c = jdata.loaders("CIFAR10", None, **kw)
    st, _ = tdata.loaders("CIFAR10", None, **kw)
    jens, tens = _ensembles(c)
    jt = jtasks.Prediction({"in_distribution_test": sj["test"]}, c, metric_list="ALL")
    tt = ttasks.Prediction({"in_distribution_test": st["test"]}, c, metric_list="ALL")
    jt.update_statistics(jens, output_performance=False)
    tt.update_statistics(tens, output_performance=False)
    np.testing.assert_allclose(tt.ensemble_proba, jt.ensemble_proba, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.expected_data_uncertainty,
                               jt.expected_data_uncertainty, rtol=1e-5, atol=1e-5)
    want, got = jt.get_performance_metrics(), tt.get_performance_metrics()
    assert list(got) == tt.supported_metric_list
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-5), (k, got[k], want[k])
    single = ttasks.Prediction({"in_distribution_test": st["test"]}, c,
                               metric_list=["nll"])
    assert single.update_statistics(tens) == pytest.approx(want["nll"], abs=1e-5)
    with pytest.raises(ValueError):
        ttasks.Prediction({"in_distribution_test": st["test"]}, c, metric_list=["acc"])


def test_accumulate_split_smoothed_matches_jax():
    from ursabench_tpu.tasks.base import accumulate_split as jacc

    kw = dict(batch_size=16, use_validation=False, synthetic_n_train=16,
              synthetic_n_test=20)
    sj, c = jdata.loaders("CIFAR10", None, **kw)
    st, _ = tdata.loaders("CIFAR10", None, **kw)
    jens, tens = _ensembles(c)
    pj, ej = jacc(jens, sj["test"], smooth_probs=True)
    pt, et = ttasks.accumulate_split(tens, st["test"], smooth_probs=True)
    np.testing.assert_allclose(pt, pj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(et, ej, rtol=1e-5, atol=1e-5)
    assert tens.module.training  # the pass restores the module's mode
