"""OODDetection and Decision of ursabench_tpu_torch against the JAX
package's: the metrics given the JAX task's own accumulators, then the
whole task through the forward pass on one ensemble transferred from flax
(MLP200MNIST on MNIST against FashionMNIST; PreResNet-8 on CIFAR-10 against
STL-10 and SVHN), and the cost matrices."""

import jax
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu import tasks as jtasks
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu.inference.ensemble import Ensemble as JEnsemble
from ursabench_tpu.tasks import decision as jdecision
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import tasks as ttasks
from ursabench_tpu_torch.inference.ensemble import Ensemble as TEnsemble
from ursabench_tpu_torch.tasks import decision as tdecision
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

# dataset -> (model, image shape, the OOD pairings)
CASES = {"MNIST": ("MLP200MNIST", (28, 28, 1), ["FashionMNIST"]),
         "CIFAR10": ("PreResNet8", (32, 32, 3), ["STL10", "SVHN"])}


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _sharpen(variables, head, scale):
    """Scale the head so the members' predictions spread out, away from
    the near-ties of a fresh network."""
    params = dict(variables["params"])
    params[head] = {"kernel": params[head]["kernel"] * scale, "bias": params[head]["bias"]}
    return {**variables, "params": params}


def _ensembles(dataset, num_classes, members=2):
    name, shape, _ = CASES[dataset]
    jm = jmodels.get_model(name).build(num_classes)
    head, scale = ("Dense_2", 8.0) if name.startswith("MLP") else ("Dense_0", 20.0)
    variables = [_sharpen(jinit(jm, jax.random.PRNGKey(10 + k), shape), head, scale)
                 for k in range(members)]
    states = [{k: v.clone() for k, v in params_from_jax(
        tmodels.get_model(name).build(num_classes), jax.tree.map(np.array, v)
    ).state_dict().items()} for v in variables]
    return (JEnsemble.from_list(jm, variables),
            TEnsemble.from_list(tmodels.get_model(name).build(num_classes), states))


def _splits(dataset, n_test=70):
    kw = dict(batch_size=32, use_validation=False, synthetic_n_train=8,
              synthetic_n_test=n_test)
    sj, c = jdata.loaders(dataset, None, **kw)
    st, _ = tdata.loaders(dataset, None, **kw)
    return sj["test"], st["test"], c


@pytest.mark.parametrize("name", ["MNIST", "CIFAR10", "CIFAR100"])
def test_cost_matrices_equal_jax(name):
    k = 100 if name == "CIFAR100" else 10
    fn = {"MNIST": "mnist_cost", "CIFAR10": "cifar10_cost", "CIFAR100": "cifar100_cost"}[name]
    got, want = getattr(tdecision, fn)(k), getattr(jdecision, fn)(k)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    costly = {"MNIST": [3, 7], "CIFAR10": [0, 1, 8, 9], "CIFAR100": [58, 69, 85]}[name]
    col = next(j for j in range(k) if j not in costly)
    assert sorted(np.where(got[:, col] > 0.1)[0].tolist()) == costly
    y, d = np.array([3, 7, 0, 1]), np.array([3, 0, 0, 2])
    assert tdecision.decision_cost(d, y, got) == jdecision.decision_cost(d, y, want)


def test_decision_without_a_cost_matrix_raises():
    _, st, c = _splits("CIFAR10", 8)
    st.dataset_name = "SVHN"
    with pytest.raises(NotImplementedError, match="SVHN"):
        ttasks.Decision({"decision_data_test": st}, c)
    explicit = ttasks.Decision({"decision_data_test": st}, c, cost_mat=np.eye(c))
    assert explicit.cost_mat.shape == (c, c)


@pytest.mark.parametrize("dataset", ["MNIST", "CIFAR10"])
def test_metrics_match_jax_given_its_accumulators(dataset):
    """The port's tasks fed the JAX tasks' accumulators compute the same
    AUROCs (float32, as the JAX package) and the same cost within 1e-6."""
    sj, st, c = _splits(dataset)
    jens, _ = _ensembles(dataset, c)
    for ood_name in CASES[dataset][2]:
        oj, ot, _ = _splits(ood_name, 50)
        jt = jtasks.OODDetection({"in_distribution_test": sj, "out_distribution_test": oj}, c)
        tt = ttasks.OODDetection({"in_distribution_test": st, "out_distribution_test": ot}, c)
        want = jt.update_statistics(jens, output_performance=True)
        for k in ("in_proba", "out_proba", "in_data_unc", "out_data_unc",
                  "num_samples_collected"):
            setattr(tt, k, getattr(jt, k))
        got = tt.get_performance_metrics()
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-6), (ood_name, k)
    jd = jtasks.Decision({"decision_data_test": sj}, c)
    td = ttasks.Decision({"decision_data_test": st}, c)
    want = jd.update_statistics(jens, output_performance=True)
    td.risk, td.ensemble_proba = jd.risk, jd.ensemble_proba
    td.num_samples_collected = jd.num_samples_collected
    got = td.get_performance_metrics()
    assert got["True_Cost"] == pytest.approx(want["True_Cost"], abs=1e-6)
    np.testing.assert_array_equal(got["Decision"], want["Decision"])


@pytest.mark.parametrize("dataset", ["MNIST", "CIFAR10"])
def test_tasks_through_the_forward_pass_match_jax(dataset):
    sj, st, c = _splits(dataset)
    jens, tens = _ensembles(dataset, c)
    for ood_name in CASES[dataset][2]:
        oj, ot, _ = _splits(ood_name, 50)
        jt = jtasks.OODDetection({"in_distribution_test": sj, "out_distribution_test": oj}, c)
        tt = ttasks.OODDetection({"in_distribution_test": st, "out_distribution_test": ot}, c)
        want = jt.update_statistics(jens, output_performance=True)
        got = tt.update_statistics(tens, output_performance=True)
        assert tt.num_samples_collected == jt.num_samples_collected == 2
        for k in ("in_proba", "out_proba", "in_data_unc", "out_data_unc"):
            np.testing.assert_allclose(getattr(tt, k), getattr(jt, k), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        for k in want:
            assert 0.0 <= got[k] <= 1.0
            assert got[k] == pytest.approx(want[k], abs=1e-5), (ood_name, k)
    jd = jtasks.Decision({"decision_data_test": sj}, c)
    td = ttasks.Decision({"decision_data_test": st}, c)
    want = jd.update_statistics(jens, output_performance=True)
    got = td.update_statistics(tens, output_performance=True)
    np.testing.assert_allclose(td.risk, jd.risk, rtol=1e-5, atol=1e-5)
    # no decision hangs on a tie that float rounding could break
    mean_risk = np.sort(jd.risk / jd.num_samples_collected, axis=1)
    assert float((mean_risk[:, 1] - mean_risk[:, 0]).min()) > 1e-4
    np.testing.assert_array_equal(got["Decision"], want["Decision"])
    assert got["True_Cost"] == pytest.approx(want["True_Cost"], abs=1e-5)
    np.testing.assert_allclose(got["Pred_cost"], np.asarray(want["Pred_cost"]), rtol=1e-5,
                               atol=1e-5)
