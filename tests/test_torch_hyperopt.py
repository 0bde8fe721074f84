"""The hyperparameter-optimization layer of ursabench_tpu_torch against the
JAX package's: RandomSearch points, GridSearch grids, the parameter-space
mapping, ``sanitize_targets`` and the parallel search's commands are equal;
the GP's marginal likelihood, its gradient and posterior agree within 1e-5,
its fit within 1e-3 and the UCB ascent from JAX's candidates within 1e-3;
BayesOpt and batched BayesOpt reach tests/test_hyperopt.py's bounds on its
toy quadratic, and a kernel matrix that is not positive definite makes them
fall back to uniform draws instead of raising."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import run_hypopt as jrun
from ursabench_tpu.hyperopt import bayesopt as jbo
from ursabench_tpu.hyperopt import gp as jgp
from ursabench_tpu.hyperopt import search as jsearch
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import hyperopt as thyperopt
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import run_hypopt as trun
from ursabench_tpu_torch import tasks as ttasks
from ursabench_tpu_torch.hyperopt import bayesopt as tbo
from ursabench_tpu_torch.hyperopt import gp as tgp
from ursabench_tpu_torch.hyperopt import search as tsearch
from ursabench_tpu_torch.hyperopt import vectorized as tvec

torch.set_num_threads(1)

DOMAIN = [
    {"name": "lr", "type": "continuous", "domain": (1e-3, 1.0), "option": "logspace"},
    {"name": "prior_std", "type": "continuous", "domain": (0.1, 3.0), "option": "linspace"},
    {"name": "num_samples", "type": "constant", "domain": 3},
]
DISCRETE = DOMAIN[:2] + [
    {"name": "burn", "type": "discrete", "domain": (1, 10), "option": "linspace"},
    {"name": "steps", "type": "discrete", "domain": (2, 50), "option": "logspace"},
]


class _Quadratic:
    """tests/test_hyperopt.py's toy: the 'sampler' returns its hyperparameters
    and the 'task' scores -(log lr - log 0.03)^2 - (prior_std - 1)^2; NaN
    above ``diverge``."""

    def __init__(self, diverge=float("inf")):
        self.hyp, self.diverge = None, diverge

    def update_hyp(self, hyp):
        self.hyp = hyp

    def sample(self):
        return self.hyp

    def reset(self):
        pass

    def update_statistics(self, hyp, output_performance=True):
        if hyp["lr"] > self.diverge:
            return float("nan")
        return -(np.log(hyp["lr"]) - np.log(0.03)) ** 2 - (hyp["prior_std"] - 1.0) ** 2


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


# -- the numpy searches: equal to JAX's ------------------------------------------


@pytest.mark.parametrize("domain", [DOMAIN, DISCRETE], ids=["continuous", "discrete"])
def test_random_and_grid_search_equal_jax(domain):
    toy = _Quadratic()
    jr = jsearch.RandomSearch(toy, domain, toy, N_evaluations=7, seed=4)
    tr = tsearch.RandomSearch(toy, domain, toy, N_evaluations=7, seed=4)
    np.testing.assert_array_equal(tr._draw_points(), jr._draw_points())
    np.testing.assert_array_equal(tr.bounds, jr.bounds)
    for x in jr._draw_points():
        assert tr.convert_to_param_space(x) == jr.convert_to_param_space(x)
        assert tr._mk_hyp(x) == jr._mk_hyp(x)
    assert tr.run(return_all=1)[:2] == jr.run(return_all=1)[:2]
    sizes = [3, 4] + [1] * (len(domain) - 2) if domain is DOMAIN else [3, 2, 2, 2]
    jg = jsearch.GridSearch(toy, domain, toy, grid_size=sizes, seed=0)
    tg = tsearch.GridSearch(toy, domain, toy, grid_size=sizes, seed=0)
    for a, b in zip(tg._grid_points(), jg._grid_points()):
        np.testing.assert_array_equal(a, b)
    best_t, best_j = tg.run(return_all=1), jg.run(return_all=1)
    assert best_t[:4] == best_j[:4] and len(tg.time) == int(np.prod(sizes))


def test_sanitize_targets_equal_jax():
    for y in ([1.0, float("nan"), 3.0, float("-inf")], [0.5, 2.0], [float("inf"), -1.0]):
        np.testing.assert_array_equal(tbo.sanitize_targets(np.array(y)),
                                      jbo.sanitize_targets(np.array(y)))
    with pytest.raises(RuntimeError, match="non-finite"):
        tbo.sanitize_targets(np.array([float("nan")]))


def test_parallel_hypopt_commands_equal_jax(tmp_path, monkeypatch):
    domain_path = tmp_path / "domain.json"
    domain_path.write_text(json.dumps([
        {"name": "lr", "type": "continuous", "domain": [0.001, 0.1], "option": "logspace"},
        {"name": "prior_std", "type": "constant", "domain": 1.0},
        {"name": "num_samples", "type": "constant", "domain": 2},
        {"name": "burn_in_epochs", "type": "constant", "domain": 1},
    ]))
    monkeypatch.chdir(tmp_path)
    argv = ["--domain_path", str(domain_path), "--dataset", "MNIST", "--model", "MLP200MNIST",
            "--inference_method", "SGLD", "--N_evaluations", "3", "--dry_run",
            "--synthetic_n_train", "96", "--synthetic_n_test", "32"]
    want = jrun.main_par(argv)
    got = trun.main_par(argv, device="cpu")
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g[:3] == ["python", "-m", "ursabench_tpu_torch.experiment"]
        assert g[3:] == w[3:]


def test_hyperopt_exports():
    for name in ("RandomSearch", "GridSearch", "BayesOpt", "GP", "batched_bayesopt",
                 "batched_bayesopt_sghmc", "vectorized_random_search"):
        assert thyperopt.get_hypopt(name) is getattr(thyperopt, name)
    with pytest.raises(KeyError):
        thyperopt.get_hypopt("Nope")


# -- the GP against JAX's --------------------------------------------------------


def _gp_problem(seed=0, n=8, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d)).astype(np.float32)
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2 + 0.05 * rng.normal(size=n)
    y = np.array(jgp.standardize(jnp.asarray(y, jnp.float32)))
    raw = (np.array([0.3, -0.2], np.float32)[:d], np.float32(0.1), np.float32(-1.5))
    return x, y, raw


def _tparams(raw, grad=False):
    return tgp.GPParams(*(torch.tensor(np.asarray(r, np.float32), requires_grad=grad)
                          for r in raw))


def test_gp_likelihood_gradient_and_posterior_match_jax():
    x, y, raw = _gp_problem()
    jp = jgp.GPParams(*(jnp.asarray(r) for r in raw))
    want, want_g = jax.value_and_grad(jgp.neg_mll)(jp, jnp.asarray(x), jnp.asarray(y))
    tp = _tparams(raw, grad=True)
    got = tgp.neg_mll(tp, torch.from_numpy(x), torch.from_numpy(y))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    for a, b in zip(tp, want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    xq = np.random.default_rng(1).uniform(0, 1, (16, 2)).astype(np.float32)
    mj, sj = jgp.posterior(jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq))
    with torch.no_grad():
        mt, st = tgp.posterior(_tparams(raw), torch.from_numpy(x), torch.from_numpy(y),
                               torch.from_numpy(xq))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-6)
    ys = np.array([1.0, 2.0, 4.0], np.float32)
    np.testing.assert_allclose(tgp.standardize(torch.from_numpy(ys)).numpy(),
                               np.asarray(jgp.standardize(jnp.asarray(ys))), rtol=1e-6)
    assert float(tgp.standardize(torch.tensor([3.0]))[0]) == 0.0


def test_gp_fit_and_ucb_ascent_match_jax():
    """200 Adam steps from init_params: the transformed parameters within
    1e-3; the ascent from JAX's own candidates: endpoints within 1e-3."""
    x, y, _ = _gp_problem(seed=2, n=10)
    jgp_ = jgp.GP(x, y)
    tgp_ = tgp.GP(x, y, device="cpu")
    for a, b in zip(tgp._transform(tgp_.params), jgp._transform(jgp_.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)
    bounds = jnp.asarray([[0.0, 1.0], [0.0, 1.0]], jnp.float32)
    key = jax.random.PRNGKey(7)
    want_x, want_v = jgp_._ascend_from_candidates(bounds, key, 0.1, 64, 5, 50)
    cand = np.asarray(bounds[:, 0] + (bounds[:, 1] - bounds[:, 0])
                      * jax.random.uniform(key, (64, 2)))
    fixed = tgp.GP(x, y, p0=tgp.GPParams(*(torch.from_numpy(np.asarray(t))
                                           for t in jgp_.params)), device="cpu", steps=0)
    got_x, got_v = fixed.ascend(torch.from_numpy(np.asarray(bounds)), torch.from_numpy(cand),
                                0.1, num_restarts=5, ascent_steps=50)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-3, atol=1e-4)
    assert float(got_x.min()) >= 0.0 and float(got_x.max()) <= 1.0
    batch = fixed.optimize_ucb_batch(torch.from_numpy(np.asarray(bounds)),
                                     torch.Generator().manual_seed(0), q=3)
    assert batch.shape == (3, 2) and len({tuple(r) for r in batch.round(6)}) == 3


def test_gp_without_a_positive_definite_kernel_gives_nan(monkeypatch):
    monkeypatch.setattr(tgp, "JITTER", -10.0)
    x, y, raw = _gp_problem()
    with torch.no_grad():
        mean, std = tgp.posterior(_tparams(raw), torch.from_numpy(x), torch.from_numpy(y),
                                  torch.from_numpy(x[:2]))
        nll = tgp.neg_mll(_tparams(raw), torch.from_numpy(x), torch.from_numpy(y))
    assert torch.isnan(mean).all() and torch.isnan(std).all() and torch.isnan(nll)


# -- BayesOpt and batched BayesOpt: behaviour -------------------------------------


def _bo(task=None, domain=DOMAIN, **kw):
    task = task or _Quadratic()
    return thyperopt.BayesOpt(task, domain, task, device="cpu", **kw)


def test_bayesopt_improves_over_init():
    best_hyp, best_obj, hyps, trace = _bo(N_evaluations=8, init_evaluations=3, seed=0).run(
        return_all=1, initialisation="RandomSearch")
    assert best_obj >= trace[0] - 1e-9 and best_obj > -0.5
    assert len(hyps) == 3 + 8 and best_hyp["num_samples"] == 3


def test_bayesopt_discrete_checkpoint_and_divergence(tmp_path):
    bo = _bo(domain=DISCRETE, N_evaluations=3, init_evaluations=2, seed=1)
    best_hyp, _ = bo.run(initialisation="RandomSearch", save_path=str(tmp_path / "best"))
    assert (tmp_path / "best.json").exists()
    assert isinstance(best_hyp["burn"], int) and isinstance(best_hyp["steps"], int)
    best_hyp, best_obj = _bo(_Quadratic(diverge=0.1), N_evaluations=4, init_evaluations=3,
                             seed=3).run(initialisation="RandomSearch")
    assert np.isfinite(best_obj) and best_hyp["lr"] <= 0.1
    _, _, hyps, _ = _bo(N_evaluations=2, init_evaluations=2, seed=0).run(return_all=1)
    assert len(hyps) == 2 * 2 + 2  # the grid initialisation: 2 x 2 points


def test_bayesopt_falls_back_when_the_cholesky_fails(monkeypatch):
    monkeypatch.setattr(tgp, "JITTER", -10.0)
    drawn = []
    uniform = tbo.uniform_points
    monkeypatch.setattr(tbo, "uniform_points",
                        lambda *a: drawn.append(1) or uniform(*a))
    _, best_obj, hyps, _ = _bo(N_evaluations=3, init_evaluations=3, seed=0).run(
        return_all=1, initialisation="RandomSearch")
    assert len(drawn) == 3 and len(hyps) == 6 and np.isfinite(best_obj)
    for h in hyps:
        assert 1e-3 <= h["lr"] <= 1.0 and 0.1 <= h["prior_std"] <= 3.0


def test_bayesopt_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        thyperopt.BayesOpt(_Quadratic(), DOMAIN, _Quadratic())


def test_gp_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y, _ = _gp_problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        tgp.GP(x, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgp.init_params(2)


class _ToySweep:
    """Stands in for MethodSweep: each config's objective is the toy's."""

    made = []

    def __init__(self, hyp_list, **kw):
        self.hyp_list = hyp_list
        _ToySweep.made.append(len(hyp_list))
        self.seconds = {"sample": 0.0, "bma": 0.0}

    def objectives(self, task_factory):
        return [_Quadratic().update_statistics(h) for h in self.hyp_list]


@pytest.mark.parametrize("jitter", [tgp.JITTER, -10.0], ids=["gp", "nan_fallback"])
def test_batched_bayesopt_on_the_toy(monkeypatch, jitter):
    monkeypatch.setattr(tvec, "MethodSweep", _ToySweep)
    monkeypatch.setattr(tgp, "JITTER", jitter)
    _ToySweep.made = []
    rounds = []
    best_hyp, best_obj, hyps, objs = thyperopt.batched_bayesopt(
        DOMAIN, None, None, None, rounds=3, q=3, init_evaluations=3, seed=0, device="cpu",
        round_seconds=rounds)
    assert _ToySweep.made == [3, 3, 3, 3] and len(objs) == 12 and best_obj == max(objs)
    assert len(rounds) == 4 and {"gp_fit", "acquisition"} <= set(rounds[1])
    for h in hyps:
        assert 1e-3 <= h["lr"] <= 1.0 and 0.1 <= h["prior_std"] <= 3.0
    if jitter == tgp.JITTER:
        assert best_obj > -0.5
    rs = tsearch.RandomSearch(None, DOMAIN, None, N_evaluations=3, seed=0)
    assert hyps[:3] == [rs._mk_hyp(p) for p in rs._draw_points()]
    # a mesh of 4 ranks needs 4 processes: a one-process run cannot build one
    # for the search (tests/test_torch_parallel.py runs real meshes)
    from ursabench_tpu_torch import parallel

    with pytest.raises(ValueError, match="initialize"):
        thyperopt.vectorized_random_search(DOMAIN, None, None, None, device="cpu",
                                           mesh=parallel.make_mesh(4))


def test_vectorized_searches_on_a_real_sweep():
    """Random search and one BO round over SGHMC sweeps on 64 MNIST images:
    the 'll' objectives are finite and at most 0, the best is the max."""
    splits, c = tdata.loaders("MNIST", None, batch_size=32, use_validation=False,
                              synthetic_n_train=64, synthetic_n_test=32)
    domain = [{"name": "lr", "type": "continuous", "domain": (1e-4, 0.3),
               "option": "logspace"},
              {"name": "prior_std", "type": "constant", "domain": 1.0},
              {"name": "alpha", "type": "constant", "domain": 0.1},
              {"name": "num_samples", "type": "constant", "domain": 1},
              {"name": "burn_in_epochs", "type": "constant", "domain": 0}]

    def task_factory():
        return ttasks.Prediction({"in_distribution_test": splits["test"]}, c,
                                 metric_list=["ll"])

    module = tmodels.get_model("MLP200MNIST").build(c)
    best_hyp, best_obj, hyps, objs = thyperopt.vectorized_random_search(
        domain, module, splits["train"], task_factory, N_evaluations=3, seed=0, device="cpu")
    assert len(objs) == 3 and best_obj == max(objs) and all(o <= 0 for o in objs)
    best_hyp, best_obj, hyps, objs = thyperopt.batched_bayesopt_sghmc(
        domain, module, splits["train"], task_factory, rounds=1, q=2, init_evaluations=2,
        seed=0, device="cpu")
    assert len(objs) == 4 and best_obj == max(objs) and np.isfinite(best_obj)
    assert 1e-4 <= best_hyp["lr"] <= 0.3


def test_sequential_hypopt_writes_the_best(tmp_path):
    domain_path = tmp_path / "domain.json"
    domain_path.write_text(json.dumps([
        {"name": "lr", "type": "continuous", "domain": [0.001, 0.1], "option": "logspace"},
        {"name": "prior_std", "type": "constant", "domain": 1.0},
        {"name": "num_samples", "type": "constant", "domain": 1},
        {"name": "burn_in_epochs", "type": "constant", "domain": 0},
    ]))
    save = str(tmp_path / "bo")
    best_hyp, max_obj = trun.main_seq(
        ["--domain_path", str(domain_path), "--inference_method", "SGLD", "--batch_size",
         "32", "--synthetic_n_train", "80", "--synthetic_n_test", "16", "--N_evaluations",
         "1", "--init_evaluations", "2", "--save_path", save], device="cpu")
    out = json.loads((tmp_path / "bo_best.json").read_text())
    assert out["best_hyp"] == best_hyp and out["max_obj"] == max_obj and len(out["times"]) == 3
