"""The multi-config sweep of ursabench_tpu_torch: K1's per-row scalar table
(its plain version: one call over R rows against R single-row calls), the
(K,) hyperparameter tensors of the samplers' updates, and
``inference.vectorized.MethodSweep`` against the JAX package's (one epoch
of 2 SGHMC and of 2 cSGHMC configs from the same weights over JAX's
per-config permutations, noise off) and against the port's own solo
samplers (exactly equal with the noise gate off). The CUDA kernel itself
runs only on the card (chip_smoke.py's "hypopt" phase)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import inference as jinference
from ursabench_tpu import models as jmodels
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import inference as tinference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.inference import engine, sgd_map, sgmcmc, vectorized
from ursabench_tpu_torch.kernels import sghmc as k1
from ursabench_tpu_torch.ops import sgmcmc as tops
from ursabench_tpu_torch.transfer import params_from_jax
from ursabench_tpu_torch.util import derive_seed

torch.set_num_threads(1)

LOADER = dict(batch_size=32, use_validation=False, synthetic_n_train=96, synthetic_n_test=40)
SGHMC_HYPS = [{"lr": 0.05, "prior_std": 1.0, "num_samples": 1, "alpha": 0.1,
               "burn_in_epochs": 1},
              {"lr": 0.02, "prior_std": 0.5, "num_samples": 1, "alpha": 0.1,
               "burn_in_epochs": 1}]
CYC_HYPS = [{"lr_0": lr, "prior_std": ps, "num_samples_per_cycle": 2, "cycle_length": 4,
             "burn_in_epochs": 1, "num_cycles": 1, "alpha": 0.1}
            for lr, ps in ((0.05, 1.0), (0.02, 0.7))]
SGD_HYPS = [{"lr": lr, "epochs": 1, "momentum": m, "weight_decay": wd}
            for lr, m, wd in ((0.05, 0.9, 5e-4), (0.1, 0.5, 1e-3))]


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _splits(**kw):
    kw = {**LOADER, **kw}
    js, c = jdata.loaders("MNIST", None, **kw)
    ts, _ = tdata.loaders("MNIST", None, **kw)
    return js, ts, c


def _mlp(c):
    return tmodels.get_model("MLP200MNIST").build(c)


# -- K1's per-row table -----------------------------------------------------


@pytest.mark.parametrize("row_len", [6, 7, 12])
@pytest.mark.parametrize("first", [False, True])
def test_table_over_rows_equals_single_row_calls(row_len, first):
    """One plain K1 call over 3 rows equals 3 single-row calls given the same
    normals, bit for bit; the row with noise_scale 0 gets none."""
    rng = np.random.default_rng(row_len)
    p, v, g, z = (torch.from_numpy(rng.normal(size=(3, row_len)).astype(np.float32))
                  for _ in range(4))
    lr = torch.tensor([0.05, 0.1, 0.02])
    mom = torch.tensor([0.9, 0.5, 0.0])
    wd = torch.tensor([1e-3, 2e-2, 0.0])
    table = tops.sghmc_scalars(lr=lr, momentum=mom, wd_over_n=wd, n_train=50.0,
                               noise_on=torch.tensor([1.0, 0.0, 1.0]),
                               is_first_step=first, device="cpu")
    assert table.shape == (3, 5) and float(table[1, 3]) == 0.0
    pt, vt = p.clone(), v.clone()
    k1.sghmc_update_flat_reference(pt.view(-1), vt.view(-1), g.view(-1), table, z.view(-1))
    for r in range(3):
        s = tops.sghmc_scalars(lr=float(lr[r]), momentum=float(mom[r]),
                               wd_over_n=float(wd[r]), n_train=50.0,
                               noise_on=1.0 if r != 1 else 0.0, is_first_step=first,
                               device="cpu")
        assert s.shape == (5,) and torch.equal(s, table[r])
        pr, vr = p[r].clone(), v[r].clone()
        k1.sghmc_update_flat_reference(pr, vr, g[r].clone(), s, z[r].clone())
        assert torch.equal(pt[r], pr) and torch.equal(vt[r], vr), r
    noiseless = p[1] + (mom[1] * (g[1] + wd[1] * p[1] if first else v[1])
                        - lr[1] * (g[1] + wd[1] * p[1]))
    torch.testing.assert_close(pt[1], noiseless, rtol=1e-6, atol=1e-7)


def test_one_row_table_is_the_float32_5():
    rng = np.random.default_rng(1)
    p, v, g, z = (torch.from_numpy(rng.normal(size=10).astype(np.float32)) for _ in range(4))
    s = tops.sghmc_scalars(lr=0.05, momentum=0.9, wd_over_n=1e-3, n_train=20.0, noise_on=1.0,
                           is_first_step=False, device="cpu")
    a = [t.clone() for t in (p, v)]
    b = [t.clone() for t in (p, v)]
    k1.sghmc_update_flat_reference(*a, g, s, z)
    k1.sghmc_update_flat_reference(*b, g, s.view(1, 5), z)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert k1.table_rows(s) == 1 and k1.table_rows(torch.zeros(4, 5)) == 4
    with pytest.raises(ValueError, match="scalars"):
        k1.table_rows(torch.zeros(4, 6))
    with pytest.raises(ValueError, match="CUDA"):  # the kernel never runs on CPU tensors
        k1.sghmc_update_flat(p, v, g, torch.zeros(2, 5), seed=0)


def test_kernel_source_takes_a_table():
    src = k1.SOURCE.read_text()
    assert "long long rows" in src and "straddles rows" in src
    assert "rows == 1 ? 0 : base / row_len" in src  # one division a group, none at R = 1


# -- (K,) hyperparameters in the samplers' updates --------------------------------


@pytest.mark.parametrize("cls", [sgmcmc.SGHMC, sgd_map.SGD])
def test_per_config_update_equals_per_row_updates(cls):
    """The samplers' update with (K,) hyperparameter tensors over the (K, P)
    buffers equals K updates with 0-dim ones over each row."""
    _, ts_, c = _splits(synthetic_n_train=32)
    hyp = SGHMC_HYPS if cls is sgmcmc.SGHMC else SGD_HYPS
    solos = [cls(h, model=_mlp(c), train=ts_["train"], device="cpu") for h in hyp]
    rng = np.random.default_rng(3)
    p, v, g = (torch.from_numpy(rng.normal(size=(2, 199210)).astype(np.float32))
               for _ in range(3))
    state = engine.TrainState(solos[0].module, p.clone(), v.clone(), g)
    stacked = {k: torch.stack([s._hyp[k] for s in solos]) for k in solos[0]._HYP_KEYS}
    lr = cls._LR_FN(stacked, 0, 0, 0)
    assert lr.shape == (2,)
    cls._UPDATE_FN(state, stacked, lr=lr, noise_on=torch.tensor(0.0), is_first_step=False,
                   seed=1)
    for k, s in enumerate(solos):
        row = engine.TrainState(s.module, p[k].clone(), v[k].clone(), g[k])
        cls._UPDATE_FN(row, s._hyp, lr=cls._LR_FN(s._hyp, 0, 0, 0),
                       noise_on=torch.tensor(0.0), is_first_step=False, seed=1)
        assert torch.equal(state.params[k], row.params), k
        assert torch.equal(state.momentum[k], row.momentum), k


# -- MethodSweep against the JAX package's ----------------------------------------


def _jax_perm(key, n):
    _, k_perm, _, _, _ = jax.random.split(key, 5)
    return np.array(jax.random.permutation(k_perm, n))


@pytest.mark.parametrize("method,hyps", [("SGHMC", SGHMC_HYPS), ("cSGHMC", CYC_HYPS)])
def test_sweep_epoch_matches_jax(method, hyps):
    """One noise-off epoch of 2 configs (different lr and prior) from JAX's
    initial weights over JAX's per-config permutations: within 1e-5."""
    js_, ts_, c = _splits()
    jsweep = jinference.MethodSweep(hyps, model=jmodels.get_model("MLP200MNIST").build(c),
                                    train=js_["train"], key=jax.random.PRNGKey(3),
                                    method=method)
    start = jax.tree.map(np.array, jsweep._state.params)
    perms = [_jax_perm(jsweep._state.key[k], 96) for k in range(2)]
    loss_j = jsweep._run_epoch(noise_on=0.0)
    end = jax.tree.map(np.array, jsweep._state.params)

    sweep = vectorized.MethodSweep(hyps, model=_mlp(c), train=ts_["train"], seed=3,
                                   method=method, device="cpu")
    s = sweep.sampler
    assert s._state.params.shape == (2, 199210) and s.chains == 2
    for key, val in jsweep._hyp_vec.items():
        np.testing.assert_allclose(s._hyp[key].numpy(), np.asarray(val), rtol=1e-7,
                                   err_msg=key)
    for k in range(2):
        params_from_jax(sweep.modules[k], {"params": jax.tree.map(lambda x: x[k], start)})
    idx = torch.from_numpy(np.stack(perms)).view(2, -1, 32)
    loss_t = engine.train_steps(
        s._state, s._images, s._labels, idx, spec=ts_["train"].spec, epoch=0,
        noise_on=torch.tensor(0.0), hyp=s._hyp, lr_fn=s._LR_FN, update_fn=s._UPDATE_FN,
        seeds=[1] * 3)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=0, atol=1e-5)
    for k in range(2):
        want = params_from_jax(_mlp(c), {"params": jax.tree.map(lambda x: x[k], end)})
        for name, val in sweep.modules[k].state_dict().items():
            np.testing.assert_allclose(val.numpy(), want.state_dict()[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=f"{k} {name}")
    assert not torch.allclose(s._state.params[0], s._state.params[1])


# -- MethodSweep against the port's solo samplers -------------------------------
# bit-equal to a solo run in turn ("scan"); "vmap" against "scan" is
# test_torch_chains.py's


def _solo(cls, h, c, split, seed, k):
    return cls(dict(h), model=_mlp(c), train=split, seed=derive_seed(seed, "config", k),
               device="cpu")


def _assert_same_weights(a, b, what):
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), f"{what}: {name}"


def test_sgd_sweep_equals_solo_runs():
    _, ts_, c = _splits()
    sweep = vectorized.MethodSweep(SGD_HYPS, model=_mlp(c), train=ts_["train"], seed=5,
                                   method="SGD", device="cpu", chain_strategy="scan")
    ensembles = sweep.sample()
    assert len(ensembles) == 2 and sweep.sampler.epochs_run == 2
    for k, h in enumerate(SGD_HYPS):
        solo = _solo(sgd_map.SGD, h, c, ts_["train"], 5, k)
        ens = solo.sample()
        assert ens.num_members == ensembles[k].num_members == 1
        for name, val in ens.state.items():
            assert torch.equal(ensembles[k].state[name], val), (k, name)
        assert torch.equal(sweep.sampler.epoch_losses[-1][k], solo.epoch_losses[-1])


def test_dropout_sweep_equals_solo_runs():
    """Each config draws its dropout masks from its own solo sampler's
    stream."""
    _, ts_, c = _splits(synthetic_n_train=64)
    model = lambda: tmodels.get_model("MLP200MNIST_dropout").build(c)  # noqa: E731
    sweep = vectorized.MethodSweep(SGD_HYPS, model=model(), train=ts_["train"], seed=4,
                                   method="SGD", device="cpu", chain_strategy="scan")
    ensembles = sweep.sample()
    for k, h in enumerate(SGD_HYPS):
        solo = sgd_map.SGD(dict(h), model=model(), train=ts_["train"],
                           seed=derive_seed(4, "config", k), device="cpu")
        for name, val in solo.sample().state.items():
            assert torch.equal(ensembles[k].state[name], val), (k, name)


def test_sghmc_sweep_equals_solo_runs_with_the_noise_off(monkeypatch):
    """Two noise-off epochs; one update a step for both configs, over the
    (2, P) buffers."""
    _, ts_, c = _splits()
    calls = []
    update = sgmcmc.sghmc_update

    def counted(params, *args, **kw):
        calls.append(tuple(params.shape))
        return update(params, *args, **kw)

    monkeypatch.setattr(sgmcmc, "sghmc_update", counted)
    sweep = vectorized.MethodSweep(SGHMC_HYPS, model=_mlp(c), train=ts_["train"], seed=6,
                                   method="SGHMC", device="cpu", chain_strategy="scan")
    for _ in range(2):
        sweep.sampler._run_epoch(noise_on=False)
    assert calls == [(2, 199210)] * 6
    for k, h in enumerate(SGHMC_HYPS):
        solo = _solo(sgmcmc.SGHMC, h, c, ts_["train"], 6, k)
        for _ in range(2):
            solo._run_epoch(noise_on=False)
        _assert_same_weights(sweep.modules[k], solo.module, f"config {k}")
        assert torch.equal(sweep.sampler._state.momentum[k], solo._state.momentum[0])


def test_sweep_protocols_and_members():
    """SGHMC: burn_in + 1 epochs then one a draw, noise on; cSGHMC: the
    cycle's harvests; every config its own ensemble."""
    _, ts_, c = _splits(synthetic_n_train=32)
    hyps = [{**h, "num_samples": 2} for h in SGHMC_HYPS]
    ens = tinference.MethodSweep(hyps, model=_mlp(c), train=ts_["train"], device="cpu").sample()
    assert [e.num_members for e in ens] == [2, 2]
    assert not torch.equal(ens[0].state["fc1.weight"], ens[1].state["fc1.weight"])
    sweep = tinference.MethodSweep(CYC_HYPS, model=_mlp(c), train=ts_["train"],
                                   method="cSGHMC", device="cpu")
    gates = []
    run = sweep.sampler._run_epoch
    sweep.sampler._run_epoch = lambda noise_on=None: (gates.append(noise_on), run(noise_on))[1]
    ens = sweep.sample()
    assert gates == [False, True, True, True] and [e.num_members for e in ens] == [2, 2]
    sgld = tinference.MethodSweep(hyps, model=_mlp(c), train=ts_["train"], method="SGLD",
                                  device="cpu")
    assert float(sgld.sampler._hyp["momentum"].abs().max()) == 0.0


def test_sweep_checks_its_configs():
    _, ts_, c = _splits(synthetic_n_train=32)
    bad = [SGD_HYPS[0], {**SGD_HYPS[1], "epochs": 3}]
    with pytest.raises(ValueError, match="burn_in_epochs"):
        tinference.MethodSweep(bad, model=_mlp(c), train=ts_["train"], method="SGD",
                               device="cpu")
    with pytest.raises(ValueError, match="unknown sweep method"):
        tinference.MethodSweep(SGD_HYPS, model=_mlp(c), train=ts_["train"], method="HMC",
                               device="cpu")
    vmapped = tinference.MethodSweep(SGD_HYPS, model=_mlp(c), train=ts_["train"],
                                     method="SGD", chain_strategy="vmap", device="cpu")
    assert vmapped.sampler._resolved_chain_strategy == "vmap"
    from ursabench_tpu_torch import parallel

    with pytest.raises(ValueError, match="initialize"):  # 4 ranks, one process
        tinference.MethodSweep(SGD_HYPS, model=_mlp(c), train=ts_["train"], method="SGD",
                               mesh=parallel.make_mesh(4), device="cpu")
    assert tinference.get_inference("SGHMCSweep") is tinference.SGHMCSweep
    for name in ("HMC", "PCASubspaceSampler"):  # ported: samplers, not sweep methods
        assert tinference.get_inference(name) is getattr(tinference, name)
    model = _mlp(c)
    before = copy.deepcopy(model.state_dict())
    tinference.SGHMCSweep(SGHMC_HYPS, model=model, train=ts_["train"], device="cpu")
    for k, v in model.state_dict().items():  # the given module is copied, not re-homed
        assert torch.equal(v, before[k]), k


def test_sweep_objectives_score_every_config():
    _, ts_, c = _splits(synthetic_n_train=32)
    from ursabench_tpu_torch import tasks

    sweep = tinference.MethodSweep(SGD_HYPS, model=_mlp(c), train=ts_["train"], method="SGD",
                                   device="cpu")
    objs = sweep.objectives(lambda: tasks.Prediction({"in_distribution_test": ts_["test"]},
                                                     c, metric_list=["ll"]))
    assert len(objs) == 2 and all(np.isfinite(o) and o <= 0 for o in objs)
    assert set(sweep.seconds) == {"sample", "bma"}
