"""The device mesh of ursabench_tpu_torch (``parallel/``) on the CPU.

- The layout rules (``auto_layout``, ``chain_layout``, ``make_layout``)
  equal the JAX package's ``auto_mesh``, ``chain_mesh`` and ``make_mesh`` for
  1 to 8 devices; these run no collective.
- K1's plain path with a global element offset: blocks of rows, each
  updated with its offset, equal the whole buffer's update bit for bit.
- Sharded runs over 2 and 4 gloo processes against one process and against
  the JAX package's one-device epoch, under the tolerances
  ``tests/test_parallel.py`` holds the JAX package's sharded programs to
  for the same rule; the chain mesh under ``"scan"`` bit for bit.

Each multi-process world is spawned once per module (a fixture) and runs
every case of its size in turn; its ranks meet through a ``FileStore`` in a
temporary directory, so parallel test workers never share a port, each
with one thread and a 60 s collective timeout, and the parent kills them
past ``SPAWN_TIMEOUT``. Nothing of JAX is imported at the top of this
module: the spawned ranks import it. The JAX side is computed in the parent
and handed to the ranks as numpy arrays; no sharded JAX program runs here.
"""

import copy
import json
import multiprocessing as mp
import os
import pathlib
import pickle
import time
import traceback

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import inference as tinference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import parallel
from ursabench_tpu_torch import tasks as ttasks
from ursabench_tpu_torch.data.transforms import augment_normalized, draw_augment, normalize
from ursabench_tpu_torch.inference import engine
from ursabench_tpu_torch.kernels.sghmc import sghmc_update_flat_reference
from ursabench_tpu_torch.models.common import Dropout
from ursabench_tpu_torch.ops.sgmcmc import sghmc_scalars, sghmc_update
from ursabench_tpu_torch.parallel import distributed as tdist
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

SPAWN_TIMEOUT = 300  # seconds for a whole world, start-up included
LOADER = dict(batch_size=32, use_validation=False, synthetic_n_train=128,
              synthetic_n_test=64)
SGHMC_HYP = {"lr": 0.03, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1,
             "burn_in_epochs": 0}
DE_HYP = {"lr": 0.05, "epochs": 2, "momentum": 0.9, "weight_decay": 1e-4, "num_members": 4}
SWA_HYP = {"swag_lr": 0.01, "swag_wd": 0.001, "lr_init": 0.02, "num_samples": 1,
           "momentum": 0.9, "burn_in_epochs": 2, "num_iterates": 2}
SWEEP_LRS = (0.005, 0.02, 0.05, 0.1)
RUN_HYP = {"lr": 0.03, "prior_std": 1.0, "num_samples": 2, "burn_in_epochs": 1}
RUN_ARGV = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--inference_method", "SGLD",
            "--batch_size", "32", "--hyperparams", json.dumps(RUN_HYP), "--chains", "2",
            "--synthetic_n_train", "128", "--synthetic_n_test", "64", "--num_trials", "2"]
SEARCH_DOMAIN = [
    {"name": "lr", "type": "continuous", "domain": (1e-3, 0.1), "option": "logspace"},
    {"name": "prior_std", "type": "constant", "domain": 1.0},
    {"name": "alpha", "type": "constant", "domain": 0.1},
    {"name": "num_samples", "type": "constant", "domain": 1},
    {"name": "burn_in_epochs", "type": "constant", "domain": 0},
]


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


# -- spawning a world of ranks ---------------------------------------------------------

def _rank_main(case: str, rank: int, world: int, tmp: str, args: tuple) -> None:
    """One rank: join the world, run ``case(*args)``, pickle its result to
    ``rank<r>.pkl`` (a traceback to ``rank<r>.err`` on failure)."""
    os.environ["URSA_SYNTH_CACHE"] = "0"
    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    try:
        parallel.initialize(f"file://{tmp / 'store'}", world, rank, backend="gloo",
                            timeout_s=60)
        out = globals()[case](*args)
        with open(tmp / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _spawn(case: str, world: int, tmp: pathlib.Path, *args) -> list:
    """Every rank's result of ``case`` run by ``world`` spawned processes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(case, r, world, str(tmp), args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_TIMEOUT
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = {r: (tmp / f"rank{r}.err").read_text() for r in range(world)
              if (tmp / f"rank{r}.err").exists()}
    assert not errors, f"ranks failed: {errors}"
    assert not late, f"ranks {late} still running after {SPAWN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- helpers shared by the ranks and the parent -------------------------------------------

def _mnist(**kw):
    splits, c = tdata.loaders("MNIST", None, **{**LOADER, **kw})
    return splits, c


def _mlp(c, name="MLP200MNIST"):
    return tmodels.get_model(name).build(c)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _state_np(state: dict) -> dict:
    return {k: _np(v) for k, v in state.items()}


def _prediction(ens, split, c) -> dict:
    task = ttasks.Prediction({"in_distribution_test": split}, c,
                             metric_list=["error_rate", "nll", "ece"])
    task.update_statistics(ens, output_performance=False)
    return task.get_performance_metrics()


def _sghmc(splits, c, *, chains, seed, mesh=None, strategy="auto", hyp=SGHMC_HYP):
    return tinference.SGHMC(hyp, model=_mlp(c), train=splits["train"], seed=seed,
                            chains=chains, device="cpu", mesh=mesh, chain_strategy=strategy)


def _sweep(splits, c, mesh=None):
    hyps = [{**SGHMC_HYP, "lr": lr, "burn_in_epochs": 1} for lr in SWEEP_LRS]
    return tinference.MethodSweep(hyps, model=_mlp(c), train=splits["train"], seed=6,
                                  mesh=mesh, device="cpu")


def _sharded_logit_order(members: int, chains: int, chain_shards: int) -> list:
    """Draw-major member index of each row of ``shard_ensemble_eval``'s
    output, whose blocks are the chain ranks' members in their order."""
    local = chains // chain_shards
    return [(j // local) * chains + cr * local + j % local
            for cr in range(chain_shards) for j in range(members // chain_shards)]


def _first_test_batch(splits):
    test = splits["test"]
    images, _ = test.device_tensors("cpu")
    x = normalize(images[:test.batch_size], test.spec)
    return x.permute(0, 3, 1, 2).contiguous()


# -- the four-rank world -------------------------------------------------------------------

def _case_world4() -> dict:
    """(2, 2): SGHMC x2 chains, its ensemble, tasks on it, update_hyp,
    DeepEnsemble, a K=4 sweep and a vectorized search; (4, 1): 4 chains
    under scan with the one-process run beside it (rank 0); (1, 4): one
    chain, pure data parallelism."""
    out = {}
    splits, c = _mnist()
    mesh22 = parallel.make_mesh()
    out["mesh22"] = (dict(mesh22.shape), mesh22.chain_idx, mesh22.data_idx)

    s = _sghmc(splits, c, chains=2, seed=5, mesh=mesh22)
    ens = s.sample()  # burn-in 0: two epochs, the noise on
    gathered = ens.gather()
    out["sghmc"] = {"params": _np(s._state.params), "momentum": _np(s._state.momentum),
                    "chains": list(s.chain_ids), "members": (ens.num_members, ens.local_members),
                    "gathered": _state_np(gathered.state)}
    out["metrics"] = (_prediction(ens, splits["test"], c),
                      _prediction(gathered, splits["test"], c))
    x = _first_test_batch(splits)
    out["sharded_logits"] = _np(parallel.shard_ensemble_eval(s.module, mesh22)(ens.state, x))
    out["gathered_logits"] = _np(gathered.logits_all(x))

    before = ({k: id(t) for k, t in s._hyp.items()}, s._state.params.data_ptr(),
              s._state, s._data_gens[0].device, s.mesh)
    s.update_hyp({**SGHMC_HYP, "lr": 0.05, "prior_std": 0.5, "alpha": 0.2})
    after = ({k: id(t) for k, t in s._hyp.items()}, s._state.params.data_ptr(),
             s._state, s._data_gens[0].device, s.mesh)
    out["update_hyp"] = {"same": all(a is b or a == b for a, b in zip(before, after)),
                         "lr0": float(s._hyp["lr0"]),
                         "finite": bool(torch.isfinite(s.sample().gather().state[
                             "fc1.weight"]).all())}

    mesh41 = parallel.Mesh(4, 1)
    s41 = _sghmc(splits, c, chains=4, seed=2, mesh=mesh41, strategy="scan")
    for _ in range(2):
        s41._run_epoch(noise_on=True)
    out["chain41"] = {"params": _np(mesh41.chain_rows(s41._state.params)),
                      "momentum": _np(mesh41.chain_rows(s41._state.momentum))}
    if mesh41.rank == 0:  # the one-process run, in this process: the same threads
        ref = _sghmc(splits, c, chains=4, seed=2, strategy="scan")
        for _ in range(2):
            ref._run_epoch(noise_on=True)
        out["chain41_ref"] = {"params": _np(ref._state.params),
                              "momentum": _np(ref._state.momentum)}

    mesh14 = parallel.Mesh(1, 4)
    s14 = _sghmc(splits, c, chains=1, seed=7, mesh=mesh14)
    s14._run_epoch(noise_on=True)
    out["chain1"] = _np(s14._state.params)

    de = tinference.DeepEnsemble(DE_HYP, model=_mlp(c), train=splits["train"], seed=11,
                                 device="cpu", mesh=mesh22)
    de_ens = de.sample()
    out["deep_ensemble"] = {"members": de_ens.num_members,
                            "state": _state_np(de_ens.gather().state)}

    sweep = _sweep(splits, c, mesh22)
    for _ in range(2):
        sweep.sampler._run_epoch(noise_on=True)
    out["sweep"] = {"configs": list(sweep.configs),
                    "params": _np(mesh22.chain_rows(sweep.sampler._state.params))}

    def task_factory():
        return ttasks.Prediction({"in_distribution_test": splits["test"]}, c,
                                 metric_list=["ll"])

    best_hyp, best_obj, _, objs = _vectorized_search(splits, c, task_factory, mesh22)
    out["search"] = (best_hyp, best_obj, objs)

    refusals = {}  # a data mesh only
    for cls, hyp, kw in ((tinference.SWA, SWA_HYP, {}), (tinference.SWAG, SWA_HYP, {}),
                         (tinference.MCdropout, None, {"model_name": "MLP200MNIST"})):
        try:
            cls(hyp, model=_mlp(c), train=splits["train"], device="cpu", mesh=mesh22, **kw)
            refusals[cls.__name__] = None
        except ValueError as e:
            refusals[cls.__name__] = str(e)
    out["chain_mesh_refusals"] = refusals
    return out


def _vectorized_search(splits, c, task_factory, mesh):
    from ursabench_tpu_torch.hyperopt import vectorized_random_search

    return vectorized_random_search(SEARCH_DOMAIN, _mlp(c), splits["train"], task_factory,
                                    N_evaluations=4, seed=0, mesh=mesh, device="cpu")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn("_case_world4", 4, tmp_path_factory.mktemp("world4"))


def test_four_ranks_lay_out_as_chain_major_grid(world4):
    assert [r["mesh22"] for r in world4] == [
        ({"chain": 2, "data": 2}, 0, 0), ({"chain": 2, "data": 2}, 0, 1),
        ({"chain": 2, "data": 2}, 1, 0), ({"chain": 2, "data": 2}, 1, 1)]
    assert [r["sghmc"]["chains"] for r in world4] == [[0], [0], [1], [1]]


def test_sharded_sghmc_matches_one_process(world4):
    """(2, 2), two chains, two noisy epochs against one process from the
    same seed: the data split changes only the order of the gradient's sum,
    which the noisy momentum then carries (test_parallel.py:46-81's
    tolerance)."""
    splits, c = _mnist()
    ref = _sghmc(splits, c, chains=2, seed=5)
    ens = ref.sample()
    got = world4[0]["sghmc"]["gathered"]
    assert world4[0]["sghmc"]["members"] == (4, 2)
    for k, v in ens.state.items():
        np.testing.assert_allclose(got[k], _np(v), rtol=1e-3, atol=5e-5, err_msg=k)
    for r, rows in ((0, 0), (2, 1)):
        np.testing.assert_allclose(world4[r]["sghmc"]["params"][0], _np(ref._state.params[rows]),
                                   rtol=1e-3, atol=5e-5)
    assert not np.allclose(got["fc1.weight"][0], got["fc1.weight"][1])


def test_data_rank_replicas_are_bit_equal(world4):
    for a, b in ((0, 1), (2, 3)):
        for key in ("params", "momentum"):
            assert np.array_equal(world4[a]["sghmc"][key], world4[b]["sghmc"][key]), key


def test_chain_mesh_under_scan_is_bit_equal_to_one_process(world4):
    """(4, 1), four chains, one a rank, two noisy epochs: every chain keeps
    its global identity (weights, batch plans, K1's block of the noise),
    so the assembled chains equal the one-process run bit for bit."""
    ref = world4[0]["chain41_ref"]
    for r in world4:
        for key in ("params", "momentum"):
            assert np.array_equal(r["chain41"][key], ref[key]), key
    assert not np.array_equal(ref["params"][0], ref["params"][3])


def test_pure_data_parallelism_one_chain(world4):
    """(1, 4), one chain, one noisy epoch (test_parallel.py:108-133)."""
    splits, c = _mnist()
    ref = _sghmc(splits, c, chains=1, seed=7)
    ref._run_epoch(noise_on=True)
    for r in world4:
        np.testing.assert_allclose(r["chain1"], _np(ref._state.params), rtol=2e-4, atol=1e-5)
    assert all(np.array_equal(world4[0]["chain1"], r["chain1"]) for r in world4)


def test_deep_ensemble_members_over_the_chain_axis(world4):
    """Four members on (2, 2): two a chain row, all four distinct, and equal
    to the one-process ensemble (SGD has no noise: the data split's order
    of summation only)."""
    splits, c = _mnist()
    ref = tinference.DeepEnsemble(DE_HYP, model=_mlp(c), train=splits["train"], seed=11,
                                  device="cpu").sample()
    got = world4[0]["deep_ensemble"]
    assert got["members"] == 4
    w = got["state"]["fc1.weight"]
    assert all(not np.allclose(w[i], w[j]) for i in range(4) for j in range(i))
    for k, v in ref.state.items():
        np.testing.assert_allclose(got["state"][k], _np(v), rtol=2e-4, atol=1e-5, err_msg=k)


def test_sweep_configs_over_the_chain_axis(world4):
    """K = 4 SGHMC configs, two a chain row, two noisy epochs: the same
    sweep as one process (test_parallel.py:764-821's tolerance)."""
    splits, c = _mnist()
    assert [r["sweep"]["configs"] for r in world4] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    ref = _sweep(splits, c)
    for _ in range(2):
        ref.sampler._run_epoch(noise_on=True)
    np.testing.assert_allclose(world4[0]["sweep"]["params"], _np(ref.sampler._state.params),
                               rtol=1e-3, atol=5e-5)


def test_vectorized_search_over_the_mesh(world4):
    best_hyp, best_obj, objs = world4[0]["search"]
    assert len(objs) == 4 and best_obj == max(objs) and np.isfinite(best_obj)
    assert all(r["search"] == world4[0]["search"] for r in world4)


def test_tasks_on_a_sharded_ensemble_equal_the_gathered_one(world4):
    """Prediction on the rank's members and data slice, reduced over the
    mesh, against the gathered ensemble on one rank (test_parallel.py:
    195-240)."""
    for r in world4:
        sharded, gathered = r["metrics"]
        for k in sharded:
            np.testing.assert_allclose(sharded[k], gathered[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    assert world4[0]["metrics"][0] == world4[3]["metrics"][0]


def test_shard_ensemble_eval_equals_every_member_on_one_rank(world4):
    r = world4[1]
    order = _sharded_logit_order(4, 2, 2)
    np.testing.assert_allclose(r["sharded_logits"], r["gathered_logits"][order], rtol=0,
                               atol=1e-6)


def test_update_hyp_over_the_mesh_rebuilds_nothing(world4):
    for r in world4:
        assert r["update_hyp"]["same"] and r["update_hyp"]["finite"]
        assert r["update_hyp"]["lr0"] == pytest.approx(0.05)


# -- the two-rank world --------------------------------------------------------------------

def _case_world2(jax_start, jax_perm, tmp: str) -> dict:
    """(1, 2): the JAX parity epoch, SWA, PreResNet-8 with BatchNorm, crop
    and flip, dropout streams, MCdropout, the runner and the refusals."""
    out = {}
    mesh = parallel.make_mesh(chain_devices=1)
    splits, c = _mnist()

    ts = _sghmc(splits, c, chains=1, seed=0, mesh=mesh, hyp={**SGHMC_HYP, "burn_in_epochs": 1})
    params_from_jax(ts.module, jax_start)
    split = ts.train
    idx = torch.from_numpy(jax_perm).view(-1, split.batch_size)
    loss = engine.train_steps(ts._state, ts._images, ts._labels, idx, spec=split.spec, epoch=0,
                              noise_on=torch.tensor(0.0), hyp=ts._hyp, lr_fn=ts._LR_FN,
                              update_fn=ts._UPDATE_FN, seeds=[1] * idx.shape[0], mesh=mesh)
    out["jax"] = {"state": _state_np(ts.module.state_dict()), "loss": float(loss)}

    swa = tinference.SWA(SWA_HYP, model=_mlp(c), train=splits["train"], seed=3, device="cpu",
                         mesh=mesh)
    swa.sample_iterative()
    out["swa"] = _np(swa.weight_mean)

    bn = _bn_sampler(mesh)
    bn._run_epoch(noise_on=False)
    out["bn"] = {"params": _np(bn._state.params),
                 "buffers": [_np(b) for b in bn.module.buffers()]}

    out["masks"] = _np(Dropout(0.2).draw((64, 200), engine._dropout_gen("cpu", 123, 0, mesh)))
    mcd = tinference.MCdropout({"lr": 0.05, "epochs": 1, "dropout": 0.2, "lengthscale": 0.01,
                                "num_samples": 2, "momentum": 0.9, "weight_decay": 0},
                               model=_mlp(c), model_name="MLP200MNIST", train=splits["train"],
                               seed=4, device="cpu", mesh=mesh)
    mcd_ens = mcd.sample()
    out["mcdropout"] = {"params": _np(mcd._state.params),
                        "metrics": _prediction(mcd_ens, splits["test"], c)}

    from ursabench_tpu_torch import experiment

    save = str(pathlib.Path(tmp) / "run")
    groups, new_group = [], torch.distributed.new_group

    def counted(*a, **kw):
        groups.append(a)
        return new_group(*a, **kw)

    torch.distributed.new_group = counted
    try:
        out["run"] = experiment.main(RUN_ARGV + ["--save_path", save], device="cpu")
    finally:
        torch.distributed.new_group = new_group
    out["run_groups"] = len(groups)
    refusals = {}
    for name, call in (
            ("HMC", lambda: experiment.main(RUN_ARGV + ["--inference_method", "HMC"],
                                            device="cpu")),
            ("PCA", lambda: tinference.PCASubspaceSampler(None, model=_mlp(c),
                                                          train=splits["train"],
                                                          device="cpu", mesh=mesh)),
            ("stream", lambda: tinference.SGLD(RUN_HYP, model=_mlp(c),
                                               train=_stream(splits), device="cpu",
                                               mesh=mesh)),
            ("checkpoint", lambda: _sghmc(splits, c, chains=1, seed=0, mesh=mesh)
             .enable_auto_checkpoint(str(pathlib.Path(tmp) / "ck.npz")))):
        try:
            call()
            refusals[name] = None
        except NotImplementedError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    return out


class _StreamLike:
    """What the epoch samplers read of a ``HostStreamingSplit`` before its
    first epoch: a split with ``epoch`` streams from the host."""

    def __init__(self, split):
        self.n, self.batch_size, self.spec = split.n, split.batch_size, split.spec

    def epoch(self, device):
        raise AssertionError("not reached: the sampler refuses the mesh first")


def _stream(splits):
    return _StreamLike(splits["train"])


def _bn_sampler(mesh=None):
    """SGHMC on PreResNet-8 over 96 CIFAR-10 images with crop and flip."""
    splits, c = tdata.loaders("CIFAR10", None, batch_size=32, use_validation=False,
                              synthetic_n_train=96, synthetic_n_test=32,
                              transform_train=tmodels.get_model("PreResNet8").transform_train)
    return tinference.SGHMC({**SGHMC_HYP, "alpha": 0.5}, model=tmodels.get_model(
        "PreResNet8").build(c), train=splits["train"], seed=8, device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def jax_epoch():
    """The JAX package's one-device SGHMC epoch of MLP200MNIST, noise off:
    its start, permutation and end, as numpy."""
    import jax
    import jax.numpy as jnp

    from ursabench_tpu import data as jdata
    from ursabench_tpu import models as jmodels
    from ursabench_tpu.inference import sgmcmc as jsgmcmc

    os.environ["URSA_SYNTH_CACHE"] = "0"
    splits, c = jdata.loaders("MNIST", None, **LOADER)
    js = jsgmcmc.SGHMC({**SGHMC_HYP, "burn_in_epochs": 1}, model=jmodels.get_model(
        "MLP200MNIST").build(c), train=splits["train"], key=jax.random.PRNGKey(0))

    def numpy_state():
        return jax.tree.map(np.array, {"params": js._state.params,
                                       "batch_stats": js._state.batch_stats})

    start = numpy_state()
    _, k_perm, _, _, _ = jax.random.split(js._state.key, 5)
    perm = np.array(jax.random.permutation(k_perm, LOADER["synthetic_n_train"]))
    js._state, loss = js._epoch_fn(js._state, jnp.float32(0.0), jnp.float32(0.0),
                                   js._hyp_scalars)
    return start, perm, numpy_state(), float(loss), c


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_epoch):
    start, perm = jax_epoch[:2]
    tmp = tmp_path_factory.mktemp("world2")
    return _spawn("_case_world2", 2, tmp, start, perm, str(tmp)), tmp


def test_data_mesh_epoch_matches_the_jax_epoch(world2, jax_epoch):
    """Two data ranks over JAX's permutation from JAX's weights, the noise
    off: JAX's one-device epoch to 1e-5 (the all-reduced gradient sums in
    another order than XLA's)."""
    _, _, end, loss, c = jax_epoch
    want = params_from_jax(_mlp(c), end).state_dict()
    for r in world2[0]:
        got = r["jax"]["state"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], _np(v), rtol=0, atol=1e-5, err_msg=k)
        assert r["jax"]["loss"] == pytest.approx(loss, abs=1e-5)
    start = params_from_jax(_mlp(c), jax_epoch[0]).state_dict()
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-3


def test_swa_on_a_data_mesh_matches_one_process(world2):
    """test_parallel.py:136-169: the moments of SWA's single trajectory."""
    splits, c = _mnist()
    ref = tinference.SWA(SWA_HYP, model=_mlp(c), train=splits["train"], seed=3, device="cpu")
    ref.sample_iterative()
    for r in world2[0]:
        np.testing.assert_allclose(r["swa"], _np(ref.weight_mean), rtol=2e-4, atol=1e-5)


def test_swa_and_mcdropout_refuse_a_chain_mesh(world4):
    for r in world4:
        assert sorted(r["chain_mesh_refusals"]) == ["MCdropout", "SWA", "SWAG"]
        for msg in r["chain_mesh_refusals"].values():
            assert msg is not None and "chain=1" in msg


def _local_bn_oracle(sampler, halves: int) -> None:
    """``sampler``'s first epoch with the batch split in ``halves`` by hand:
    each part's train-mode forward on a copy of the step's module (its own
    batch statistics), the gradient the sum of the parts' cross-entropy sums
    over the whole batch, the running statistics the mean of the parts'
    updates, then the sampler's own update (the noise off)."""
    split, state = sampler.train, sampler._state
    gen = sampler._data_gens[0]
    idx = engine.epoch_indices(gen, split.n, split.batch_size)
    ox, oy, flip = draw_augment(gen, tuple(idx.shape), split.spec)
    bsz = split.batch_size
    part = bsz // halves
    for bi in range(idx.shape[0]):
        grads = torch.zeros_like(state.params)
        buffers = []
        for h in range(halves):
            rows = slice(h * part, (h + 1) * part)
            m = copy.deepcopy(sampler.module).train()
            b = idx[bi, rows]
            x = augment_normalized(normalize(sampler._images[b], split.spec), split.spec,
                                   ox[bi, rows], oy[bi, rows], flip[bi, rows])
            loss = F.cross_entropy(m(x.permute(0, 3, 1, 2).contiguous()), sampler._labels[b],
                                   reduction="sum") / bsz
            grads += torch.cat([g.reshape(-1) for g in
                                torch.autograd.grad(loss, list(m.parameters()))])
            buffers.append([t.detach().clone() for t in m.buffers()])
        with torch.no_grad():
            for t, *parts in zip(sampler.module.buffers(), *buffers):
                t.copy_(torch.stack(parts).mean(0))
        state.grads.copy_(grads.view_as(state.grads))
        lr = sampler._LR_FN(sampler._hyp, 0, bi, state.step)
        sampler._UPDATE_FN(state, sampler._hyp, lr=lr, noise_on=torch.tensor(0.0),
                           is_first_step=state.step == 0, seed=0)
        state.step += 1


def test_batchnorm_and_augmentation_on_a_data_mesh_match_the_local_bn_oracle(world2):
    """PreResNet-8, crop and flip, the noise off, one epoch (3 steps) on
    (1, 2): each data rank normalizes with its half's statistics and takes
    its half of the plan's crops and flips; the result is the hand-built
    local-BN oracle's (test_parallel.py:533-620) to 1e-5."""
    oracle = _bn_sampler()
    assert oracle.train.spec.augments
    _local_bn_oracle(oracle, 2)
    for r in world2[0]:
        np.testing.assert_allclose(r["bn"]["params"], _np(oracle._state.params), rtol=0,
                                   atol=1e-5)
        for got, want in zip(r["bn"]["buffers"], oracle.module.buffers()):
            np.testing.assert_allclose(got, _np(want), rtol=0, atol=1e-5)
    assert np.array_equal(world2[0][0]["bn"]["params"], world2[0][1]["bn"]["params"])


def test_data_ranks_draw_their_own_dropout_masks(world2):
    """Each data rank's dropout stream is its own (JAX's fold_in of the
    data index) at the configured rate; MCdropout's replicas stay equal and
    its Prediction agrees across ranks."""
    a, b = (r["masks"] for r in world2[0])
    assert not np.array_equal(a, b)
    for m in (a, b):
        assert abs(m.mean() - 0.8) < 0.02
    r0, r1 = world2[0]
    assert np.array_equal(r0["mcdropout"]["params"], r1["mcdropout"]["params"])
    assert r0["mcdropout"]["metrics"] == r1["mcdropout"]["metrics"]
    assert all(np.isfinite(v) for v in r0["mcdropout"]["metrics"].values())


def test_runner_over_two_ranks(world2, tmp_path):
    """``experiment.main`` on each of two gloo ranks, SGLD x2 chains
    (``--mesh auto``: a (2, 1) mesh, a chain a rank, the members sharded in
    every task): rank 0 writes the one CSV row; the results equal a
    one-process run's within the pure-data-parallel tolerance; the run
    builds its mesh, and so the process group of its chain column, once for
    both trials. The ranks of
    the members' mutual information (the ``model_uncertainty`` AUROCs and
    AUCPRs) are held to 2e-3, eight of the 4,096 in/out pairs: in this short
    run the mutual information of test images lies within float32 rounding
    of its neighbours' (a difference of two entropies near log 10), so the
    order of the BMA's sum, over each rank's members and then over ranks,
    can swap such ties. On a (1, 2) data mesh, with two draws of one chain
    as members, it swapped enough to move one AUROC by 1.9e-3."""
    ranks, tmp = world2
    assert [r["run_groups"] for r in ranks] == [1, 1]
    rows = (tmp / "runresults.csv").read_text().strip().splitlines()
    assert len(rows) == 1 and (tmp / "run_tests.npz").exists()
    from ursabench_tpu_torch import experiment

    ref = experiment.main(RUN_ARGV + ["--save_path", str(tmp_path / "one")], device="cpu")
    for r in ranks:
        assert sorted(r["run"]) == sorted(ref)
        for k, v in ref.items():
            tol = (dict(rtol=0, atol=2e-3) if "model_uncertainty_auc" in k
                   else dict(rtol=2e-4, atol=1e-5))
            np.testing.assert_allclose(r["run"][k], v, err_msg=k, **tol)


def test_unported_paths_over_a_mesh_name_their_sub_slice(world2):
    for r in world2[0]:
        got = r["refusals"]
        assert "open item 15c" in got["HMC"] and "open item 15c" in got["PCA"]
        assert "open item 15e" in got["stream"] and "open item 15f" in got["checkpoint"]


# -- one process: layouts, K1's blocks, refusals ---------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_layouts_equal_jax(n):
    """The port's layout rules against the JAX package's mesh functions on
    conftest's 8 virtual CPU devices (test_parallel.py:10-15, 41-44,
    306-322), for every chain count 1-8 and batch sizes None, 32, 30, 7."""
    from ursabench_tpu import parallel as jparallel

    def shape(mesh):
        return (mesh.shape["chain"], mesh.shape["data"])

    for chains in range(1, 9):
        for bsz in (None, 32, 30, 7):
            jm = jparallel.auto_mesh(chains, batch_size=bsz, n_devices=n)
            want = None if jm is None else shape(jm)
            assert tdist.auto_layout(chains, bsz, n) == want, (chains, bsz)
        assert tdist.chain_layout(chains, n) == jparallel.chain_mesh(chains, n).shape["chain"]
    assert tdist.make_layout(n) == shape(jparallel.make_mesh(n))
    for cd in (d for d in range(1, n + 1) if n % d == 0):
        assert tdist.make_layout(n, cd) == shape(jparallel.make_mesh(n, cd))


def test_one_process_meshes_span_one_rank():
    """Without a process group a mesh spans the one process: the mesh
    functions turn the layout rules into a ``Mesh`` only where it covers
    every rank (a sampler then runs unsharded), and refuse a layout of more
    ranks than the world has; ``initialize()`` joins nothing."""
    assert tdist.world_size() == 1 and parallel.auto_mesh(4) is None
    for make in (lambda: parallel.make_mesh(4), lambda: parallel.Mesh(2, 1),
                 lambda: parallel.auto_mesh(2, n_devices=4), lambda: parallel.chain_mesh(2, 2)):
        with pytest.raises(ValueError, match="initialize"):
            make()
    one = parallel.make_mesh()
    assert one.shape == {"chain": 1, "data": 1} and (one.chain_idx, one.data_idx) == (0, 0)
    assert parallel.chain_mesh(2).shape == one.shape
    splits, c = _mnist()
    assert _sghmc(splits, c, chains=2, seed=0, mesh=one).mesh is None
    parallel.initialize()  # no torchrun variables: nothing to join
    assert not torch.distributed.is_initialized()


_TORCHRUN_CHILD = """
import torch, torch.distributed as dist
from ursabench_tpu_torch import parallel
from ursabench_tpu_torch.parallel import distributed
parallel.initialize()
parallel.initialize()  # a second call finds the group made
t = torch.full((3,), 1.5)
dist.all_reduce(t)
print(dist.get_backend(), distributed.world_size(), distributed.rank(), t.tolist(),
      parallel.auto_mesh(4, 32))
dist.destroy_process_group()
"""


def test_initialize_reads_torchrun_variables():
    """``initialize()`` without arguments joins the group torchrun's
    variables describe (world size 1 here, on a localhost port; gloo
    without CUDA), and a world of one lays out no mesh."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    out = subprocess.run([sys.executable, "-c", _TORCHRUN_CHILD], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gloo", "1", "0", "[1.5,", "1.5,", "1.5]", "None"]


def _k1_case(rows: int, row_len: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    p, v, g = (torch.randn(rows, row_len, generator=gen) for _ in range(3))
    return p, v, g


@pytest.mark.parametrize("blocks", [(1, 3), (2, 2)])
def test_k1_plain_blocks_with_offsets_equal_the_whole_buffer(blocks):
    """P = 272,282 (PreResNet-20, 2 mod 4) on 4 rows, the noise on: each
    block of rows updated with its global offset equals the whole buffer's
    update bit for bit, as ranks holding chains 0.. and 1.. (or 2..) do."""
    P = 272282
    assert P % 4 == 2
    whole = _k1_case(4, P, 0)
    scalars = sghmc_scalars(lr=0.05, momentum=0.9, wd_over_n=1e-4, n_train=50000.0,
                            noise_on=1.0, is_first_step=False, device="cpu")
    sghmc_update(whole[0].view(-1), whole[1].view(-1), whole[2].view(-1), lr=0.05,
                 momentum=0.9, wd_over_n=1e-4, n_train=50000.0, noise_on=1.0,
                 is_first_step=False, seed=17)
    start = 0
    for rows in blocks:
        p, v, g = (t[start:start + rows].contiguous() for t in _k1_case(4, P, 0))
        sghmc_update(p.view(-1), v.view(-1), g.view(-1), lr=0.05, momentum=0.9,
                     wd_over_n=1e-4, n_train=50000.0, noise_on=1.0, is_first_step=False,
                     seed=17, offset=start * P, total=4 * P)
        assert torch.equal(p, whole[0][start:start + rows])
        assert torch.equal(v, whole[1][start:start + rows])
        start += rows
    # offset 0 over the whole buffer is the old call; the noise is really on
    p0, v0, g0 = _k1_case(4, P, 0)
    noise = torch.randn(4 * P, generator=torch.Generator().manual_seed(17))
    sghmc_update_flat_reference(p0.view(-1), v0.view(-1), g0.view(-1), scalars, noise)
    assert torch.equal(p0, whole[0])
    with pytest.raises(ValueError, match="does not fit"):
        sghmc_update(p0.view(-1), v0.view(-1), g0.view(-1), lr=0.05, momentum=0.9,
                     wd_over_n=1e-4, n_train=50000.0, noise_on=1.0, is_first_step=False,
                     seed=17, offset=P, total=4 * P)
