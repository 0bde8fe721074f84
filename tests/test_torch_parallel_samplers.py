"""HMC, PCA-ESS, streamed epochs, checkpoints and the runner of
ursabench_tpu_torch over the device mesh, on the CPU.

Each world of gloo ranks is spawned once per module (``test_torch_parallel.
_spawn``: a FileStore in a temporary directory, one thread a rank, a 60 s
collective timeout) and runs every case of its size in turn. Where a case
is held to one process bit for bit, rank 0 runs that one process itself,
with the same threads; where a tolerance holds it, the one process runs
here. No sharded JAX program runs (ROADMAP.md section 3): the JAX
package's one-device potential is computed here and held against the
ranks'. Tolerances:

- a chain mesh (2, 1) is bit-equal to one process under "scan" (HMC,
  PCA-ESS, the epoch samplers' checkpoints and the files they write):
  every chain keeps its global identity and its draws;
- on a data mesh (1, 2) sums run in another order: HMC's CE sum and
  gradient within 1e-6 relative of one process and of JAX's, its accept
  flags equal and its draws within 1e-5; PCA-ESS on an MLP within 1e-4;
  PreResNet-8's ESS log density within 1e-5 relative of the local-BN
  oracle (each half-batch's own statistics, as JAX's ``shard_map``);
- (2, 2) HMC within 1e-5 of one process, replicas bit-equal;
- a streamed epoch over (1, 2), per batch and chunked, bit-equal to the
  resident sharded epoch on the stream's order, replicas bit-equal;
- the runner within ``test_runner_over_two_ranks``'s limits (2e-3 on the
  ``model_uncertainty`` AUROCs, 2e-4 on the rest).

Chains over a chain axis that does not divide them, as the JAX package runs
them on conftest's virtual devices (HMC x1, PCA-ESS x1 and x3, the epoch
samplers x1 on a mesh without a data axis; HMC x3 and the epoch samplers
on (2, 2) refused): replicated on every chain rank, on (2, 1) bit-equal
to one process, on (2, 2) within the data mesh's limits above. Their
reference on (2, 2) is the JAX package's own replicated program
(``shard_map`` over a (2, 2) mesh of virtual devices): HMC's CE sum at its
init and PCA-ESS's log density at three points of one subspace, within
1e-6 relative. The runner over a mesh of 3 of 4 ranks ((3, 1) and (1, 3))
within the runner's limits, the fourth rank idle.
"""

import contextlib
import io
import json
import os
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_parallel import _np, _prediction, _spawn, _state_np

from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import experiment
from ursabench_tpu_torch import inference as tinference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import parallel
from ursabench_tpu_torch import utils_checkpoint as ckpt
from ursabench_tpu_torch.data import native
from ursabench_tpu_torch.data.transforms import draw_augment, normalize
from ursabench_tpu_torch.inference import engine
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

THIS = "test_torch_parallel_samplers"
LOADER = dict(batch_size=32, use_validation=False, synthetic_n_train=128,
              synthetic_n_test=64)
# grad_batch 41: a mesh of two data ranks rounds it down to 40 (20 rows a rank)
HMC_HYP = {"step_size": 5e-3, "num_samples": 3, "L": 2, "tau": 1.0, "burn": 0, "mass": 1.0,
           "grad_batch": 41, "draw_chunk": 2}
PCA_HYP = {"swag_lr": 0.01, "swag_wd": 1e-4, "lr_init": 0.02, "num_samples": 2,
           "swag_momentum": 0.9, "swag_burn_in_epochs": 1, "num_swag_iterates": 2, "rank": 2,
           "max_rank": 2, "temperature": 100.0, "prior_std": 1.0}
SGHMC_HYP = {"lr": 0.03, "prior_std": 1.0, "num_samples": 3, "alpha": 0.1,
             "burn_in_epochs": 1}
RUN = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--batch_size", "32",
       "--synthetic_n_train", "128", "--synthetic_n_test", "64", "--num_trials", "1",
       "--chain_strategy", "scan"]
RUNS = {
    "hmc": ["--inference_method", "HMC", "--hyperparams", json.dumps(HMC_HYP)],
    # a chain that learns (error ~0.58): in an untrained one the test images'
    # entropies tie within float32 rounding, and the data mesh's other order
    # of summation reorders them
    "stream": ["--inference_method", "SGLD", "--stream", "--stream_chunk", "2",
               "--synthetic_n_train", "256", "--hyperparams",
               json.dumps({"lr": 0.3, "prior_std": 1.0, "num_samples": 2, "burn_in_epochs": 3})],
    "checkpoint": ["--inference_method", "SGLD", "--chains", "2", "--checkpoint_every", "1",
                   "--hyperparams", json.dumps({**SGHMC_HYP, "num_samples": 2})],
}
# the runner over 3 of 4 ranks: --mesh chain lays 3 chains out as (3, 1),
# --mesh auto one chain at batch 30 as (1, 3) (a chain that learns, error
# ~0.69, over 3 epochs: the data mesh sums every step's gradient in another
# order, within 4e-8 of one process after an epoch, and at lr 0.3 more
# epochs grow that until the test images' entropies reorder)
PARTIAL_RUNS = {
    "chain3": ["--inference_method", "SGLD", "--mesh", "chain", "--chains", "3",
               "--hyperparams", json.dumps({**SGHMC_HYP, "num_samples": 2})],
    "auto1": ["--inference_method", "SGLD", "--mesh", "auto", "--chains", "1",
              "--batch_size", "30", "--synthetic_n_train", "256", "--hyperparams",
              json.dumps({"lr": 0.3, "prior_std": 1.0, "num_samples": 2, "burn_in_epochs": 1})],
}
# the replicated samplers of both worlds: (name, constructor of (train, c, mesh))
REPLICATED = {
    "hmc1": lambda train, c, mesh: _hmc(train, c, chains=1, seed=3, mesh=mesh),
    "pca1": lambda train, c, mesh: _pca(train, c, chains=1, mesh=mesh),
    "pca3": lambda train, c, mesh: _pca(train, c, chains=3, mesh=mesh),
    "sghmc1": lambda train, c, mesh: _sghmc(train, c, model="MLP200MNIST", chains=1,
                                            mesh=mesh),
}


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


# -- helpers shared by the ranks and the parent --------------------------------------------

def _mnist():
    return tdata.loaders("MNIST", None, **LOADER)


def _cifar(n):
    """PreResNet-8's CIFAR-10 train split (crops and flips) of n images,
    batch 16."""
    splits, c = tdata.loaders("CIFAR10", None, batch_size=16, use_validation=False,
                              synthetic_n_train=n, synthetic_n_test=16,
                              transform_train=tmodels.get_model("PreResNet8").transform_train)
    return splits["train"], c


def _hmc(train, c, *, chains=1, seed=0, mesh=None):
    return tinference.HMC(HMC_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                          train=train, seed=seed, chains=chains, device="cpu",
                          chain_strategy="scan", mesh=mesh)


def _pca(train, c, *, model="MLP200MNIST", chains=1, mesh=None, hyp=PCA_HYP):
    return tinference.PCASubspaceSampler(hyp, model=tmodels.get_model(model).build(c),
                                         train=train, seed=6, chains=chains, device="cpu",
                                         chain_strategy="scan", mesh=mesh)


def _sghmc(train, c, *, model, chains, mesh=None):
    return tinference.SGHMC(SGHMC_HYP, model=tmodels.get_model(model).build(c), train=train,
                            seed=5, chains=chains, device="cpu", chain_strategy="scan",
                            mesh=mesh)


def _gathered(ens) -> dict:
    return _state_np(ens.gather().state)


def _checkpointed(make, path: str, every: int, first, rest):
    """``first(sampler)`` on a sampler checkpointing to ``path`` every
    ``every`` epochs (draws), then ``rest(sampler)`` on a new one resumed
    from it: (the file after ``first``, ``rest``'s result, whether it
    resumed)."""
    part = make()
    part.enable_auto_checkpoint(path, every, resume=False)
    first(part)
    saved = ckpt.load_pytree(path)
    res = make()
    resumed = res.enable_auto_checkpoint(path, every)
    return saved, rest(res), resumed


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _files_equal(a, b) -> bool:
    a, b = _flat(a), _flat(b)
    return sorted(a) == sorted(b) and all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                                          for k in a)


def _accepts(state: dict) -> list:
    """The accept flags of a one-chain HMC trajectory (burn 0: the initial
    point and every draw): a draw moved or it did not."""
    w = state["fc1.weight"]
    return [not np.array_equal(w[i + 1], w[i]) for i in range(w.shape[0] - 1)]


# -- the two-rank world ------------------------------------------------------------------------

def _case_world2(jax_vars, tmp: str) -> dict:
    chain, data = parallel.Mesh(2, 1), parallel.Mesh(1, 2)
    tmp = pathlib.Path(tmp)
    splits, c = _mnist()
    return {
        "hmc_chain": _hmc_chain(splits["train"], c, chain, tmp),
        "hmc_data": _hmc_data(splits["train"], c, data, jax_vars),
        "pca_chain": _pca_chain(splits["train"], c, chain, tmp),
        "pca_data": _pca_data(splits["train"], c, data),
        "stream": _stream_cases(data, chain),
        "checkpoint": _checkpoint_cases(chain, data, tmp),
        "runner": _runner_cases(tmp),
        "replicated": _replicated_cases(splits, c, chain, tmp),
    }


def _replicated_run(sampler, test, c) -> dict:
    """``sampler.sample()``: the ensemble as held here and gathered, the
    accept rate, Prediction on the ensemble where it lies."""
    ens = sampler.sample()
    return {"replicated": sampler.replicated, "ids": list(sampler.chain_ids),
            "members": (ens.num_members, ens.local_members, ens.sharded),
            "state": _state_np(ens.state), "gathered": _gathered(ens),
            "accept": getattr(sampler, "accept_rate", None),
            "metrics": _prediction(ens, test, c)}


def _refusal(make) -> str | None:
    try:
        make()
    except ValueError as e:
        return str(e)
    return None


def _replicated_cases(splits, c, mesh, tmp) -> dict:
    """(2, 1), where the chain axis divides no odd chain count: HMC x1,
    PCA-ESS x1 and x3 and SGHMC x1 replicated on both ranks; PCA-ESS x3
    checkpointed every draw, then resumed from draw 1; HMC x3 and SGHMC x3
    refused; on rank 0 the same in one process."""
    train, test = splits["train"], splits["test"]
    out = {name: _replicated_run(make(train, c, mesh), test, c)
           for name, make in REPLICATED.items()}
    make = lambda: _pca(train, c, chains=3, mesh=mesh)  # noqa: E731
    saved, resumed, ok = _checkpointed(make, str(tmp / "pca3_rep.npz"), 1,
                                       lambda s: s.sample(num_samples=1), lambda s: s.sample())
    out["checkpoint"] = {"file": saved, "resumed": ok and all(
        np.array_equal(v, _gathered(resumed)[k]) for k, v in out["pca3"]["gathered"].items())}
    out["refusals"] = {
        "hmc3": _refusal(lambda: _hmc(train, c, chains=3, mesh=mesh)),
        "sghmc3": _refusal(lambda: _sghmc(train, c, model="MLP200MNIST", chains=3, mesh=mesh))}
    if mesh.rank == 0:
        out["one"] = {name: _replicated_run(make_one(train, c, None), test, c)
                      for name, make_one in REPLICATED.items()}
        one_saved, _, _ = _checkpointed(lambda: _pca(train, c, chains=3),
                                        str(tmp / "pca3_one.npz"), 1,
                                        lambda s: s.sample(num_samples=1), lambda s: None)
        out["one"]["file"] = one_saved
    return out


def _hmc_chain(train, c, mesh, tmp) -> dict:
    """(2, 1), two chains, three draws checkpointed every two; a resume
    from draw 2; on rank 0 the same in one process."""
    make = lambda: _hmc(train, c, chains=2, seed=3, mesh=mesh)  # noqa: E731
    full = make()
    ens = full.sample()
    saved, resumed, ok = _checkpointed(make, str(tmp / "hmc21.npz"), 2,
                                       lambda s: s.sample(num_samples=2), lambda s: s.sample())
    out = {"state": _gathered(ens), "accept": full.accept_rate, "ids": list(full.chain_ids),
           "members": (ens.num_members, ens.local_members), "file": saved,
           "resumed": ok and all(np.array_equal(v, _gathered(resumed)[k])
                                 for k, v in _gathered(ens).items())}
    if mesh.rank == 0:
        one = _hmc(train, c, chains=2, seed=3)
        one_saved, _, _ = _checkpointed(lambda: _hmc(train, c, chains=2, seed=3),
                                        str(tmp / "hmc_one.npz"), 2,
                                        lambda s: s.sample(num_samples=2), lambda s: None)
        out["one"] = {"state": _state_np(one.sample().state), "accept": one.accept_rate,
                      "file": one_saved}
    return out


def _hmc_data(train, c, mesh, jax_vars) -> dict:
    """(1, 2): the CE sum and gradient at JAX's weights; three draws."""
    h = _hmc(train, c, mesh=mesh)
    params_from_jax(h.module, jax_vars)
    ce = h._ce_sum(h._params.detach().clone(), grad=True)
    d = _hmc(train, c, seed=4, mesh=mesh)
    ens = d.sample()
    return {"ce": float(ce), "grad": _np(h._grads), "batches": tuple(h._batches.shape),
            "state": _gathered(ens), "accept": d.accept_rate}


def _pca_chain(train, c, mesh, tmp) -> dict:
    """(2, 1), two chains, two draws checkpointed every draw; a resume
    from draw 1; on rank 0 the same in one process."""
    make = lambda: _pca(train, c, chains=2, mesh=mesh)  # noqa: E731
    full = make()
    ens = full.sample()
    saved, resumed, ok = _checkpointed(make, str(tmp / "pca21.npz"), 1,
                                       lambda s: s.sample(num_samples=1), lambda s: s.sample())
    out = {"state": _gathered(ens), "theta": _np(mesh.chain_rows(full.current_theta)),
           "file": saved, "resumed": ok and all(np.array_equal(v, _gathered(resumed)[k])
                                                for k, v in _gathered(ens).items())}
    if mesh.rank == 0:
        one = _pca(train, c, chains=2)
        one_saved, _, _ = _checkpointed(lambda: _pca(train, c, chains=2),
                                        str(tmp / "pca_one.npz"), 1,
                                        lambda s: s.sample(num_samples=1), lambda s: None)
        out["one"] = {"state": _state_np(one.sample().state), "theta": _np(one.current_theta),
                      "file": one_saved}
    return out


def _pca_data(train, c, mesh) -> dict:
    """(1, 2): the MLP's two draws (SWA on the data mesh); PreResNet-8's
    one draw and its log density at three subspace points."""
    p = _pca(train, c, mesh=mesh)
    ens = p.sample()
    out = {"mlp": {"state": _gathered(ens), "theta": _np(p.current_theta),
                   "lnpdf": _np(p.current_lnpdf)}}
    cifar, c8 = _cifar(72)  # 4 batches of 16 and one of 8 filled with -1
    b = _pca(cifar, c8, model="PreResNet8", mesh=mesh, hyp={**PCA_HYP, "num_samples": 1})
    ens = b.sample()
    points = [torch.zeros(2), b.current_theta[0],
              torch.randn(2, generator=torch.Generator().manual_seed(0))]
    out["bn"] = {"mean": _np(b.subspace.mean), "cov_factor": _np(b.subspace.cov_factor),
                 "points": [_np(t) for t in points],
                 "lnpdf": [float(b.lnpdf(t)) for t in points],
                 "finite": all(bool(torch.isfinite(v).all()) for v in ens.state.values())}
    return out


def _stream_cases(data, chain) -> dict:
    """(1, 2): SGHMC on PreResNet-8 (crops, flips, the noise on) for an
    epoch from a stream of this rank's rows, per batch and M = 2, beside
    the resident sharded epoch driven by the stream's permutation with the
    same draws; then the refusals."""
    train, c = _cifar(64)
    nb = 64 // 16
    out = {}
    for m in (1, 2):
        stream = native.HostStreamingSplit(train.images, train.labels, 16, train.spec, seed=3,
                                           chunk_batches=m, mesh=data)
        a = _sghmc(stream, c, model="PreResNet8", chains=1, mesh=data)
        b = _sghmc(train, c, model="PreResNet8", chains=1, mesh=data)
        a._run_epoch(noise_on=True)
        idx = torch.from_numpy(native.permutation(64, 3)).view(nb, 16)
        engine.train_steps(
            b._state, b._images, b._labels, idx, spec=train.spec, epoch=0,
            noise_on=b._noise_gate.fill_(1.0), hyp=b._hyp, lr_fn=b._LR_FN,
            update_fn=b._UPDATE_FN, mesh=data,
            seeds=torch.randint(0, 2 ** 63 - 1, (nb,), generator=b._noise_gen).tolist(),
            aug=draw_augment(b._data_gens[0], (nb, 16), train.spec))
        out[m] = {"equal": all(torch.equal(x, y) for x, y in zip(
                      [a._state.params, a._state.momentum, *a.module.buffers()],
                      [b._state.params, b._state.momentum, *b.module.buffers()])),
                  "params": _np(a._state.params), "stats": dict(stream.stats),
                  "item": int(np.prod(train.images.shape[1:]))}
    refusals = {}
    for name, call in (
            ("chain", lambda: native.HostStreamingSplit(train.images, train.labels, 16,
                                                        train.spec, mesh=chain)),
            ("batch", lambda: native.HostStreamingSplit(train.images, train.labels, 15,
                                                        train.spec, data=(0, 2))),
            ("layout", lambda: _sghmc(native.HostStreamingSplit(
                train.images, train.labels, 16, train.spec), c, model="PreResNet8", chains=1,
                mesh=data))):
        try:
            call()
            refusals[name] = None
        except ValueError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    return out


def _checkpoint_cases(chain, data, tmp) -> dict:
    """SGHMC x2 on PreResNet-8 over (2, 1) and x1 on the MLP over (1, 2):
    three draws uninterrupted, and one draw (two epochs) checkpointed every
    two epochs, then a resumed sampler's two more; on rank 0 the chain
    mesh's one-process file."""
    cifar, c8 = _cifar(64)
    mnist, c = _mnist()
    out = {}
    for name, make, mesh in (
            ("chain", lambda: _sghmc(cifar, c8, model="PreResNet8", chains=2, mesh=chain), chain),
            ("data", lambda: _sghmc(mnist["train"], c, model="MLP200MNIST", chains=1,
                                    mesh=data), data)):
        full = make()
        want = [full.sample_iterative() for _ in range(3)]
        saved, got, ok = _checkpointed(make, str(tmp / f"sghmc_{name}.npz"), 2,
                                       lambda s: s.sample_iterative(),
                                       lambda s: [s.sample_iterative() for _ in range(2)])
        out[name] = {"file": saved, "resumed": ok,
                     "equal": all(torch.equal(g[k], w[k]) for g, w in zip(got, want[1:])
                                  for k in w)}
        if name == "chain" and mesh.rank == 0:
            one, _, _ = _checkpointed(lambda: _sghmc(cifar, c8, model="PreResNet8", chains=2),
                                      str(tmp / "sghmc_one.npz"), 2,
                                      lambda s: s.sample_iterative(), lambda s: None)
            out["one_file"] = one
    return out


def _runner_cases(tmp) -> dict:
    """``experiment.main`` with HMC and with ``--stream`` (one chain: a
    (1, 2) mesh) and twice with ``--checkpoint_path`` (SGLD x2: (2, 1)),
    the second run resuming; what the second printed."""
    out = {}
    for name, argv in RUNS.items():
        argv = RUN + argv + ["--save_path", str(tmp / f"run_{name}")]
        if name == "checkpoint":
            argv += ["--checkpoint_path", str(tmp / "run_ck")]
            out["checkpoint_first"] = experiment.main(argv, device="cpu")
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                out[name] = experiment.main(argv, device="cpu")
            out["printed"] = printed.getvalue()
        else:
            out[name] = experiment.main(argv, device="cpu")
    return out


@pytest.fixture(scope="module")
def jax_potential():
    """The JAX package's one-device HMC potential of MLP200MNIST (mesh
    None) at its init: the variables, the CE sum and its gradient in the
    port's parameter order."""
    import jax
    from test_torch_samplers import _as_numpy, _splits, flat_permutation

    from ursabench_tpu import models as jmodels
    from ursabench_tpu.inference import hmc as jhmc

    js_, _, c = _splits("MNIST", **LOADER)
    jh = jhmc.HMC(HMC_HYP, model=jmodels.get_model("MLP200MNIST").build(c), train=js_["train"],
                  key=jax.random.PRNGKey(0))
    variables = _as_numpy({"params": jh._params0, "batch_stats": jh._bstats})
    nlp = jh._build_fns()[0]
    theta = jh._theta0[0]
    grad = np.asarray(jax.grad(lambda t: nlp(t[None])[0])(theta))
    perm = flat_permutation(tmodels.get_model("MLP200MNIST").build(c), variables).numpy()
    return variables, float(nlp(theta[None])[0]), grad[perm]


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_potential):
    tmp = tmp_path_factory.mktemp("samplers2")
    return _spawn(f"{THIS}:_case_world2", 2, tmp, jax_potential[0], str(tmp))


# -- HMC --------------------------------------------------------------------------------------

def test_hmc_chain_mesh_is_bit_equal_to_one_process(world2):
    """(2, 1): a chain a rank, each drawing every chain's momentum and
    keeping its own, so the gathered draws, the accept rate and the
    checkpoint file equal one process's."""
    r0, r1 = (r["hmc_chain"] for r in world2)
    assert (r0["ids"], r1["ids"]) == ([0], [1]) and r0["members"] == (8, 4)
    one = r0["one"]
    for r in (r0, r1):
        assert sorted(r["state"]) == sorted(one["state"])
        for k, v in one["state"].items():
            assert np.array_equal(r["state"][k], v), k
        assert r["accept"] == one["accept"]
    assert not np.array_equal(one["state"]["fc1.weight"][4], one["state"]["fc1.weight"][5])
    assert _files_equal(r0["file"], one["file"]) and int(one["file"]["draws_done"]) == 2


def test_hmc_chain_mesh_resumes_bit_equal(world2):
    assert all(r["hmc_chain"]["resumed"] for r in world2)


def test_hmc_data_mesh_potential_matches_one_process_and_jax(world2, jax_potential):
    """(1, 2) with grad_batch 41: each rank's 20 columns of 4 batches of 40
    (one process: 4 of 41); the all-reduced CE sum and gradient within 1e-6
    relative of one process's and of JAX's one-device potential."""
    variables, jax_ce, jax_grad = jax_potential
    splits, c = _mnist()
    h = _hmc(splits["train"], c)
    params_from_jax(h.module, variables)
    ce = float(h._ce_sum(h._params.detach().clone(), grad=True))
    grad = _np(h._grads)
    assert tuple(h._batches.shape) == (4, 41)
    for r in world2:
        got = r["hmc_data"]
        assert got["batches"] == (4, 20)
        for want_ce, want_grad in ((ce, grad), (jax_ce, jax_grad)):
            assert abs(got["ce"] - want_ce) <= 1e-6 * abs(want_ce)
            assert np.linalg.norm(got["grad"] - want_grad) <= 1e-6 * np.linalg.norm(want_grad)
    assert world2[0]["hmc_data"]["ce"] == world2[1]["hmc_data"]["ce"]
    assert np.array_equal(world2[0]["hmc_data"]["grad"], world2[1]["hmc_data"]["grad"])


def test_hmc_data_mesh_draws_match_one_process(world2):
    """Three draws on (1, 2): the same accept flags as one process (the
    data ranks draw the same momenta and uniforms, so they decide alike),
    the draws within 1e-5, the replicas bit-equal."""
    splits, c = _mnist()
    one = _hmc(splits["train"], c, seed=4)
    want = _state_np(one.sample().state)
    r0, r1 = (r["hmc_data"] for r in world2)
    assert _accepts(r0["state"]) == _accepts(want) and r0["accept"] == one.accept_rate
    for k, v in want.items():
        np.testing.assert_allclose(r0["state"][k], v, rtol=0, atol=1e-5, err_msg=k)
        assert np.array_equal(r0["state"][k], r1["state"][k]), k


def _case_world4(jax_ref: dict, tmp: str) -> dict:
    mesh = parallel.Mesh(2, 2)
    splits, c = _mnist()
    h = _hmc(splits["train"], c, chains=2, seed=3, mesh=mesh)
    ens = h.sample()
    out = {"state": _gathered(ens), "accept": h.accept_rate, "ids": list(h.chain_ids),
           "batches": tuple(h._batches.shape)}
    out["replicated"] = _replicated_world4(splits, c, mesh, jax_ref)
    out["partial"] = _partial_world4(splits, c, pathlib.Path(tmp))
    return out


def _replicated_world4(splits, c, mesh, jax_ref) -> dict:
    """(2, 2): HMC x1, PCA-ESS x1 and x3 replicated over the chain axis,
    each chain's potential over 'data'; HMC x1's CE sum at the JAX
    package's init and PCA-ESS x3's log density at its subspace points;
    HMC x3 and SGHMC x1 refused, as the JAX package refuses them."""
    train, test = splits["train"], splits["test"]
    out = {name: _replicated_run(REPLICATED[name](train, c, mesh), test, c)
           for name in ("hmc1", "pca1", "pca3")}
    h = _hmc(train, c, mesh=mesh)
    params_from_jax(h.module, jax_ref["hmc_vars"])
    out["hmc_ce"] = float(h._ce_sum(h._params.detach().clone(), grad=False))
    p = _pca(train, c, chains=3, mesh=mesh)
    p._set_subspace(torch.from_numpy(jax_ref["pca_mean"]), torch.from_numpy(jax_ref["pca_cov"]))
    out["pca_lnpdf"] = [float(p.lnpdf(torch.from_numpy(t))) for t in jax_ref["pca_thetas"]]
    out["refusals"] = {
        "hmc3": _refusal(lambda: _hmc(train, c, chains=3, mesh=mesh)),
        "sghmc1": _refusal(lambda: _sghmc(train, c, model="MLP200MNIST", chains=1, mesh=mesh))}
    return out


def _partial_world4(splits, c, tmp: pathlib.Path) -> dict:
    """Meshes of 3 of the 4 ranks: ``chain_mesh(3)`` (3, 1) and
    ``auto_mesh(1, 30)`` (1, 3), their layout, an all-reduce over 'all' and
    a barrier on their ranks, a sampler refused on the idle one; the runner
    over each (``PARTIAL_RUNS``), every rank saving under its own
    directory; a mesh of 8 ranks refused."""
    me = torch.distributed.get_rank()
    out = {}
    for name, mesh in (("chain3", parallel.chain_mesh(3)), ("auto1", parallel.auto_mesh(1, 30))):
        got = {"shape": dict(mesh.shape), "active": mesh.active,
               "idx": (mesh.chain_idx, mesh.data_idx)}
        if mesh.active:
            t = torch.ones(1)
            mesh.all_reduce(t, "all")
            mesh.barrier()
            got["sum"] = float(t)
        else:
            got["refusal"] = _refusal(lambda: _hmc(splits["train"], c, mesh=mesh))
        out[name] = got
        save = tmp / f"{name}_rank{me}"
        save.mkdir()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            out[f"{name}_run"] = experiment.main(RUN + PARTIAL_RUNS[name] + [
                "--save_path", str(save / "run")], device="cpu")
        out[f"{name}_files"] = sorted(os.listdir(save))
        out[f"{name}_printed"] = printed.getvalue()
    out["too_large"] = _refusal(lambda: parallel.Mesh(4, 2))
    return out


@pytest.fixture(scope="module")
def jax_replicated():
    """The JAX package's replicated programs on a (2, 2) mesh of conftest's
    virtual devices: HMC x1's CE sum at its init (and its variables);
    PCA-ESS x3's log density at three points of one subspace (the JAX
    init's weights as the mean, a random rank-2 cov_factor), its mean and
    cov_factor in the port's parameter order. SGHMC x1's one-epoch draw on
    a (2, 1) mesh and without one; the cases its placement refuses (HMC x3
    on (2, 1) and (2, 2), SGHMC x3 on (2, 1) and x1 on (2, 2)), by the
    exception each raises."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from test_torch_samplers import _as_numpy, _splits, flat_permutation

    from ursabench_tpu import models as jmodels
    from ursabench_tpu.inference import hmc as jhmc
    from ursabench_tpu.inference import pca_subspace as jpca
    from ursabench_tpu.inference import sgmcmc as jsg
    from ursabench_tpu.inference.subspaces import SubspaceModel
    from ursabench_tpu.util import ravel

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("chain", "data"))
    chain_mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1), ("chain", "data"))
    js_, _, c = _splits("MNIST", **LOADER)

    def hmc(chains, on):
        return jhmc.HMC(HMC_HYP, model=jmodels.get_model("MLP200MNIST").build(c),
                        train=js_["train"], key=jax.random.PRNGKey(0), chains=chains, mesh=on)

    def sghmc_draw(chains, on):
        s = jsg.SGHMC(dict(SGHMC_HYP, burn_in_epochs=0),
                      model=jmodels.get_model("MLP200MNIST").build(c), train=js_["train"],
                      key=jax.random.PRNGKey(0), chains=chains, mesh=on)
        return _as_numpy(s.sample(num_samples=1).params)

    sghmc1 = {"chain_mesh": sghmc_draw(1, chain_mesh), "none": sghmc_draw(1, None)}
    refusals = {}
    for name, run in (("hmc3_21", lambda: hmc(3, chain_mesh)), ("hmc3_22", lambda: hmc(3, mesh)),
                      ("sghmc3_21", lambda: sghmc_draw(3, chain_mesh)),
                      ("sghmc1_22", lambda: sghmc_draw(1, mesh))):
        with pytest.raises((ValueError, AssertionError)) as raised:
            run()
        refusals[name] = raised.type.__name__
    jh = hmc(1, mesh)
    variables = _as_numpy({"params": jh._params0, "batch_stats": jh._bstats})
    ce = float(jh._build_fns()[0](jh._theta0)[0])
    jp = jpca.PCASubspaceSampler(PCA_HYP, model=jmodels.get_model("MLP200MNIST").build(c),
                                 train=js_["train"], key=jax.random.PRNGKey(0), chains=3,
                                 mesh=mesh)
    rng = np.random.default_rng(0)
    mean = np.asarray(ravel(jp.swa._state.params))
    cov = (0.5 * rng.normal(size=(2, mean.size)) * np.abs(mean).mean()).astype(np.float32)
    jp.subspace = SubspaceModel(jnp.asarray(mean), jnp.asarray(cov))
    lnpdf = jp._build_lnpdf()[0]
    thetas = rng.normal(size=(3, 2)).astype(np.float32)
    perm = flat_permutation(tmodels.get_model("MLP200MNIST").build(c), variables).numpy()
    return {"hmc_vars": variables, "hmc_ce": ce, "pca_mean": mean[perm],
            "pca_cov": np.ascontiguousarray(cov[:, perm]), "pca_thetas": thetas,
            "pca_lnpdf": np.asarray(lnpdf(jnp.asarray(thetas))), "sghmc1": sghmc1,
            "refusals": refusals}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_replicated):
    tmp = tmp_path_factory.mktemp("samplers4")
    return _spawn(f"{THIS}:_case_world4", 4, tmp, jax_replicated, str(tmp))


def test_hmc_on_a_two_by_two_mesh(world4):
    """(2, 2): two chains over the chain axis, each chain's potential over
    two data ranks: within 1e-5 of one process, the same accept rate, the
    replicas of a chain row bit-equal."""
    assert [r["ids"] for r in world4] == [[0], [0], [1], [1]]
    assert all(r["batches"] == (4, 20) for r in world4)
    splits, c = _mnist()
    one = _hmc(splits["train"], c, chains=2, seed=3)
    want = _state_np(one.sample().state)
    for r in world4:
        assert r["accept"] == one.accept_rate
        for k, v in want.items():
            np.testing.assert_allclose(r["state"][k], v, rtol=0, atol=1e-5, err_msg=k)
    for k in want:
        assert np.array_equal(world4[0]["state"][k], world4[1]["state"][k]), k


# -- chains replicated over a chain axis that does not divide them ---------------------------

def _close(got: dict, want: dict, **tol) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)


@pytest.mark.parametrize("name", list(REPLICATED))
def test_replicated_chains_on_a_chain_mesh_are_bit_equal_to_one_process(world2, name):
    """(2, 1) with one chain (and PCA-ESS's three): every rank holds every
    chain and its draws, accept rate and Prediction are one process's, bit
    for bit; the ensemble records its members as replicated, so nothing is
    summed over the chain ranks."""
    one = world2[0]["replicated"]["one"][name]
    chains = 3 if name == "pca3" else 1
    for r in world2:
        got = r["replicated"][name]
        assert got["replicated"] and got["ids"] == list(range(chains))
        assert got["members"] == (one["members"][0],) * 2 + (False,)
        for key in ("state", "gathered"):
            assert sorted(got[key]) == sorted(one["state"])
            assert all(np.array_equal(got[key][k], v) for k, v in one["state"].items())
        assert got["accept"] == one["accept"] and got["metrics"] == one["metrics"]


def test_replicated_checkpoint_resumes_bit_equal_and_equals_the_one_process_file(world2):
    """PCA-ESS x3 on (2, 1), checkpointed every draw: rank 0 writes its own
    three chains (nothing summed over 'chain'), the one-process file; each
    rank resumes all three from it, bit-equal to the uninterrupted run."""
    one = world2[0]["replicated"]["one"]["file"]
    for r in world2:
        rep = r["replicated"]["checkpoint"]
        assert rep["resumed"] and _files_equal(rep["file"], one)
    assert sorted(one["generators"]) == ["ess0", "ess1", "ess2"]
    assert one["theta"].shape[0] == 3


def test_replicated_refusals_follow_the_jax_package(world2, world4, jax_replicated):
    """Where the JAX package's placement over the chain axis raises (HMC x3
    on (2, 1) and (2, 2); an epoch sampler x3 on (2, 1), x1 on (2, 2)), the
    port keeps its ValueError."""
    assert jax_replicated["refusals"] == {"hmc3_21": "ValueError", "hmc3_22": "ValueError",
                                          "sghmc3_21": "ValueError",
                                          "sghmc1_22": "AssertionError"}
    for r in world2:
        got = r["replicated"]["refusals"]
        assert all("do not split over a chain axis of 2" in got[k] for k in ("hmc3", "sghmc3"))
    for r in world4:
        got = r["replicated"]["refusals"]
        assert all("do not split over a chain axis of 2" in got[k] for k in ("hmc3", "sghmc1"))


def test_the_jax_package_runs_an_epoch_samplers_one_chain_whole_on_a_chain_mesh(
        world2, jax_replicated):
    """JAX's SGHMC x1 on a (2, 1) mesh leaves its one chain unplaced: its
    one-epoch draw is the one-device draw, bit for bit. The port replicates
    that chain on both ranks of its (2, 1) mesh, each rank holding it
    whole."""
    def leaves(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key in sorted(tree)
                    for k, v in leaves(tree[key], f"{path}/{key}").items()}
        return {path: tree}

    got, want = (leaves(jax_replicated["sghmc1"][k]) for k in ("chain_mesh", "none"))
    assert sorted(got) == sorted(want) and want
    assert all(np.array_equal(got[k], v) for k, v in want.items())
    for r in world2:
        rep = r["replicated"]["sghmc1"]
        assert rep["replicated"] and rep["ids"] == [0]


@pytest.mark.parametrize("name", ["hmc1", "pca1", "pca3"])
def test_replicated_chains_on_a_two_by_two_mesh_match_one_process(world4, name):
    """(2, 2): both chain rows run every chain, each with its potential over
    its two data ranks, so the four ranks are bit-equal; the draws within
    the data mesh's limits of one process (HMC 1e-5 with the same accept
    rate, PCA-ESS 1e-4), and Prediction on the replicated ensemble within
    the runner's limits of one process's and within 1e-6 of the same
    ensemble gathered (a member counted twice would double the BMA's
    sums)."""
    splits, c = _mnist()
    sampler = REPLICATED[name](splits["train"], c, None)
    want = _replicated_run(sampler, splits["test"], c)
    first = world4[0]["replicated"][name]
    for r in world4:
        got = r["replicated"][name]
        assert got["replicated"] and got["members"] == (want["members"][0],) * 2 + (False,)
        assert all(np.array_equal(got["state"][k], v) for k, v in first["state"].items())
        _close(got["state"], want["state"], rtol=0, atol=1e-5 if name == "hmc1" else 1e-4)
        assert got["accept"] == want["accept"]
        _close(got["metrics"], want["metrics"], rtol=2e-4, atol=1e-5)
        gathered = _prediction(tinference.Ensemble(sampler.module, {
            k: torch.from_numpy(v) for k, v in got["gathered"].items()}, got["members"][0]),
            splits["test"], c)
        _close(got["metrics"], gathered, rtol=1e-6, atol=1e-7)


def test_replicated_potentials_match_the_jax_packages_replicated_programs(world4, jax_replicated):
    """On (2, 2) the JAX package replicates HMC's chain and PCA-ESS's three
    chains over 'chain' (``c_ax = None``) and sums each potential over
    'data': HMC's CE sum at the JAX init and PCA-ESS's log density at three
    subspace points, on every rank, within 1e-6 relative of JAX's."""
    for r in world4:
        got = r["replicated"]
        assert abs(got["hmc_ce"] - jax_replicated["hmc_ce"]) <= 1e-6 * abs(jax_replicated["hmc_ce"])
        np.testing.assert_allclose(got["pca_lnpdf"], jax_replicated["pca_lnpdf"], rtol=1e-6)
    assert np.abs(jax_replicated["pca_lnpdf"]).min() > 0.1


# -- a mesh over part of the world -----------------------------------------------------------

def test_partial_meshes_leave_the_last_rank_idle(world4):
    """``chain_mesh(3)`` and ``auto_mesh(1, 30)`` over four ranks lay out
    (3, 1) and (1, 3) over ranks 0-2, as the JAX package takes the first
    three devices: 'all' sums over those three, rank 3 idles and refuses a
    sampler; a mesh of more ranks than the world still raises."""
    for name, shape in (("chain3", {"chain": 3, "data": 1}), ("auto1", {"chain": 1, "data": 3})):
        got = [r["partial"][name] for r in world4]
        assert all(g["shape"] == shape for g in got)
        assert [g["active"] for g in got] == [True, True, True, False]
        assert [g["idx"] for g in got][3] == (None, None)
        assert [g["sum"] for g in got[:3]] == [3.0] * 3
        assert "outside the mesh of 3 ranks" in got[3]["refusal"]
    assert all("needs that many processes" in r["partial"]["too_large"] for r in world4)


@pytest.mark.parametrize("name", list(PARTIAL_RUNS))
def test_runner_over_part_of_the_world(world4, tmp_path, name):
    """``experiment.main`` on four ranks with ``--mesh chain --chains 3``
    ((3, 1)) and ``--mesh auto --chains 1 --batch_size 30`` ((1, 3)): rank
    0 writes the CSV row and the ``.npz``, its results (and ranks 1-2's)
    within ``test_runner_over_two_ranks``'s limits of one process's; rank 3
    returns None having written nothing."""
    argv = RUN + PARTIAL_RUNS[name] + ["--save_path", str(tmp_path / "one")]
    ref = experiment.main(argv, device="cpu")
    for rank, r in enumerate(world4):
        got, files = r["partial"][f"{name}_run"], r["partial"][f"{name}_files"]
        if rank == 3:
            assert got is None and files == []
            assert "rank 3 idles" in r["partial"][f"{name}_printed"]
            continue
        assert files == (["run_tests.npz", "runresults.csv"] if rank == 0 else [])
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            tol = (dict(rtol=0, atol=2e-3) if "model_uncertainty_au" in k
                   else dict(rtol=2e-4, atol=1e-5))
            np.testing.assert_allclose(got[k], v, err_msg=k, **tol)


# -- PCA-ESS ----------------------------------------------------------------------------------

def test_pca_chain_mesh_is_bit_equal_to_one_process(world2):
    """(2, 1): each rank runs the whole SWA phase and its chain's ESS with
    the generator ``ess<c>`` of its global chain: the gathered draws, the
    coordinates and the checkpoint file equal one process's; a resume from
    draw 1 equals the uninterrupted run."""
    r0, r1 = (r["pca_chain"] for r in world2)
    one = r0["one"]
    for r in (r0, r1):
        for k, v in one["state"].items():
            assert np.array_equal(r["state"][k], v), k
        assert np.array_equal(r["theta"], one["theta"]) and r["resumed"]
    assert not np.array_equal(one["theta"][0], one["theta"][1])
    assert _files_equal(r0["file"], one["file"])
    assert sorted(one["file"]["generators"]) == ["ess0", "ess1"]


def test_pca_data_mesh_matches_one_process_on_an_mlp(world2):
    """(1, 2) on MLP200MNIST (no BatchNorm): the SWA phase on the data mesh
    and the data-parallel log density give one process's draws within
    1e-4 and its log density within 1e-5 relative; replicas bit-equal."""
    splits, c = _mnist()
    one = _pca(splits["train"], c)
    want = _state_np(one.sample().state)
    r0, r1 = (r["pca_data"]["mlp"] for r in world2)
    np.testing.assert_allclose(r0["theta"], _np(one.current_theta), rtol=0, atol=1e-4)
    np.testing.assert_allclose(r0["lnpdf"], _np(one.current_lnpdf), rtol=1e-5)
    for k, v in want.items():
        np.testing.assert_allclose(r0["state"][k], v, rtol=0, atol=1e-4, err_msg=k)
        assert np.array_equal(r0["state"][k], r1["state"][k]), k


def _local_bn_lnpdf(train, c, mean, cov_factor, theta, halves=2) -> float:
    """The ESS log density of PreResNet-8 at subspace point ``theta`` with
    each batch split in ``halves`` by hand: each part's train-mode forward
    (its own batch statistics), the cross entropy masked as the sampler's
    (the last batch filled up with -1)."""
    m = tmodels.get_model("PreResNet8").build(c)
    params, _ = engine.flatten_parameters(m)
    with torch.no_grad():
        params.copy_(torch.from_numpy(mean) + torch.from_numpy(theta) @ torch.from_numpy(
            cov_factor))
    m.train()
    images, labels = train.device_tensors("cpu")
    batches = engine._sharded_batches(train.n, train.batch_size, None, "cpu")
    part = train.batch_size // halves
    total = 0.0
    with torch.no_grad():
        for b in batches:
            valid, b = (b >= 0).to(torch.float32), b.clamp_min(0)
            for h in range(halves):
                rows = slice(h * part, (h + 1) * part)
                x = normalize(images[b[rows]], train.spec).permute(0, 3, 1, 2).contiguous()
                ce = F.cross_entropy(m(x), labels[b[rows]], reduction="none")
                total += float(torch.sum(ce * valid[rows]))
    return -total / PCA_HYP["temperature"]


def test_pca_data_mesh_batchnorm_matches_the_local_bn_oracle(world2):
    """PreResNet-8 on (1, 2), 72 images in batches of 16 (the last one half
    filled with -1, which lands on rank 1): the ESS log density at three
    subspace points equals the local-BN oracle's within 1e-5 relative, ten
    times closer at least than to the one-process density (whole-batch
    statistics)."""
    train, c = _cifar(72)
    r0, r1 = (r["pca_data"]["bn"] for r in world2)
    assert r0["finite"] and r0["lnpdf"] == r1["lnpdf"]
    for theta, got in zip(r0["points"], r0["lnpdf"]):
        want = _local_bn_lnpdf(train, c, r0["mean"], r0["cov_factor"], theta)
        assert got == pytest.approx(want, rel=1e-5)
        whole = _local_bn_lnpdf(train, c, r0["mean"], r0["cov_factor"], theta, halves=1)
        assert abs(got - want) * 10 < abs(got - whole)


# -- streamed epochs ------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 2])
def test_streamed_epoch_over_a_data_mesh_equals_the_resident_sharded_epoch(world2, chunk):
    """SGHMC on PreResNet-8 over (1, 2), crops, flips and the noise on: the
    epoch streamed from each rank's rows (per batch, and M = 2) equals the
    resident sharded epoch on the stream's permutation with the same crops,
    flips and noise seeds, bit for bit; the replicas are bit-equal; each
    rank moved half of every batch (8 of 16 images and labels)."""
    r0, r1 = (r["stream"][chunk] for r in world2)
    assert r0["equal"] and r1["equal"]
    assert np.array_equal(r0["params"], r1["params"])
    for r in (r0, r1):
        assert r["stats"]["transfers"] == 4 // chunk
        assert r["stats"]["bytes"] == 4 * 8 * (r["item"] + 4)  # uint8 pixels, int32 labels


def test_streaming_over_a_mesh_refuses_a_chain_axis_an_uneven_batch_and_another_layout(world2):
    got = world2[0]["stream"]["refusals"]
    assert "chain axis must be 1" in got["chain"]
    assert "does not split over 2 data ranks" in got["batch"]
    assert "data layout" in got["layout"]


# -- checkpoints of the epoch samplers ------------------------------------------------------

def test_chain_mesh_checkpoint_resumes_bit_equal_and_equals_the_one_process_file(world2):
    """SGHMC x2 on PreResNet-8 over (2, 1), checkpointed every two epochs:
    rank 0 writes the one-process file (every chain's parameters, momenta,
    BatchNorm buffers and generators, named by global chain), which equals
    one process's; a new sampler on each rank resumes its chain from it,
    bit-equal to the uninterrupted run."""
    r0, r1 = (r["checkpoint"] for r in world2)
    for r in (r0, r1):
        assert r["chain"]["resumed"] and r["chain"]["equal"]
    one = r0["one_file"]
    assert _files_equal(r0["chain"]["file"], one) and _files_equal(r1["chain"]["file"], one)
    assert sorted(one["generators"]) == ["data0", "data1", "dropout0", "noise"]
    assert int(one["epochs_run"]) == 2 and one["params"].shape[0] == 2
    assert any(k.endswith("running_mean") for k in one["batch_stats"])


def test_data_mesh_checkpoint_resumes_bit_equal(world2):
    for r in world2:
        assert r["checkpoint"]["data"]["resumed"] and r["checkpoint"]["data"]["equal"]


# -- the runner -------------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hmc", "stream", "checkpoint_first", "checkpoint"])
def test_runner_over_two_ranks_with_hmc_stream_and_checkpoints(world2, tmp_path, name):
    """``experiment.main`` on two gloo ranks against one process: HMC on
    (1, 2) (its data-parallel potential), ``--stream --stream_chunk 2`` on
    (1, 2), and SGLD x2 on (2, 1) with
    ``--checkpoint_path`` twice, the second resuming every rank's chain
    (rank 0 wrote the file); within ``test_runner_over_two_ranks``'s
    limits."""
    run = "checkpoint" if name.startswith("checkpoint") else name
    argv = RUN + RUNS[run] + ["--save_path", str(tmp_path / "one")]
    if run == "checkpoint":
        argv += ["--checkpoint_path", str(tmp_path / "ck")]
        first = experiment.main(argv, device="cpu")
        ref = first if name == "checkpoint_first" else experiment.main(argv, device="cpu")
    else:
        ref = experiment.main(argv, device="cpu")
    for r in world2:
        got = r["runner"][name]
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            tol = (dict(rtol=0, atol=2e-3) if "model_uncertainty_au" in k
                   else dict(rtol=2e-4, atol=1e-5))
            np.testing.assert_allclose(got[k], v, err_msg=k, **tol)
    if name == "checkpoint":
        for rank, r in enumerate(world2):
            assert f"resumed chain at epoch 3 (rank {rank})" in r["runner"]["printed"]
