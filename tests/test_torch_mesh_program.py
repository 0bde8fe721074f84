"""The sharded programs of ursabench_tpu_torch on the CPU: the epoch
samplers' resident, streamed and dropout epochs and HMC's and PCA-ESS's
potentials through ``engine``'s programs on a device mesh, where a program
runs its step eagerly: on a chain mesh the step the card captures whole, on
a data mesh its two segments and, between them, the hook's all-reduces.

Each world of gloo ranks is spawned once (``test_torch_parallel._spawn``)
and runs every case of its size. Held bit for bit on each rank:

- ``parallel.mesh.StaticReduce`` against ``Mesh.all_reduce`` (the sums) and
  ``all_reduce_many(mean=True)`` (the means), one buffer a dtype;
- the programmed sharded epoch against ``train_steps(..., mesh=)`` (the
  program hidden): PreResNet-8 with crops, flips and the noise on, under
  "scan" and "vmap", on (2, 1), (1, 2) and (2, 2); a data mesh's step
  all-reduces twice (the gradient buffer, one packed float32 buffer),
  a chain mesh's never;
- the streamed programs, per batch and chunked, against
  ``stream_steps(..., mesh=)`` on (1, 2);
- MCdropout on (1, 2) against its eager epochs, each data rank drawing its
  own masks;
- HMC's and PCA-ESS's programs on (1, 2) against ``_ce_sum``,
  ``_ce_sums``, ``_plain_lnpdf`` and ``_plain_lnpdf_chains`` with their
  all-reduce, and their draws against the eager twins';
- a K = 2 sweep on (2, 1) against its eager twin, its rows at their
  offsets.

Against the JAX package: the programmed (1, 2) epoch of MLP200MNIST from
JAX's weights over JAX's permutation, the noise off, against
``_make_sharded_epoch_fn``'s epoch on two of conftest's virtual devices,
to 1e-5 (``test_torch_parallel.py``'s data-mesh tolerance).
"""

import numpy as np
import pytest
import torch
from test_torch_parallel import _np, _spawn, _state_np

from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import inference as tinference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import parallel
from ursabench_tpu_torch.data import native
from ursabench_tpu_torch.inference import engine
from ursabench_tpu_torch.parallel.mesh import StaticReduce
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

THIS = "test_torch_mesh_program"
LOADER = dict(batch_size=32, use_validation=False, synthetic_n_train=128,
              synthetic_n_test=64)
SGHMC_HYP = {"lr": 0.03, "prior_std": 1.0, "num_samples": 2, "alpha": 0.5,
             "burn_in_epochs": 1}
MCD_HYP = {"lr": 0.05, "epochs": 1, "dropout": 0.2, "lengthscale": 0.01, "num_samples": 2,
           "momentum": 0.9, "weight_decay": 0}
HMC_HYP = {"step_size": 5e-3, "num_samples": 2, "L": 2, "tau": 1.0, "burn": 0, "mass": 1.0,
           "grad_batch": 41}
PCA_HYP = {"swag_lr": 0.01, "swag_wd": 1e-4, "lr_init": 0.02, "num_samples": 2,
           "swag_momentum": 0.9, "swag_burn_in_epochs": 1, "num_swag_iterates": 2, "rank": 2,
           "max_rank": 2, "temperature": 100.0, "prior_std": 1.0}
STRATEGIES = ("scan", "vmap")


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


# -- helpers of the ranks ---------------------------------------------------------------------

def _mnist():
    return tdata.loaders("MNIST", None, **LOADER)


def _cifar():
    """PreResNet-8's CIFAR-10 train split (crops and flips): 64 images,
    batch 16."""
    splits, c = tdata.loaders("CIFAR10", None, batch_size=16, use_validation=False,
                              synthetic_n_train=64, synthetic_n_test=16,
                              transform_train=tmodels.get_model("PreResNet8").transform_train)
    return splits["train"], c


def _eager(sampler):
    """``sampler``'s eager twin: its programs hidden, so it runs the plain
    versions (``train_steps``, ``stream_steps``, ``_ce_sum``, ...)."""
    sampler.epoch_program = lambda: None
    sampler.potential_program = lambda grad, batched: None
    sampler.density_program = lambda rows: None
    return sampler


def _counted(fn):
    """``fn()`` and the ``dist.all_reduce`` calls it made."""
    calls, all_reduce = [], torch.distributed.all_reduce

    def counting(tensor, *a, **kw):
        calls.append((tensor.dtype, tensor.numel()))
        return all_reduce(tensor, *a, **kw)

    torch.distributed.all_reduce = counting
    try:
        fn()
    finally:
        torch.distributed.all_reduce = all_reduce
    return calls


def _equal_states(a, b) -> bool:
    tensors = [(x._state.params, x._state.momentum, *[t for m in x.modules for t in m.buffers()])
               for x in (a, b)]
    return (a._state.step == b._state.step and all(torch.equal(x, y) for x, y in zip(*tensors))
            and all(torch.equal(x, y) for x, y in zip(a.epoch_losses, b.epoch_losses)))


def _epoch_pair(make, epochs: int = 1) -> dict:
    """``make()``'s sampler through its program and its eager twin, the
    same epochs (the noise on): whether they are bit-equal, the program's
    segments and steps, and the all-reduces of a step on each path."""
    prog, eager = make(), _eager(make())
    steps = prog.train.num_batches
    calls = [_counted(lambda s=s: [s._run_epoch(noise_on=True) for _ in range(epochs)])
             for s in (prog, eager)]
    program = prog._program
    return {"equal": _equal_states(prog, eager), "graph": prog.step_program,
            "mesh": program.mesh is prog.mesh, "segments": program.segments,
            "steps_run": program.steps_run, "steps": epochs * steps,
            "buffers": None if program._reduce is None else len(program._reduce.buffers),
            "calls": [len(c) / (epochs * steps) for c in calls],
            "params": _np(prog._state.params)}


def _sghmc(train, c, model, chains, mesh, strategy="scan", cls=tinference.SGHMC):
    return cls(SGHMC_HYP, model=tmodels.get_model(model).build(c), train=train, seed=5,
               chains=chains, device="cpu", chain_strategy=strategy, mesh=mesh)


def _epoch_cases(meshes: dict) -> dict:
    train, c = _cifar()
    return {f"{shape}_{strategy}": _epoch_pair(
                lambda: _sghmc(train, c, "PreResNet8", chains, mesh, strategy))
            for shape, (mesh, chains) in meshes.items() for strategy in STRATEGIES}


def _static_reduce_case(mesh) -> dict:
    """Two float32 and one float64 tensor summed, three statistics
    averaged, each rank's own values: the static reduce against
    ``all_reduce`` and ``all_reduce_many(mean=True)``."""
    gen = torch.Generator().manual_seed(10 + mesh.data_idx)
    sums = [torch.randn(3, generator=gen), torch.randn(2, 2, generator=gen),
            torch.randn(4, generator=gen, dtype=torch.float64)]
    means = [torch.randn(5, generator=gen), torch.rand(5, generator=gen),
             torch.randn(7, generator=gen, dtype=torch.float64)]
    want_sums = [mesh.all_reduce(t.clone(), "data") for t in sums]
    want_means = [t.clone() for t in means]
    mesh.all_reduce_many(want_means, "data", mean=True)
    got_means = [t.clone() for t in means]
    red = StaticReduce(mesh, "data", sums, got_means)
    red.pack(sums)
    calls = _counted(red.reduce)
    got_sums = red.unpack()
    return {"sums": all(torch.equal(g, w) for g, w in zip(got_sums, want_sums)),
            "means": all(torch.equal(g, w) for g, w in zip(got_means, want_means)),
            "calls": sorted((str(d), n) for d, n in calls),
            "moved": not torch.equal(got_means[0], means[0])}


def _stream_cases(mesh) -> dict:
    """SGHMC on PreResNet-8 (crops, flips, the noise on) streamed from this
    rank's rows, per batch and M = 2: program against ``stream_steps``."""
    train, c = _cifar()
    out = {}
    for m in (1, 2):
        def make():
            stream = native.HostStreamingSplit(train.images, train.labels, 16, train.spec,
                                               seed=3, chunk_batches=m, mesh=mesh)
            return _sghmc(stream, c, "PreResNet8", 1, mesh)
        got = _epoch_pair(make)
        got["kind"] = type(make().epoch_program()).__name__
        out[m] = got
    return out


def _mcdropout_case(mesh) -> dict:
    """MCdropout on MLP200MNIST over (1, 2): its program against its eager
    epochs; the keep masks of the last step."""
    splits, c = _mnist()

    def make():
        return tinference.MCdropout(MCD_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                                    model_name="MLP200MNIST", train=splits["train"], seed=4,
                                    device="cpu", mesh=mesh)

    out = _epoch_pair(make)
    s = make()
    s._run_epoch()
    out["masks"] = [_np(m) for m in s._program.dropout.masks]
    return out


def _hmc_case(mesh) -> dict:
    """HMC on MLP200MNIST over (1, 2): the programs' CE sums and gradients
    (one chain, and two under "vmap") against the plain versions with their
    all-reduce; a chain's draws through the programs and through the plain
    potentials."""
    splits, c = _mnist()

    def make(chains=1, strategy="scan", seed=3):
        return tinference.HMC(HMC_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                              train=splits["train"], seed=seed, chains=chains, device="cpu",
                              chain_strategy=strategy, mesh=mesh)

    out = {}
    for name, h, plain in (("scan", make(), "_ce_sum"), ("vmap", make(2, "vmap"), "_ce_sums")):
        theta = h._theta0.clone() if name == "vmap" else h._theta0[0].clone()
        grads = h._chain_grads if name == "vmap" else h._grads
        got = [(h._ce(theta, grad).clone(), grads.clone()) for grad in (True, False)]
        want = [(getattr(h, plain)(theta, grad).clone(), grads.clone()) for grad in (True, False)]
        out[name] = {"ce": all(torch.equal(g[0], w[0]) for g, w in zip(got, want)),
                     "grad": torch.equal(got[0][1], want[0][1]),
                     "programs": sorted(k[0] for k in h._programs),
                     "batches": tuple(h._batches.shape), "value": float(got[0][0].sum())}
    prog, eager = make(seed=4), _eager(make(seed=4))
    a, b = prog.sample(), eager.sample()
    out["draws"] = (all(torch.equal(a.state[k], v) for k, v in b.state.items())
                    and prog.accept_rate == eager.accept_rate and not eager._programs)
    out["state"] = _state_np(a.state)
    return out


def _pca_case(mesh) -> dict:
    """PCA-ESS on MLP200MNIST over (1, 2) (SWA's epochs through the sharded
    program): the density programs against ``_plain_lnpdf`` and
    ``_plain_lnpdf_chains``; the draws against the eager twin's."""
    splits, c = _mnist()

    def make():
        return tinference.PCASubspaceSampler(
            PCA_HYP, model=tmodels.get_model("MLP200MNIST").build(c), train=splits["train"],
            seed=6, device="cpu", chain_strategy="scan", mesh=mesh)

    prog, eager = make(), _eager(make())
    a, b = prog.sample(), eager.sample()
    theta = torch.stack([prog.current_theta[0], torch.full((2,), 0.3)])
    out = {"draws": all(torch.equal(a.state[k], v) for k, v in b.state.items()),
           "swa": prog.swa._program is not None and prog.swa._program.segments == 2,
           "lnpdf": torch.equal(prog.lnpdf(theta[0]), prog._plain_lnpdf(theta[0])),
           "chains": torch.equal(prog.lnpdf_chains(theta), prog._plain_lnpdf_chains(theta)),
           "programs": sorted(str(k) for k in prog._programs)}
    return out


def _sweep_case(mesh) -> dict:
    """A K = 2 SGHMC sweep over (2, 1), one config a rank: its program
    against its eager twin, two epochs; K1's block of the noise."""
    splits, c = _mnist()

    def make():
        hyps = [{**SGHMC_HYP, "lr": lr} for lr in (0.01, 0.05)]
        sampler = tinference.MethodSweep(hyps, model=tmodels.get_model("MLP200MNIST").build(c),
                                         train=splits["train"], seed=6, mesh=mesh,
                                         device="cpu").sampler
        return sampler

    out = _epoch_pair(make, epochs=2)
    s = make()
    out["block"] = s._state.noise_block()
    out["program_state"] = s.epoch_program().state is s._state
    return out


def _jax_case(mesh, jax_start, jax_perm) -> dict:
    """The (1, 2) epoch program of MLP200MNIST from JAX's weights over
    JAX's permutation, the noise off."""
    splits, c = _mnist()
    s = tinference.SGHMC({**SGHMC_HYP, "alpha": 0.1}, model=tmodels.get_model(
        "MLP200MNIST").build(c), train=splits["train"], seed=0, device="cpu", mesh=mesh)
    params_from_jax(s.module, jax_start)
    split = s.train
    prog = engine.make_epoch_fn(s._state, split, s._images, s._labels, hyp=s._hyp,
                                noise_on=torch.tensor(0.0), lr_fn=s._LR_FN,
                                update_fn=s._UPDATE_FN, mesh=mesh)
    idx = torch.from_numpy(jax_perm).view(-1, split.batch_size)
    loss = prog(idx, epoch=0, seeds=[1] * idx.shape[0])
    return {"state": _state_np(s.module.state_dict()), "loss": float(loss),
            "segments": prog.segments, "steps": prog.steps_run}


def _case_world2(jax_start, jax_perm) -> dict:
    chain, data = parallel.Mesh(2, 1), parallel.Mesh(1, 2)
    splits, c = _mnist()
    replicated = _sghmc(splits["train"], c, "MLP200MNIST", 1, chain)
    replicated._run_epoch(noise_on=True)
    return {
        "reduce": _static_reduce_case(data),
        "epochs": _epoch_cases({(2, 1): (chain, 4), (1, 2): (data, 2)}),
        "stream": _stream_cases(data),
        "mcdropout": _mcdropout_case(data),
        "hmc": _hmc_case(data),
        "pca": _pca_case(data),
        "sweep": _sweep_case(chain),
        "replicated": (replicated.replicated, replicated.step_program,
                       replicated._program.segments, replicated._program.steps_run),
        "jax": _jax_case(data, jax_start, jax_perm),
    }


def _case_world4() -> dict:
    mesh = parallel.Mesh(2, 2)
    return {"epochs": _epoch_cases({(2, 2): (mesh, 4)}), "ids": (mesh.chain_idx, mesh.data_idx)}


# -- the JAX package's sharded epoch ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded_epoch():
    """The JAX package's SGHMC epoch of MLP200MNIST on a (1, 2) mesh of
    conftest's virtual devices (``_make_sharded_epoch_fn``), the noise off:
    its start, permutation, end and loss, as numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ursabench_tpu import data as jdata
    from ursabench_tpu import models as jmodels
    from ursabench_tpu.inference import sgmcmc as jsgmcmc

    splits, c = jdata.loaders("MNIST", None, **LOADER)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("chain", "data"))
    js = jsgmcmc.SGHMC({**SGHMC_HYP, "alpha": 0.1}, model=jmodels.get_model(
        "MLP200MNIST").build(c), train=splits["train"], key=jax.random.PRNGKey(0), mesh=mesh)

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
def world2(tmp_path_factory, jax_sharded_epoch):
    start, perm = jax_sharded_epoch[:2]
    return _spawn(f"{THIS}:_case_world2", 2, tmp_path_factory.mktemp("world2"), start, perm)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(f"{THIS}:_case_world4", 4, tmp_path_factory.mktemp("world4"))


# -- the tests --------------------------------------------------------------------------------

def test_static_reduce_equals_all_reduce_many_bit_for_bit(world2):
    """One all-reduce a dtype, each value the sum or mean the mesh's own
    collectives give it."""
    for r in world2:
        got = r["reduce"]
        assert got["sums"] and got["means"] and got["moved"]
        assert got["calls"] == [("torch.float32", 3 + 4 + 5 + 5), ("torch.float64", 4 + 7)]


def _check_epochs(ranks, shapes):
    for r in ranks:
        for shape in shapes:
            for strategy in STRATEGIES:
                got = r["epochs"][f"{shape}_{strategy}"]
                assert got["equal"], (shape, strategy)
                assert got["graph"] == "graph" and got["mesh"]
                assert got["steps_run"] == got["steps"] == 4
                data = shape[1] > 1
                assert got["segments"] == (2 if data else 1)
                # between the replays: the gradient buffer and one float32 buffer
                assert got["calls"] == ([2.0, 3.0] if data else [0.0, 0.0])
                assert got["buffers"] == (1 if data else None)


def test_programmed_epoch_equals_train_steps_on_chain_and_data_meshes(world2):
    _check_epochs(world2, [(2, 1), (1, 2)])
    for strategy in STRATEGIES:  # the data ranks' replicas; the chain ranks' own chains
        a, b = (r["epochs"][f"(1, 2)_{strategy}"]["params"] for r in world2)
        assert np.array_equal(a, b)
        a, b = (r["epochs"][f"(2, 1)_{strategy}"]["params"] for r in world2)
        assert not np.array_equal(a, b)


def test_programmed_epoch_equals_train_steps_on_a_two_by_two_mesh(world4):
    _check_epochs(world4, [(2, 2)])
    by_row = {}
    for r in world4:
        by_row.setdefault(r["ids"][0], []).append(r["epochs"]["(2, 2)_scan"]["params"])
    for row in by_row.values():
        assert len(row) == 2 and np.array_equal(*row)


@pytest.mark.parametrize("m", [1, 2])
def test_streamed_programs_equal_stream_steps_on_a_data_mesh(world2, m):
    for r in world2:
        got = r["stream"][m]
        assert got["equal"] and got["kind"] == "_StreamProgram" and got["segments"] == 2
        assert got["calls"] == [2.0, 3.0] and got["steps_run"] == got["steps"] == 4
    assert np.array_equal(world2[0]["stream"][m]["params"], world2[1]["stream"][m]["params"])


def test_mcdropout_on_a_data_mesh_draws_each_ranks_masks(world2):
    """The dropout program equals the eager epochs on each rank; the two
    data ranks' masks differ, their replicas do not."""
    for r in world2:
        got = r["mcdropout"]
        assert got["equal"] and got["segments"] == 2 and len(got["masks"]) == 2
        for m in got["masks"]:
            assert abs(m.mean() - 0.8) < 0.05
    a, b = (r["mcdropout"] for r in world2)
    assert all(not np.array_equal(x, y) for x, y in zip(a["masks"], b["masks"]))
    assert np.array_equal(a["params"], b["params"])


def test_hmc_programs_on_a_data_mesh_equal_the_plain_potentials(world2):
    for r in world2:
        h = r["hmc"]
        for name in ("scan", "vmap"):
            assert h[name]["ce"] and h[name]["grad"], name
            assert h[name]["programs"] == ["ce", "grad"]
            assert h[name]["batches"] == (4, 20)  # grad_batch 41 -> 40, 20 rows a rank
        assert h["draws"]
    assert world2[0]["hmc"]["scan"]["value"] == world2[1]["hmc"]["scan"]["value"]
    a, b = (r["hmc"]["state"] for r in world2)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_pca_programs_on_a_data_mesh_equal_the_plain_densities(world2):
    for r in world2:
        p = r["pca"]
        assert p["draws"] and p["swa"] and p["lnpdf"] and p["chains"]
        assert p["programs"] == ["2", "None"]


def test_step_program_is_graph_on_every_mesh(world2, world4):
    """The epoch samplers (chain, data and both, a replicated chain, a
    sweep, streamed and with dropout), HMC and PCA-ESS: every path runs
    its program."""
    for r in world2:
        assert r["replicated"] == (True, "graph", 1, 4)
        sweep = r["sweep"]
        assert sweep["equal"] and sweep["graph"] == "graph" and sweep["segments"] == 1
        assert sweep["program_state"] and sweep["steps_run"] == 8
        assert r["mcdropout"]["graph"] == r["stream"][1]["graph"] == "graph"
    p = sum(v.size for v in world2[0]["jax"]["state"].values())  # MLP200: no buffers
    assert [r["sweep"]["block"] for r in world2] == [{"offset": 0, "total": 2 * p},
                                                     {"offset": p, "total": 2 * p}]
    assert all(r["epochs"]["(2, 2)_vmap"]["graph"] == "graph" for r in world4)


def test_programmed_data_mesh_epoch_matches_the_jax_sharded_epoch(world2, jax_sharded_epoch):
    """Two data ranks over JAX's permutation from JAX's weights, the noise
    off: the epoch program's cut step against the JAX package's
    ``shard_map`` epoch to 1e-5 (the all-reduced gradient sums in another
    order than XLA's ``psum``)."""
    _, _, end, loss, c = jax_sharded_epoch
    want = params_from_jax(tmodels.get_model("MLP200MNIST").build(c), end).state_dict()
    for r in world2:
        got = r["jax"]
        assert got["segments"] == 2 and got["steps"] == 4
        for k, v in want.items():
            np.testing.assert_allclose(got["state"][k], _np(v), rtol=0, atol=1e-5, err_msg=k)
        assert got["loss"] == pytest.approx(loss, abs=1e-5)
    start = params_from_jax(tmodels.get_model("MLP200MNIST").build(c),
                            jax_sharded_epoch[0]).state_dict()
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-3
