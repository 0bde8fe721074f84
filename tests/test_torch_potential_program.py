"""The full-batch potential programs (``engine.make_potential_fn``) of HMC
and the PCA subspace sampler against the JAX package's compiled chunk and
log density, and against the potentials' plain versions.

On the CPU a program runs its captured step eagerly, so what these tests
hold is the step's arithmetic: its static buffers, device counter, masks
and Kahan sum. HMC runs MLP200MNIST and PreResNet-8 (eval-mode BatchNorm
with non-trivial running statistics) over 96 images in gradient batches of
40, which do not divide them; JAX's momentum and uniform are injected. The
PCA densities run PreResNet-8 in train mode over 90 images in batches of
32. Against JAX: positions within 1e-5, CE sums and log ratios within 4
float32 ulps of the CE sum (as tests/test_torch_hmc.py). Against the plain
versions (``_ce_sum``, ``_ce_sums``, ``_plain_lnpdf``,
``_plain_lnpdf_chains``, and ``sample()`` with the programs hidden): bit
for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ess import _buffers, _pca_pair, jax_uniforms
from test_torch_hmc import HYP, _f32_ulp, _jax_transition
from test_torch_samplers import _as_numpy, _splits, flat_permutation

from ursabench_tpu import models as jmodels
from ursabench_tpu.inference import hmc as jhmc
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import parallel
from ursabench_tpu_torch import utils_checkpoint as ckpt
from ursabench_tpu_torch.inference import PCASubspaceSampler, engine, hmc
from ursabench_tpu_torch.ops.ess import elliptical_slice_chains
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

LAYOUTS = [(1, None), (2, "scan"), (2, "vmap")]  # chains, chain_strategy
PCA_HYP = {"swag_lr": 0.01, "swag_wd": 1e-4, "lr_init": 0.02, "num_samples": 2,
           "swag_momentum": 0.9, "swag_burn_in_epochs": 1, "num_swag_iterates": 3, "rank": 2,
           "max_rank": 3, "temperature": 100.0, "prior_std": 1.0}


def _hmc(name, c, split, chains, strategy, hyp=HYP, seed=0):
    return hmc.HMC(hyp, model=tmodels.get_model(name).build(c), train=split, device="cpu",
                   chains=chains, chain_strategy=strategy or "auto", seed=seed)


def _hide_programs(sampler):
    """``sampler`` on its plain potentials: the programs hidden (an eager
    twin)."""
    if isinstance(sampler, hmc.HMC):
        sampler.potential_program = lambda grad, batched: None
    else:
        sampler.density_program = lambda rows: None
    return sampler


def _fake_mesh():
    """Rank 0 of a (2, 1) mesh without a world: its collectives span one
    rank (tests/test_torch_hmc.py::test_refusals)."""
    mesh = object.__new__(parallel.Mesh)
    mesh.shape, mesh.size, mesh.rank, mesh.active = {"chain": 2, "data": 1}, 2, 0, True
    mesh.chain_idx = mesh.data_idx = 0
    return mesh


# -- (a) HMC's transition through the program against JAX's chunk -----------------

@pytest.mark.parametrize("chains,strategy", LAYOUTS)
@pytest.mark.parametrize("name,dataset", [("MLP200MNIST", "MNIST"), ("PreResNet8", "CIFAR10")])
def test_transition_through_program_matches_jax(name, dataset, chains, strategy):
    """One transition of each chain with JAX's momentum and uniform: its
    every gradient through the gradient program (nb = 3 replays each), the
    proposal, the CE sums, the log ratio and the accept against JAX's
    transition of that chain. Chain 1 starts from chain 0's theta moved by
    5% noise."""
    js_, ts_, c = _splits(dataset)
    jh = jhmc.HMC(HYP, model=jmodels.get_model(name).build(c), train=js_["train"],
                  key=jax.random.PRNGKey(0))
    th = _hmc(name, c, ts_["train"], chains, strategy)
    if jh._bstats:  # eval-mode BatchNorm with statistics other than the init's
        rng = np.random.default_rng(0)
        jh._bstats = jax.tree.map(
            lambda x: jnp.asarray((np.abs(rng.normal(size=x.shape)) + 0.5).astype(np.float32)),
            jh._bstats)
    variables = _as_numpy({"params": jh._params0, "batch_stats": jh._bstats})
    params_from_jax(th.module, variables)
    perm = flat_permutation(th.module, variables).numpy()
    theta0 = np.asarray(jh._theta0[0])
    noise = np.random.default_rng(1).normal(size=theta0.shape).astype(np.float32)
    thetas = [theta0, theta0 * (1 + np.float32(0.05) * noise)][:chains]
    nlp = jh._build_fns()[0]
    wants = []
    for k, theta in enumerate(thetas):
        ll = nlp(jnp.asarray(theta)[None])[0]
        key = jax.random.PRNGKey(100 + k)
        wants.append((ll, _jax_transition(jh, jnp.asarray(theta), ll, key)))

    def t(*arrays):
        return torch.stack([torch.from_numpy(np.array(a)[perm] if np.ndim(a) else np.array(a))
                            for a in arrays])

    theta_t, ll_t = t(*thetas), t(*[ll for ll, _ in wants])
    p0, u = t(*[w["p0"] for _, w in wants]), t(*[w["u"] for _, w in wants])
    if strategy == "vmap":  # every chain's transition at once
        got = th._transition(theta_t, ll_t, draws=(p0, u))
        outs = [(*(o[k] for o in got[:4]), got[4][0][k], got[4][3][k]) for k in range(chains)]
        calls = HYP["L"] + 1
    else:  # each chain's in turn, through the one program
        outs = []
        for k in range(chains):
            got = th._transition(theta_t[k], ll_t[k], draws=(p0[k], u[k]))
            outs.append((*got[:4], got[4][0], got[4][3]))
        calls = chains * (HYP["L"] + 1)
    prog = th._programs[("grad", strategy == "vmap")]
    assert th.step_program == "graph" and th._batches.shape[0] == 3
    assert prog.steps_run == 3 * calls and set(th._programs) == {("grad", strategy == "vmap")}
    for k, (ll_cur, want) in enumerate(wants):
        got_theta, got_ll, accept, log_ratio, prop, ll_new = outs[k]
        tol = 4 * _f32_ulp(ll_cur)
        np.testing.assert_allclose(prop.numpy(), np.asarray(want["proposal"])[perm], rtol=0,
                                   atol=1e-5)
        assert float(ll_new) == pytest.approx(float(want["ll_new"]), abs=tol)
        assert float(log_ratio) == pytest.approx(float(want["log_ratio"]), abs=tol)
        assert bool(accept) == want["accept"]
        np.testing.assert_allclose(got_theta.numpy(), np.asarray(want["theta"])[perm], rtol=0,
                                   atol=1e-5)
        assert float(got_ll) == pytest.approx(float(want["ll"]), abs=tol)


# -- (b) the programs against the plain potentials, bit for bit --------------------

@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", ["MLP200MNIST", "PreResNet8", "MLP200MNIST_dropout"])
def test_program_bit_equal_to_plain_potential(name, batched, grad):
    """The program's CE sum (and gradient) equals ``_ce_sum`` (one chain)
    or ``_ce_sums`` (two chains under vmap) bit for bit, twice in a row at
    different thetas; the dropout twin (dropout on in eval mode) draws the
    plain version's masks into its static buffers."""
    dataset = "CIFAR10" if name == "PreResNet8" else "MNIST"
    _, ts_, c = _splits(dataset)
    th = _hmc(name, c, ts_["train"], 2 if batched else 1, "vmap" if batched else None)
    prog = th.potential_program(grad, batched)
    assert bool(prog.calls) == name.endswith("_dropout")
    plain = th._ce_sums if batched else th._ce_sum
    grads = th._chain_grads if batched else th._grads
    theta0 = th._theta0 if batched else th._theta0[0]
    for theta in (theta0, theta0 * 1.01):
        got = prog(theta)
        got_grads = grads.clone()
        want = plain(theta, grad)
        assert got.shape == want.shape and torch.equal(got, want)
        if grad:
            assert torch.equal(got_grads, grads) and bool(grads.abs().sum() > 0)
    assert prog.steps_run == 2 * th._batches.shape[0]
    assert th.potential_program(grad, batched) is prog


def test_program_variants_refuse_a_wrong_gradient_buffer():
    _, ts_, c = _splits()
    th = _hmc("MLP200MNIST", c, ts_["train"], 1, None)
    kw = dict(flat=th._params)
    args = (th.module, th._images, th._labels, th.train.spec, th._batches, th._valid)
    with pytest.raises(ValueError, match="needs grads"):
        engine.make_potential_fn(*args, variant="grad", **kw)
    with pytest.raises(ValueError, match="needs grads"):
        engine.make_potential_fn(*args, variant="ce", grads=th._grads, **kw)
    with pytest.raises(KeyError):
        engine.make_potential_fn(*args, variant="loss", **kw)


# -- (c) sample() through the programs against the eager path --------------------

@pytest.mark.parametrize("chains,strategy", LAYOUTS)
@pytest.mark.parametrize("burn", [0, 2, -1])
def test_sample_through_programs_equals_eager(burn, chains, strategy):
    """``sample()`` through the programs and with them hidden, from one
    seed: the same ensemble bit for bit and the same accept rate; the
    programs ran every potential (the chain's first CE sums and every
    gradient), the hidden sampler built none."""
    _, ts_, c = _splits()
    hyp = {**HYP, "burn": burn}
    graph = _hmc("MLP200MNIST", c, ts_["train"], chains, strategy, hyp, seed=3)
    eager = _hide_programs(_hmc("MLP200MNIST", c, ts_["train"], chains, strategy, hyp, seed=3))
    want, got = eager.sample(), graph.sample()
    assert got.num_members == want.num_members
    assert all(torch.equal(got.state[k], v) for k, v in want.state.items())
    assert graph.accept_rate == eager.accept_rate and not eager._programs
    batched = strategy == "vmap"
    turns = 1 if batched or chains == 1 else chains  # potential calls a gradient
    nb = graph._batches.shape[0]
    assert graph._programs[("ce", batched)].steps_run == turns * nb
    assert graph._programs[("grad", batched)].steps_run == (
        turns * nb * hyp["num_samples"] * (hyp["L"] + 1))


@pytest.mark.parametrize("chains,strategy", [(1, None), (2, "vmap")])
def test_resume_through_programs_equals_uninterrupted(tmp_path, chains, strategy):
    """Checkpoint every 2 draws, stop after 4 of 6, resume: the resumed run
    (its programs built anew, the CE-sum program never: the carried CE
    sums come from the file) equals the uninterrupted one bit for bit."""
    _, ts_, c = _splits(synthetic_n_train=64)
    hyp = {**HYP, "num_samples": 6, "draw_chunk": 2}
    path = str(tmp_path / "hmc.npz")

    def make():
        return _hmc("MLP200MNIST", c, ts_["train"], chains, strategy, hyp, seed=4)

    full = make()
    want = full.sample()
    part = make()
    part.enable_auto_checkpoint(path, every_epochs=2, resume=False)
    part.sample(num_samples=4)
    assert int(ckpt.load_pytree(path)["draws_done"]) == 4
    res = make()
    assert res.enable_auto_checkpoint(path, every_epochs=2)
    got = res.sample()
    assert all(torch.equal(got.state[k], v) for k, v in want.state.items())
    assert res.accept_rate == full.accept_rate and res.draws_done == 6
    assert set(res._programs) == {("grad", strategy == "vmap")}


# -- (d) PCA-ESS's densities through the programs --------------------------------

def test_density_programs_match_jax_and_plain():
    """``lnpdf`` (per row) and ``lnpdf_chains`` at 3, 2 and 1 rows through
    their programs against JAX's tempered log density within 1e-5 and
    bit-equal to ``_plain_lnpdf`` / ``_plain_lnpdf_chains``; one program a
    row count; the SWA's trained statistics never written."""
    jp, tp, _ = _pca_pair(chains=3)
    trained = _buffers(tp.module)
    thetas = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32)
    want = np.asarray(jp._lnpdf_jit(jnp.asarray(thetas)))
    assert np.abs(want).min() > 0.5
    t = torch.from_numpy(thetas)
    for rows in (3, 2, 1):
        got = tp.lnpdf_chains(t[:rows])
        np.testing.assert_allclose(got.numpy(), want[:rows], rtol=0, atol=1e-5)
        assert torch.equal(got, tp._plain_lnpdf_chains(t[:rows]))
    for k in range(3):
        got = tp.lnpdf(t[k])
        assert float(got) == pytest.approx(float(want[k]), abs=1e-5)
        assert torch.equal(got, tp._plain_lnpdf(t[k]))
    assert tp.step_program == "graph" and set(tp._programs) == {None, 1, 2, 3}
    assert tp._programs[None].steps_run == 3 * tp._batches.shape[0]
    for k, v in _buffers(tp.module).items():
        assert torch.equal(v, trained[k]), k


def test_lock_step_draw_shrinking_through_programs_matches_jax_and_plain():
    """One lock-step draw of 3 chains at temperature 1 with JAX's per-chain
    uniforms whose brackets close at proposals 1, 3 and 2: the active count
    runs 3, 2, 1, each through its program; the draw equals the plain
    versions' bit for bit and JAX's vmapped transition (positions within
    1e-5, log densities within 4 float32 ulps); the trained statistics are
    never written."""
    jp, tp, _ = _pca_pair(chains=3)
    jp.temperature = tp.temperature = 1.0
    jp.chain_strategy = "vmap"
    jp._lnpdf_jit, jp._ess_transition = jp._build_lnpdf()
    trained = _buffers(tp.module)
    thetas = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32))
    prior = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 3)).astype(np.float32))
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    cur = tp._plain_lnpdf_chains(thetas)  # both packages bracket from the same heights
    runs = {}
    for path, fn in (("graph", tp.lnpdf_chains), ("plain", tp._plain_lnpdf_chains)):
        rows = []

        def lnpdf(x, fn=fn, rows=rows):
            rows.append(x.shape[0])
            return fn(x)

        runs[path] = (*elliptical_slice_chains(thetas, prior, lnpdf, cur,
                                               uniforms=[jax_uniforms(k) for k in keys]), rows)
    (theta, lp, iters, rows), plain = runs["graph"], runs["plain"]
    assert iters == [1, 3, 2] and rows == [3, 2, 1] == plain[3] and iters == plain[2]
    assert torch.equal(theta, plain[0]) and torch.equal(lp, plain[1])
    assert set(tp._programs) == {1, 2, 3}
    assert [tp._programs[r].steps_run for r in (3, 2, 1)] == [tp._batches.shape[0]] * 3
    want_t, want_lp = jp._ess_transition(keys, jnp.asarray(thetas.numpy()),
                                         jnp.asarray(prior.numpy()), jnp.asarray(cur.numpy()))
    np.testing.assert_allclose(theta.numpy(), np.asarray(want_t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=0,
                               atol=4 * _f32_ulp(cur[0]))
    for k, v in _buffers(tp.module).items():
        assert torch.equal(v, trained[k]), k


@pytest.mark.parametrize("strategy", ["scan", "vmap"])
def test_pca_sample_through_programs_equals_eager(strategy):
    """``sample()`` of 2 chains through the density programs and with them
    hidden, from one seed: the same ensemble and bracket counts bit for
    bit."""
    _, ts_, c = _splits("CIFAR10", synthetic_n_train=90)
    runs = {}
    for path in ("graph", "eager"):
        tp = PCASubspaceSampler({**PCA_HYP, "temperature": 2.0},
                                model=tmodels.get_model("PreResNet8").build(c),
                                train=ts_["train"], device="cpu", chains=2, seed=4,
                                chain_strategy=strategy)
        if path == "eager":
            _hide_programs(tp)
        runs[path] = (tp.sample(), tp.bracket_iters, tp._programs)
    (got, iters, programs), (want, want_iters, eager_programs) = runs["graph"], runs["eager"]
    assert iters == want_iters and not eager_programs
    assert all(torch.equal(got.state[k], v) for k, v in want.state.items())
    assert (set(programs) == {None}) == (strategy == "scan") and programs


# -- (e) step_program: "graph" off a mesh and on one -------------------------------

def test_step_program_names_the_path():
    """Off a mesh and on one (one chain replicated over a (2, 1) chain
    axis) HMC and PCA-ESS report "graph" and build their programs, and
    draw the same ensemble bit for bit."""
    _, ts_, c = _splits(synthetic_n_train=64)
    hmcs, pcas = {}, {}
    for where, mesh in (("off", None), ("on", _fake_mesh())):
        h = hmc.HMC(HYP, model=tmodels.get_model("MLP200MNIST").build(c), train=ts_["train"],
                    device="cpu", seed=3, mesh=mesh)
        p = PCASubspaceSampler(PCA_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                               train=ts_["train"], device="cpu", seed=6, mesh=mesh)
        hmcs[where], pcas[where] = (h, h.sample()), (p, p.sample())
    for samplers in (hmcs, pcas):
        (off, want), (on, got) = samplers["off"], samplers["on"]
        assert off.step_program == on.step_program == "graph"
        for s in (off, on):
            assert s._programs and all(p.steps_run for p in s._programs.values())
        assert on.replicated and sorted(on._programs, key=str) == sorted(off._programs, key=str)
        assert all(torch.equal(got.state[k], v) for k, v in want.state.items())
    assert hmcs["on"][0].potential_program(True, False) is hmcs["on"][0]._programs[("grad", False)]
    assert pcas["on"][0].density_program(None) is pcas["on"][0]._programs[None]
