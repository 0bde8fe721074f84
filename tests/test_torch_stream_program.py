"""The streamed and the dropout epoch programs of ursabench_tpu_torch
(``engine.make_streaming_step_fn``, ``make_streaming_chunk_fn`` and
``make_epoch_fn`` with a model's dropout masks in static buffers), on the
CPU, where a program runs its step eagerly: the step the card captures once
as a CUDA graph and replays.

Against the JAX package, on the same inputs: the streamed program's epochs
equal JAX's streamed step and chunk epochs (``run_streaming_epoch``) from
the same transferred MLP200 weights with the noise gate off, per batch and
chunked, for uint8 and float32 transfers, with and without crops and flips
(drawn from JAX's keys and injected); MCdropout at dropout 0 takes the
dropout program, which has no active call left to draw for, and equals
JAX's compiled epoch. Dropout draws at p > 0 cannot match Threefry, so
against the port's own eager epochs, bit for bit: the streamed program
against ``stream_steps``, the dropout program against ``train_steps``
(MCdropout on MLP200 and a WideResNet dropout twin, one and two chains,
scan and vmap), a K = 3 dropout sweep, and a streamed MCdropout chain. The
streamed program's lifetime: one program across ``update_hyp``, a second
``sample()`` and a stream swapped for one of the same layout; a new
``TrainState`` or transfer layout rebuilds it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_epoch_program import _assert_same
from test_torch_samplers import _perm, _splits, _start
from test_torch_streaming import _cifar, _hyp, _kw, _preresnet_state, _torch_state

from ursabench_tpu import models as jmodels
from ursabench_tpu.data import native as jnative
from ursabench_tpu.data.sources import synthetic
from ursabench_tpu.data.transforms import ImageSpec as JSpec
from ursabench_tpu.inference import engine as jengine
from ursabench_tpu.inference import sgd_map as jsgd
from ursabench_tpu.inference.sgmcmc import _cosine_hyp_lr as j_lr
from ursabench_tpu.inference.sgmcmc import _sghmc_hyp_update as j_update
from ursabench_tpu_torch import inference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.data import native
from ursabench_tpu_torch.data.transforms import ImageSpec
from ursabench_tpu_torch.inference import engine, sgd_map, sgmcmc
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

N, BATCH = 128, 32
MNIST_MOMENTS = ((0.1307,), (0.3081,))
MCD_HYP = {"lr": 0.05, "epochs": 1, "dropout": 0.2, "lengthscale": 0.01, "num_samples": 2,
           "momentum": 0.9, "weight_decay": 0}
SGHMC_HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1, "burn_in_epochs": 1}


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _jax_aug_draws(key, steps, spec):
    """The crops and flips JAX's streamed steps draw from a state key: step
    t splits ``(key, k_noise, k_drop, k_aug)`` off the key as
    ``_stream_step_impl`` does, and ``augment`` draws its offsets from
    ``split(k_aug)`` and its flips from ``fold_in(k_aug, 1)``. Returns
    (ox, oy, flip), (steps, BATCH) each, None where the spec draws none."""
    ox, oy, flip = [], [], []
    p = spec.random_crop_pad
    for _ in range(steps):
        key, _, _, k_aug = jax.random.split(key, 4)
        if spec.random_flip:
            flip.append(np.array(jax.random.bernoulli(jax.random.fold_in(k_aug, 1), 0.5,
                                                      (BATCH,))))
        if p:
            kx, ky = jax.random.split(k_aug)
            ox.append(np.array(jax.random.randint(kx, (BATCH,), 0, 2 * p + 1)))
            oy.append(np.array(jax.random.randint(ky, (BATCH,), 0, 2 * p + 1)))
    return tuple(torch.from_numpy(np.stack(a)) if a else None for a in (ox, oy, flip))


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "crop-flip"])
@pytest.mark.parametrize("transfer_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("chunk", [1, 4], ids=["M1", "M4"])
def test_streamed_program_matches_jax(chunk, transfer_dtype, augment):
    """Two streamed epochs of MLP200MNIST at alpha 0.5 with the noise gate
    off: JAX's ``make_streaming_step_fn`` (M = 1) or
    ``make_streaming_chunk_fn`` (M = 4) epochs against the port's program,
    the same batches from both packages' streams and, with crop and flip,
    JAX's draws injected; losses within 1e-5 and weights within 1e-5 (the
    tolerances of ``test_torch_streaming.test_streamed_epochs_match_jax``)."""
    images, labels = synthetic("MNIST", train=True, n=N)
    images = np.asarray(images)
    aug = (4, True) if augment else (0, False)
    jspec, tspec = JSpec(28, 1, *MNIST_MOMENTS, *aug), ImageSpec(28, 1, *MNIST_MOMENTS, *aug)
    jm = jmodels.get_model("MLP200MNIST").build(10)
    variables = jax.tree.map(np.array, jengine.init_variables(jm, jax.random.PRNGKey(0),
                                                              (28, 28, 1)))
    hyp = _hyp(0.5)
    jstream = jnative.HostStreamingSplit(images, labels, batch_size=BATCH, spec=jspec, seed=9,
                                         chunk_batches=chunk, transfer_dtype=transfer_dtype)
    jstate = jengine.TrainState(  # the chunk program donates the state, its key included
        params=variables["params"],
        momentum=jax.tree.map(jnp.zeros_like, variables["params"]),
        batch_stats={}, key=jax.random.PRNGKey(1), step=jnp.zeros((), jnp.int32))
    jhyp = {k: jnp.float32(v) for k, v in hyp.items()}
    maker = jengine.make_streaming_chunk_fn if chunk > 1 else jengine.make_streaming_step_fn
    jstep = maker(jm, lr_fn=j_lr, update_fn=j_update, spec=jspec)
    jlosses = []
    for epoch in range(2):
        jstate, ls = jengine.run_streaming_epoch(jstep, jstate, jstream, epoch, 0.0, jhyp)
        jlosses.append(float(jnp.stack(ls).mean()))

    state = _torch_state(variables)
    stream = native.HostStreamingSplit(images, labels, BATCH, tspec, seed=9,
                                       chunk_batches=chunk, transfer_dtype=transfer_dtype)
    nb = stream.num_batches
    thyp = {k: torch.tensor(v, dtype=torch.float32) for k, v in hyp.items()}
    prog = engine.make_epoch_fn(state, stream, hyp=thyp, noise_on=torch.tensor(0.0),
                                lr_fn=sgmcmc._cosine_hyp_lr, update_fn=sgmcmc._sghmc_hyp_update)
    assert isinstance(prog, engine._StreamProgram) and prog.x.shape[0] == chunk
    draws = _jax_aug_draws(jax.random.PRNGKey(1), 2 * nb, tspec) if augment else None
    for epoch in range(2):
        aug = None if draws is None else tuple(
            None if a is None else a[epoch * nb:(epoch + 1) * nb] for a in draws)
        loss = prog(stream, epoch=epoch, seeds=list(range(nb)), aug=aug)
        assert float(loss) == pytest.approx(jlosses[epoch], abs=1e-5)
    assert state.step == 2 * nb == int(jstate.step) and prog.steps_run == 2 * nb
    want = params_from_jax(tmodels.get_model("MLP200MNIST").build(10),
                           {"params": jax.tree.map(np.array, jstate.params)}).state_dict()
    start = params_from_jax(tmodels.get_model("MLP200MNIST").build(10), variables).state_dict()
    got = state.module.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-3


def test_dropout_program_at_rate_zero_matches_jax():
    """MCdropout with its ``dropout`` hyperparameter at 0 and its twin's
    layers at rate 0: the sampler still takes the dropout program (the
    twin has dropout layers, the epoch passes dropout seeds), which finds
    no active call to draw for; its epoch over JAX's permutation, from
    JAX's weights, equals JAX's compiled epoch at rate 0 within 1e-5."""
    hyp = {**MCD_HYP, "dropout": 0.0}
    js_, ts_, c = _splits()
    js = jsgd.MCdropout(hyp, model=jmodels.get_model("MLP200MNIST").build(c),
                        train=js_["train"], model_name="MLP200MNIST", key=jax.random.PRNGKey(2))
    js.module, js._epoch_fn = js.module.clone(dropout=0.0), None
    js._setup(hyp)
    start, perm = _start(js), _perm(js._state.key, 96)
    js._state, loss_j = js._epoch_fn(js._state, jnp.float32(0.0), jnp.float32(0.0),
                                     js._hyp_scalars)
    ts = sgd_map.MCdropout(hyp, model=tmodels.get_model("MLP200MNIST").build(c),
                           train=ts_["train"], device="cpu", model_name="MLP200MNIST")
    layers = tmodels.common.dropout_layers(ts.module)
    assert len(layers) == 2 and ts._has_dropout and ts.step_program == "graph"
    for layer in layers:
        layer.p = 0.0
    assert ts.weight_decay == pytest.approx(js.weight_decay, rel=1e-12)
    params_from_jax(ts.module, start)
    prog = ts.epoch_program()
    assert prog.dropout.calls == [[]] and prog.dropout.masks == []
    nb = ts.train.num_batches
    loss_t = prog(torch.from_numpy(perm).view(nb, -1), epoch=0, seeds=[1] * nb,
                  dropout_seeds=[7])
    assert float(loss_t) == pytest.approx(float(loss_j), abs=1e-5)
    want = params_from_jax(tmodels.get_model("MLP200MNIST").build(c), _start(js)).state_dict()
    for k, v in ts.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
    moved = params_from_jax(tmodels.get_model("MLP200MNIST").build(c), start)
    assert float((ts._state.params - engine.flatten_parameters(moved)[0]).abs().max()) > 1e-3


# -- against the port's own eager epochs, bit for bit -----------------------------------

@pytest.mark.parametrize("transfer_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("chunk", [1, 4], ids=["M1", "M4"])
def test_streamed_program_equals_stream_steps(chunk, transfer_dtype):
    """PreResNet-8 with crops, flips and the Langevin noise on, two epochs
    of two streams of the same seed: the program (its one step run M times
    a transfer) and ``stream_steps`` give the same weights, momenta,
    BatchNorm statistics and losses bit for bit, and the streams the same
    counters."""
    split, c = _cifar()
    nb = N // 16
    runs = []
    for program in (True, False):
        state = _preresnet_state(c)
        stream = native.HostStreamingSplit(split.images, split.labels, 16, split.spec, seed=3,
                                           chunk_batches=chunk, transfer_dtype=transfer_dtype)
        kw = _kw(nb)
        prog = (engine.make_epoch_fn(state, stream, hyp=kw["hyp"], noise_on=kw["noise_on"],
                                     lr_fn=kw["lr_fn"], update_fn=kw["update_fn"])
                if program else None)
        losses = []
        for epoch in range(2):
            if program:
                losses.append(prog(stream, epoch=epoch, seeds=kw["seeds"], aug=kw["aug"]))
            else:
                losses.append(engine.stream_steps(state, stream, epoch=epoch, **kw))
        runs.append((state, losses, stream, prog))
    (a, la, sa, prog), (b, lb, sb, _) = runs
    assert prog.steps_run == 2 * nb and a.step == b.step == 2 * nb
    assert torch.equal(a.params, b.params) and torch.equal(a.momentum, b.momentum)
    for (k, x), (_, y) in zip(a.module.state_dict().items(), b.module.state_dict().items()):
        assert torch.equal(x, y), k
    for x, y in zip(la, lb):
        assert x.shape == y.shape == () and torch.equal(x, y)
    assert sa.epochs_started == sb.epochs_started == 2
    assert sa.stats["transfers"] == sb.stats["transfers"] == 2 * nb // chunk
    assert sa.stats["bytes"] == sb.stats["bytes"] > 0


def _wrn_twin(c):
    """A WideResNet dropout twin at depth 10, width 1: convolutions,
    BatchNorm, dropout in every block and on the pooled features."""
    return tmodels.get_model("WideResNet_dropout").build(c, depth=10, widen_factor=1)


DROPOUT_CASES = {
    "mlp200_c1": ("MLP200MNIST", 1, "scan"),
    "mlp200_c2_scan": ("MLP200MNIST", 2, "scan"),
    "mlp200_c2_vmap": ("MLP200MNIST", 2, "vmap"),
    "wrn_c1": ("WRN", 1, "scan"),
    "wrn_c2_scan": ("WRN", 2, "scan"),
    "wrn_c2_vmap": ("WRN", 2, "vmap"),
}


def _mcdropout(name, eager):
    model, chains, strategy = DROPOUT_CASES[name]
    if model == "WRN":
        _, ts, c = _splits("CIFAR10", synthetic_n_train=64,
                           transform_train=tmodels.get_model("PreResNet8").transform_train)
        kw = {"model": _wrn_twin(c)}
    else:
        _, ts, c = _splits(synthetic_n_train=64)
        kw = {"model": tmodels.get_model(model).build(c), "model_name": model}
    s = sgd_map.MCdropout(MCD_HYP, train=ts["train"], device="cpu", seed=3, chains=chains,
                          chain_strategy=strategy, **kw)
    if eager:  # the same sampler on the step-by-step path
        s.epoch_program = lambda: None
    return s


@pytest.mark.parametrize("name", list(DROPOUT_CASES))
def test_dropout_program_equals_train_steps(name):
    """MCdropout (rate 0.2 on MLP200, 0.1 on the WRN twin), one or two
    chains, in turn or batched: its whole ``sample()`` through the program
    (each chain's masks drawn into static buffers before each step) equals
    the one through ``train_steps`` bit for bit, and the masks change from
    step to step."""
    prog, eager = _mcdropout(name, False), _mcdropout(name, True)
    assert prog.step_program == "graph" and prog._resolved_chain_strategy == (
        None if DROPOUT_CASES[name][1] == 1 else DROPOUT_CASES[name][2])
    ens_p, ens_e = prog.sample(), eager.sample()
    _assert_same(prog, eager)
    for k in ens_p.state:
        assert torch.equal(ens_p.state[k], ens_e.state[k]), k
    program = prog._program
    nb, chains = prog.train.num_batches, len(prog.modules)
    assert program.steps_run == prog.epochs_run * nb and eager._program is None
    masks = program.dropout.masks
    assert masks and all(m.shape[0] == chains for m in masks)
    before = [m.clone() for m in masks]
    program.dropout.draw([11] * chains, 0)
    program.dropout.draw([11] * chains, 1)
    assert not all(torch.equal(x, y) for x, y in zip(before, masks))


@pytest.mark.parametrize("strategy", ["scan", "vmap"])
def test_dropout_sweep_program_equals_train_steps(strategy):
    """A K = 3 SGD sweep on the MLP200 dropout twin, each row drawing its
    masks from its own seed (``vectorized.py``'s layout): two epochs
    through the program equal ``train_steps``' bit for bit."""
    _, ts, c = _splits(synthetic_n_train=64)
    hyps = [{"lr": lr, "epochs": 1, "momentum": 0.9, "weight_decay": 5e-4}
            for lr in (0.01, 0.03, 0.08)]

    def sweep(eager):
        sw = inference.MethodSweep(hyps, model=tmodels.get_model("MLP200MNIST_dropout").build(c),
                                   train=ts["train"], seed=4, method="SGD",
                                   chain_strategy=strategy, device="cpu")
        if eager:
            sw.sampler.epoch_program = lambda: None
        for _ in range(2):
            sw.sampler._run_epoch()
        return sw

    a, b = sweep(False), sweep(True)
    _assert_same(a.sampler, b.sampler)
    program = a.sampler._program
    assert program.state is a.sampler._state and program.chain_strategy == strategy
    assert all(m.shape[0] == 3 for m in program.dropout.masks)


@pytest.mark.parametrize("chunk", [1, 2], ids=["M1", "M2"])
def test_streamed_mcdropout_equals_stream_steps(chunk):
    """MCdropout on MLP200 over a stream: the streamed program draws the
    masks before each replay, and its ``sample()`` equals the one through
    ``stream_steps`` bit for bit."""
    _, ts, c = _splits(synthetic_n_train=150)
    train = ts["train"]
    runs = []
    for eager in (False, True):
        stream = native.HostStreamingSplit(train.images, train.labels, 32, train.spec, seed=1,
                                           chunk_batches=chunk)
        s = sgd_map.MCdropout(MCD_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                              train=stream, device="cpu", seed=2, model_name="MLP200MNIST")
        if eager:
            s.epoch_program = lambda: None
        runs.append((s, s.sample()))
    (a, ens_a), (b, ens_b) = runs
    _assert_same(a, b)
    for k in ens_a.state:
        assert torch.equal(ens_a.state[k], ens_b.state[k]), k
    assert isinstance(a._program, engine._StreamProgram) and len(a._program.dropout.masks) == 2
    assert a._program.steps_run == a._state.step == a.epochs_run * 4  # 150 // 32, tail dropped
    assert a.train.epochs_started == b.train.epochs_started == a.epochs_run


# -- the streamed program's lifetime -------------------------------------------------------

def test_streamed_program_lives_across_calls_and_swapped_streams():
    """One program across ``update_hyp``, a second ``sample()`` and a stream
    of the same layout put in place of the first (the split is taken at
    each call); a stream of another layout or a new ``TrainState`` builds a
    new one."""
    _, ts, c = _splits(synthetic_n_train=128)
    train = ts["train"]

    def stream(chunk=2, seed=5):
        return native.HostStreamingSplit(train.images, train.labels, 32, train.spec, seed=seed,
                                         chunk_batches=chunk)

    s = sgmcmc.SGHMC(SGHMC_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                     train=stream(), device="cpu")
    s.sample()
    prog = s._program
    assert isinstance(prog, engine._StreamProgram) and prog.x.shape[:2] == (2, 32)
    first = prog.steps_run
    s.update_hyp({**SGHMC_HYP, "lr": 0.02})  # step 0 again
    s.sample()
    s.train = stream(seed=6)
    s._run_epoch()
    assert s._program is prog and prog.steps_run == first + s._state.step
    assert s.train.epochs_started == 1
    s.train = stream(chunk=4)
    s._run_epoch()
    assert s._program is not prog and s._program.x.shape[0] == 4
    prog = s._program
    old = s._state
    s._state = engine.TrainState(old.module, old.params, old.momentum, old.grads,
                                 modules=old.modules, step=old.step)
    s._run_epoch()
    assert s._program is not prog and s._program.state is s._state
    with pytest.raises(ValueError, match="transfers"):
        s._program(stream(chunk=1), epoch=0, seeds=[0] * 4)
