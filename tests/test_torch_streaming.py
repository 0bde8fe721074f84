"""Streamed epochs of ursabench_tpu_torch against the JAX package's: an epoch
fed by ``HostStreamingSplit`` (``engine.stream_steps``) equals JAX's
``run_streaming_epoch`` and its chunked program from the same transferred
weights with the noise gate off; chunked equals per batch bit for bit; a
streamed epoch equals the resident ``train_steps`` fed the stream's order
and the same crops and flips; the six epoch samplers take a stream without
putting the train split on the device, one chain only; and the runner's
``--stream``/``--stream_chunk`` run, or exit with the JAX runner's message
for the methods that need the whole split."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import experiment as jexp
from ursabench_tpu import models as jmodels
from ursabench_tpu.data import native as jnative
from ursabench_tpu.data.sources import synthetic
from ursabench_tpu.data.transforms import ImageSpec as JSpec
from ursabench_tpu.inference import engine as jengine
from ursabench_tpu.inference.sgmcmc import _cosine_hyp_lr as j_lr
from ursabench_tpu.inference.sgmcmc import _sghmc_hyp_update as j_update
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import experiment as texp
from ursabench_tpu_torch import inference, models
from ursabench_tpu_torch.data import native
from ursabench_tpu_torch.data.transforms import CIFAR_TRAIN, MNIST_TRAIN, draw_augment
from ursabench_tpu_torch.inference import engine, sgmcmc
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

N, BATCH = 128, 32


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _hyp(alpha, n=N):
    return {"lr0": 0.05, "eta_min": 0.0, "t_max": 10.0, "momentum": 1.0 - alpha,
            "wd_over_n": 1.0 / n, "n_train": float(n)}


def _jax_epochs(images, labels, variables, hyp, chunk, transfer_dtype, epochs):
    """JAX's streamed SGHMC epochs with the noise gate off: the final
    parameters and the epochs' losses."""
    module = jmodels.get_model("MLP200MNIST").build(10)
    stream = jnative.HostStreamingSplit(images, labels, batch_size=BATCH,
                                        spec=JSpec(28, 1, (0.1307,), (0.3081,)), seed=9,
                                        chunk_batches=chunk, transfer_dtype=transfer_dtype)
    state = jengine.TrainState(
        params=variables["params"],
        momentum=jax.tree.map(jnp.zeros_like, variables["params"]),
        batch_stats={}, key=jax.random.PRNGKey(1), step=jnp.zeros((), jnp.int32))
    jhyp = {k: jnp.float32(v) for k, v in hyp.items()}
    maker = jengine.make_streaming_chunk_fn if chunk > 1 else jengine.make_streaming_step_fn
    step = maker(module, lr_fn=j_lr, update_fn=j_update, spec=stream.spec)
    losses = []
    for epoch in range(epochs):
        state, ls = jengine.run_streaming_epoch(step, state, stream, epoch, 0.0, jhyp)
        losses.append(float(jnp.stack(ls).mean()))
    return state.params, losses


def _torch_state(variables):
    tm = models.get_model("MLP200MNIST").build(10)
    params, grads = engine.flatten_parameters(tm)
    params_from_jax(tm, jax.tree.map(np.array, variables))
    return engine.TrainState(tm, params, torch.zeros_like(params), grads)


@pytest.mark.parametrize("alpha,chunk,transfer_dtype", [
    (0.5, 1, "uint8"), (1.0, 1, "uint8"), (0.5, 2, "uint8"), (0.5, 1, "float32")],
    ids=["SGHMC", "SGLD", "SGHMC-chunk2", "SGHMC-float32"])
def test_streamed_epochs_match_jax(alpha, chunk, transfer_dtype):
    """Two streamed epochs of MLP200MNIST at alpha 0.5 (SGHMC) and 1 (SGLD):
    the same batches from both packages' streams, the same weights after,
    within 1e-5 (alpha 0.5 for the reason of tests/test_torch_engine.py)."""
    images, labels = synthetic("MNIST", train=True, n=N)
    images = np.asarray(images)
    jm = jmodels.get_model("MLP200MNIST").build(10)
    variables = jax.tree.map(np.array, jengine.init_variables(jm, jax.random.PRNGKey(0),
                                                              (28, 28, 1)))
    hyp = _hyp(alpha)
    jparams, jlosses = _jax_epochs(images, labels, variables, hyp, chunk, transfer_dtype, 2)

    state = _torch_state(variables)
    stream = native.HostStreamingSplit(images, labels, BATCH, MNIST_TRAIN, seed=9,
                                       chunk_batches=chunk, transfer_dtype=transfer_dtype)
    thyp = {k: torch.tensor(v, dtype=torch.float32) for k, v in hyp.items()}
    for epoch in range(2):
        loss = engine.stream_steps(
            state, stream, epoch=epoch, noise_on=torch.tensor(0.0), hyp=thyp,
            lr_fn=sgmcmc._cosine_hyp_lr, update_fn=sgmcmc._sghmc_hyp_update,
            seeds=list(range(stream.num_batches)))
        assert float(loss) == pytest.approx(jlosses[epoch], abs=1e-5)
    assert state.step == 2 * (N // BATCH)
    want = params_from_jax(models.get_model("MLP200MNIST").build(10),
                           {"params": jax.tree.map(np.array, jparams)}).state_dict()
    start = params_from_jax(models.get_model("MLP200MNIST").build(10), variables).state_dict()
    got = state.module.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-3


def _cifar(n=N):
    splits, c = tdata.loaders("CIFAR10", None, batch_size=16, use_validation=False,
                              synthetic_n_train=n, synthetic_n_test=16,
                              transform_train=CIFAR_TRAIN)
    return splits["train"], c


def _preresnet_state(c, seed=0):
    m = models.get_model("PreResNet8").build(c)
    m.init_parameters(torch.Generator().manual_seed(seed))
    params, grads = engine.flatten_parameters(m)
    return engine.TrainState(m, params, torch.zeros_like(params), grads)


def _kw(nb, noise=1.0):
    hyp = {k: torch.tensor(v, dtype=torch.float32) for k, v in _hyp(0.1).items()}
    aug = draw_augment(torch.Generator().manual_seed(4), (nb, 16), CIFAR_TRAIN)
    return dict(noise_on=torch.tensor(noise), hyp=hyp, lr_fn=sgmcmc._cosine_hyp_lr,
                update_fn=sgmcmc._sghmc_hyp_update, seeds=[100 + i for i in range(nb)],
                aug=aug)


def test_streamed_epoch_equals_resident_epoch_in_the_streams_order():
    """PreResNet-8 with crops, flips and the Langevin noise on: the streamed
    epoch and ``train_steps`` over the stream's permutation, with the same
    augmentation draws and noise seeds, give the same weights bit for bit."""
    split, c = _cifar()
    nb = N // 16
    a, b = _preresnet_state(c), _preresnet_state(c)
    stream = native.HostStreamingSplit(split.images, split.labels, 16, split.spec, seed=3)
    la = engine.stream_steps(a, stream, epoch=0, **_kw(nb))
    idx = torch.from_numpy(native.permutation(N, 3)).view(nb, 16)
    images, labels = split.device_tensors("cpu")
    lb = engine.train_steps(b, images, labels, idx, spec=split.spec, epoch=0, **_kw(nb))
    assert torch.equal(a.params, b.params) and torch.equal(a.momentum, b.momentum)
    assert torch.equal(la, lb)
    for (ka, va), (kb, vb) in zip(a.module.state_dict().items(), b.module.state_dict().items()):
        assert torch.equal(va, vb), ka


def test_chunked_epoch_bit_equal_to_per_batch():
    """M = 4 staged batches trained in turn equal M = 1, bit for bit, over
    two epochs (batch index chunk * M + j for the schedule, the crops and
    the noise); the losses (mean of chunk means) agree to float rounding."""
    split, c = _cifar()
    nb = N // 16
    runs = []
    for chunk in (1, 4):
        state = _preresnet_state(c)
        stream = native.HostStreamingSplit(split.images, split.labels, 16, split.spec,
                                           seed=3, chunk_batches=chunk)
        assert stream.num_batches == nb
        losses = [engine.stream_steps(state, stream, epoch=e, **_kw(nb)) for e in range(2)]
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    assert torch.equal(a.params, b.params) and torch.equal(a.momentum, b.momentum)
    for x, y in zip(la, lb):
        assert float(x) == pytest.approx(float(y), rel=1e-6)


HYPS = {
    "SGHMC": {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1,
              "burn_in_epochs": 1},
    "SGLD": {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "burn_in_epochs": 1},
    "cSGHMC": {"lr_0": 0.05, "prior_std": 1.0, "cycle_length": 3, "burn_in_epochs": 1,
               "num_samples_per_cycle": 1, "num_cycles": 2},
    "cSGLD": {"lr_0": 0.05, "prior_std": 1.0, "cycle_length": 3, "burn_in_epochs": 1,
              "num_samples_per_cycle": 1, "num_cycles": 2},
    "SGD": {"lr": 0.05, "epochs": 1, "momentum": 0.9, "weight_decay": 5e-4},
    "MCdropout": {"lr": 0.05, "epochs": 1, "dropout": 0.1, "lengthscale": 0.01,
                  "num_samples": 2, "momentum": 0.9, "weight_decay": 0},
}
MEMBERS = {"SGHMC": 2, "SGLD": 2, "cSGHMC": 2, "cSGLD": 2, "SGD": 1, "MCdropout": 2}


@pytest.mark.parametrize("method", sorted(HYPS))
def test_epoch_samplers_take_a_stream(method, monkeypatch):
    """Each of the six samplers the runner streams for trains from a stream
    and never puts the train split on the device; its schedule counts the
    stream's batches (the tail dropped)."""
    splits, c = tdata.loaders("MNIST", None, batch_size=32, use_validation=False,
                              synthetic_n_train=150, synthetic_n_test=16)
    train = splits["train"]
    monkeypatch.setattr(type(train), "device_tensors",
                        lambda *a: pytest.fail("the train split was put on the device"))
    stream = native.HostStreamingSplit(train.images, train.labels, 32, train.spec, seed=1,
                                       chunk_batches=2)
    kw = {"model_name": "MLP200MNIST"} if method == "MCdropout" else {}
    s = getattr(inference, method)(HYPS[method], model=models.get_model("MLP200MNIST").build(c),
                                   train=stream, seed=0, device="cpu", **kw)
    ens = s.sample()
    assert ens.num_members == MEMBERS[method]
    assert s._state.step == s.epochs_run * 4  # 150 // 64 chunks of 2 batches
    assert stream.epochs_started == s.epochs_run
    assert all(np.isfinite(float(x)) for x in s.epoch_losses)
    if method == "MCdropout":
        assert float(s._hyp["total_steps"]) == (1 + 2) * 4


def test_streams_are_single_chain():
    train, c = _cifar(64)
    stream = native.HostStreamingSplit(train.images, train.labels, 16, train.spec)
    with pytest.raises(ValueError, match="single-chain"):
        inference.SGLD(HYPS["SGLD"], model=models.get_model("PreResNet8").build(c),
                       train=stream, chains=2, device="cpu")
    sweep = inference.MethodSweep([HYPS["SGLD"], {**HYPS["SGLD"], "lr": 0.02}],
                                  model=models.get_model("PreResNet8").build(c),
                                  train=stream, method="SGLD", device="cpu")
    with pytest.raises(ValueError, match="single-chain"):
        sweep.sample()


ARGV = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--batch_size", "32",
        "--hyperparams", json.dumps(HYPS["SGLD"]), "--synthetic_n_train", "160",
        "--synthetic_n_test", "64", "--num_trials", "2"]


def test_runner_streams_on_the_cpu(tmp_path, monkeypatch):
    """``--stream --stream_chunk 2``: each trial's sampler gets a stream of
    the train split, seeded with ``--seed``, and the run has the result keys
    of a resident run."""
    seen = []
    make = texp._make_sampler

    def recording(args, hyp, module, train, seed, device, mesh=None):
        seen.append(train)
        return make(args, hyp, module, train, seed, device, mesh=mesh)

    monkeypatch.setattr(texp, "_make_sampler", recording)
    argv = ARGV + ["--inference_method", "SGLD", "--save_path", str(tmp_path / "s")]
    streamed = texp.main(argv + ["--stream", "--stream_chunk", "2", "--seed", "4"],
                         device="cpu")
    assert [type(t).__name__ for t in seen] == ["HostStreamingSplit"] * 2
    assert seen[0].chunk_batches == 2 and seen[0].seed == 4 and seen[0].num_batches == 4
    assert seen[0].epochs_started == 2 * 3  # both trials, 3 epochs each
    resident = texp.main(argv, device="cpu")
    assert sorted(streamed) == sorted(resident)
    assert all(np.isfinite(v) for k, v in streamed.items() if "auroc" not in k)


@pytest.mark.parametrize("method", ["SWA", "SWAG", "HMC", "PCASubspaceSampler"])
def test_runner_stream_exits_for_methods_that_need_the_whole_split(method, tmp_path):
    argv = ARGV + ["--inference_method", method, "--stream", "--save_path", str(tmp_path / "x")]
    with pytest.raises(SystemExit) as want:
        jexp.main(argv)
    with pytest.raises(SystemExit) as got:
        texp.main(argv, device="cpu")
    assert str(got.value) == str(want.value)
    assert method in str(got.value) and "epoch-driven" in str(got.value)


def test_resumed_streamed_chain_restarts_its_stream(tmp_path):
    """A checkpoint holds no stream state, in both packages: a chain resumed
    with a new stream orders its epochs from ``seed`` again, so it is not
    bit-equal to the uninterrupted chain (ROADMAP.md §3)."""
    splits, c = tdata.loaders("MNIST", None, batch_size=32, use_validation=False,
                              synthetic_n_train=128, synthetic_n_test=16)
    train = splits["train"]
    hyp = {**HYPS["SGLD"], "burn_in_epochs": 2, "num_samples": 1}

    def sampler(stream):
        return inference.SGLD(hyp, model=models.get_model("MLP200MNIST").build(c),
                              train=stream, seed=0, device="cpu")

    def stream():
        return native.HostStreamingSplit(train.images, train.labels, 32, train.spec, seed=2)

    whole = sampler(stream())
    whole.sample()
    assert whole.train.epochs_started == whole.epochs_run == 3
    first = sampler(stream())
    first.enable_auto_checkpoint(str(tmp_path / "c.npz"), every_epochs=1)
    first._run_epoch()
    first._maybe_checkpoint()
    resumed = sampler(stream())
    assert resumed.enable_auto_checkpoint(str(tmp_path / "c.npz"), every_epochs=1)
    assert resumed.epochs_run == 1 and resumed.train.epochs_started == 0
    resumed.sample()
    assert resumed.train.epochs_started == resumed.epochs_run - 1
    assert not torch.equal(resumed._state.params, whole._state.params)
