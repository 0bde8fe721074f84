"""The epoch program of ursabench_tpu_torch (``engine.make_epoch_fn``, the
counterpart of the JAX package's compiled epoch) against the step-by-step
epoch (``engine.train_steps``), on the CPU, where the program runs its step
eagerly: the step that the card captures once as a CUDA graph and replays.

The two take the same draws from the same generators, so they agree bit
for bit: parameters, momenta, BatchNorm statistics, losses and the step
counter, for one chain, chains in turn and batched, a sweep's K rows, SGD,
SWA and cSGHMC across the epochs where its noise gate and cyclic rate
change. The program is built once per state and hyperparameter dict and
survives ``update_hyp`` and a second ``sample()``; models with dropout and
streamed splits take their programs, and so do meshes. The schedules in their
device form (epoch, batch and step as 0-dim tensors) against the JAX
package's; K1's plain path with its seed in a tensor; the launch counts of a
kernel captured into a graph."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel import _spawn
from test_torch_samplers import _splits

from ursabench_tpu.inference import sgd_map as jsgd
from ursabench_tpu.inference import sgmcmc as jsgmcmc
from ursabench_tpu.inference import swa as jswa
from ursabench_tpu_torch import inference as tinference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import parallel
from ursabench_tpu_torch.data import native
from ursabench_tpu_torch.inference import engine, sgd_map, sgmcmc, swa
from ursabench_tpu_torch.ops.sgmcmc import sghmc_update, sgd_momentum_update
from ursabench_tpu_torch.utils_checkpoint import save_sampler_state

torch.set_num_threads(1)

SGHMC_HYP = {"lr": 0.05, "prior_std": 1.0, "num_samples": 2, "alpha": 0.1,
             "burn_in_epochs": 1}
SGD_HYP = {"lr": 0.05, "epochs": 1, "momentum": 0.9, "weight_decay": 5e-4}
CYC_HYP = {"lr_0": 0.05, "prior_std": 1.0, "num_samples_per_cycle": 2, "cycle_length": 4,
           "burn_in_epochs": 1, "num_cycles": 1, "alpha": 0.1}
SWA_HYP = {"swag_lr": 0.01, "swag_wd": 5e-4, "lr_init": 0.05, "num_samples": 2,
           "momentum": 0.9, "burn_in_epochs": 2, "num_iterates": 2}
MCD_HYP = {"lr": 0.05, "epochs": 1, "dropout": 0.2, "lengthscale": 0.01, "num_samples": 2,
           "momentum": 0.9, "weight_decay": 0}
PRN8 = {"transform_train": tmodels.get_model("PreResNet8").transform_train}

# name -> (model, dataset, loader options, sampler class, hyperparameters,
# chains, chain strategy, epochs)
CASES = {
    "sghmc_c1_prn8": ("PreResNet8", "CIFAR10", PRN8, sgmcmc.SGHMC, SGHMC_HYP, 1, "auto", 2),
    "sghmc_c3_scan": ("MLP200MNIST", "MNIST", {}, sgmcmc.SGHMC, SGHMC_HYP, 3, "scan", 2),
    "sghmc_c2_vmap_prn8": ("PreResNet8", "CIFAR10", PRN8, sgmcmc.SGHMC, SGHMC_HYP, 2, "vmap", 2),
    "sgld_c2_vmap": ("MLP200MNIST", "MNIST", {}, sgmcmc.SGLD, SGHMC_HYP, 2, "vmap", 2),
    "sgd_c1": ("MLP200MNIST", "MNIST", {}, sgd_map.SGD, SGD_HYP, 1, "auto", 2),
    "deep_ensemble_c2_prn8": ("PreResNet8", "CIFAR10", PRN8, sgd_map.DeepEnsemble,
                              {**SGD_HYP, "num_members": 2}, None, "scan", 2),
    "csghmc_gate_and_cycle": ("MLP200MNIST", "MNIST", {}, sgmcmc.cSGHMC, CYC_HYP, 1, "auto",
                              4),
    "swa": ("MLP200MNIST", "MNIST", {}, swa.SWA, SWA_HYP, 1, "auto", 3),
}


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _sampler(name, eager=False, seed=5):
    model, dataset, loader, cls, hyp, chains, strategy, _ = CASES[name]
    _, ts, c = _splits(dataset, **loader)
    kw = {} if cls is swa.SWA else {"chain_strategy": strategy}
    s = cls(hyp, model=tmodels.get_model(model).build(c), train=ts["train"], device="cpu",
            seed=seed, chains=chains, **kw)
    if eager:  # the same sampler on the step-by-step path
        s.epoch_program = lambda: None
    return s


def _epoch(s):
    """One epoch with the sampler's own noise gate rule (cSGHMC's cycle)."""
    gate = s._noise_on() if isinstance(s, sgmcmc.cSGHMC) else None
    return s._run_epoch(noise_on=gate)


def _assert_same(a, b):
    assert a._state.step == b._state.step
    assert torch.equal(a._state.params, b._state.params)
    assert torch.equal(a._state.momentum, b._state.momentum)
    for ma, mb in zip(a.modules, b.modules):
        for (k, x), (_, y) in zip(ma.named_buffers(), mb.named_buffers()):
            assert torch.equal(x, y), k
    for la, lb in zip(a.epoch_losses, b.epoch_losses):
        assert la.shape == lb.shape and torch.equal(la, lb)


@pytest.mark.parametrize("name", list(CASES))
def test_program_epochs_equal_train_steps_bit_for_bit(name):
    """Epochs through the program equal ``train_steps``'s from the same
    generators, bit for bit; the step counter, the losses' shape and the
    program's step count follow."""
    prog, eager = _sampler(name), _sampler(name, eager=True)
    assert prog.step_program == eager.step_program == "graph"
    epochs = CASES[name][7]
    for _ in range(epochs):
        _epoch(prog)
        _epoch(eager)
    _assert_same(prog, eager)
    nb = prog.train.num_batches
    program = prog._program
    assert program is not None and eager._program is None
    assert program.steps_run == epochs * nb and prog._state.step == epochs * nb
    assert program.graph is None and program.captures == 0  # no capture on the CPU
    start = _sampler(name)
    assert float((prog._state.params - start._state.params).abs().max()) > 1e-4


def test_csghmc_epochs_cross_its_gate_and_cycle():
    """The cSGHMC case crosses a change of the noise gate (off in epoch 0,
    on from epoch 1) and its per-batch rate falls within each cycle: the
    device counters feed the gate's buffer and the schedule as the host
    ints do."""
    s = _sampler("csghmc_gate_and_cycle")
    gates = []
    for epoch in range(4):
        s.epochs_run = epoch
        gates.append(s._noise_on())
    assert gates == [False, True, True, True]
    hyp, nb = s._hyp, s.train.num_batches
    rates = [float(sgmcmc._cyclic_hyp_lr(hyp, torch.tensor(e, dtype=torch.float32),
                                         torch.tensor(b), torch.tensor(0)))
             for e in range(4) for b in range(nb)]
    assert rates == sorted(rates, reverse=True) and rates[-1] < 0.5 * rates[0]


def test_sweep_rows_equal_train_steps_bit_for_bit():
    """A K = 3 sweep (one (3, 5) K1 table a step on the card): two epochs
    through the program equal ``train_steps``'s, and the program is the
    sweep's (its state and (K,) hyperparameters)."""
    _, ts, c = _splits("MNIST")
    hyps = [{**SGHMC_HYP, "lr": lr} for lr in (0.01, 0.03, 0.08)]

    def sweep(eager):
        sw = tinference.MethodSweep(hyps, model=tmodels.get_model("MLP200MNIST").build(c),
                                    train=ts["train"], seed=4, method="SGHMC",
                                    chain_strategy="scan", device="cpu")
        if eager:
            sw.sampler.epoch_program = lambda: None
        for _ in range(2):
            sw.sampler._run_epoch(noise_on=True)
        return sw

    a, b = sweep(False), sweep(True)
    _assert_same(a.sampler, b.sampler)
    program = a.sampler._program
    assert program.state is a.sampler._state and program.hyp is a.sampler._hyp
    assert a.sampler._hyp["lr0"].shape == (3,) and a.sampler._state.params.shape[0] == 3


def test_update_hyp_and_a_second_sample_keep_the_program():
    """``update_hyp`` between epochs, a second ``sample()`` and a checkpoint
    restore write in place: the program object stays, and what it computes
    is what the eager path computes after the same calls."""
    runs = []
    for eager in (False, True):
        s = _sampler("sghmc_c3_scan", eager=eager)
        s.sample()
        first = s._program
        s.update_hyp({**SGHMC_HYP, "lr": 0.02, "alpha": 0.3})
        ens = s.sample()
        runs.append((s, first, ens))
    (a, first, ens_a), (b, _, ens_b) = runs
    assert first is not None and a._program is first
    _assert_same(a, b)
    for k in ens_a.state:
        assert torch.equal(ens_a.state[k], ens_b.state[k]), k
    assert float(a._hyp["lr0"]) == pytest.approx(0.02)


def test_checkpoint_restore_keeps_the_program(tmp_path):
    """A restore copies into the sampler's buffers and sets ``state.step``:
    the program stays and resumes where the checkpoint left off, equal to an
    uninterrupted run."""
    path = str(tmp_path / "ckpt.pt")
    a = _sampler("sghmc_c1_prn8")
    _epoch(a)
    save_sampler_state(path, a)
    program = a._program
    b = _sampler("sghmc_c1_prn8")
    assert b.enable_auto_checkpoint(path, every_epochs=100)
    b.epoch_program()
    kept = b._program
    b.enable_auto_checkpoint(path, every_epochs=100)  # a second restore, in place
    assert b._program is kept and b._state.step == a._state.step
    _epoch(a)
    _epoch(b)
    assert a._program is program and b._program is kept
    assert torch.equal(a._state.params, b._state.params)


def test_a_new_state_or_hyperparameter_dict_rebuilds_the_program():
    s = _sampler("sgd_c1")
    _epoch(s)
    first = s._program
    assert s.epoch_program() is first
    old = s._state
    s._state = engine.TrainState(old.module, old.params, old.momentum, old.grads,
                                 modules=old.modules, step=old.step)
    second = s.epoch_program()
    assert second is not first and second.state is s._state
    s._hyp = dict(s._hyp)
    third = s.epoch_program()
    assert third is not second and third.hyp is s._hyp
    _epoch(s)
    assert s._program is third and third.steps_run == s.train.num_batches


def test_dropout_models_and_streamed_splits_stay_eager():
    """The rule this test held before, dropout models and streamed splits
    on the eager path, is gone: both report ``"graph"``, build their
    program at the first epoch (the streamed program for the stream, the
    dropout model's drawing its masks before each step) and run their
    epochs through it, as meshes do (``test_meshes_stay_eager``)."""
    _, ts, c = _splits("MNIST")
    mcd = sgd_map.MCdropout(MCD_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                            train=ts["train"], device="cpu", model_name="MLP200MNIST")
    train = ts["train"]
    stream = native.HostStreamingSplit(train.images, train.labels, 32, train.spec, seed=2)
    streamed = sgmcmc.SGHMC(SGHMC_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                            train=stream, device="cpu")
    for s, kind in ((mcd, engine._EpochProgram), (streamed, engine._StreamProgram)):
        assert s.step_program == "graph"
        s._run_epoch()
        assert isinstance(s._program, kind) and s.epoch_program() is s._program
        assert s._program.steps_run == s._state.step > 0
    assert len(mcd._program.dropout.masks) == 2  # MLP200's two dropout calls
    assert not streamed._program.dropout.masks


def _mesh_step_programs():
    """On a world of two: the step programs of SGHMC on a (2, 1) chain mesh
    and a (1, 2) data mesh (one epoch each), and of one chain replicated
    over (2, 1); whether each built no program; whether it stepped."""
    _, ts, c = _splits("MNIST")
    out = {}
    for name, mesh, chains in (("chain", parallel.Mesh(2, 1), 2),
                               ("data", parallel.Mesh(1, 2), 1),
                               ("replicated", parallel.Mesh(2, 1), 1)):
        s = sgmcmc.SGHMC(SGHMC_HYP, model=tmodels.get_model("MLP200MNIST").build(c),
                         train=ts["train"], device="cpu", chains=chains, mesh=mesh)
        s._run_epoch(noise_on=True)
        out[name] = (s.step_program, s._program is None, bool(s._state.step))
    return out


def test_meshes_stay_eager(tmp_path):
    """No mesh stays eager any more: on any mesh of two ranks the epoch
    samplers run their program, a data mesh's step cut at its all-reduces
    (``tests/test_torch_mesh_program.py`` holds it to ``train_steps``)."""
    for rank in _spawn("test_torch_epoch_program:_mesh_step_programs", 2,
                       pathlib.Path(tmp_path)):
        assert rank == {k: ("graph", False, True) for k in ("chain", "data", "replicated")}


# -- the schedules in device form ------------------------------------------------------

def _jax_hyp(th):
    return {k: jnp.float32(float(v)) for k, v in th.items()}


def _t(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


def test_cosine_device_form_matches_jax_over_a_schedule():
    """SGHMC's cosine rate over every epoch of t_max = 12, epoch a float32
    device scalar as the program keeps it: within 2e-7 relative of JAX's
    (one float32 rounding; the host-int form gives the same bits)."""
    s = _sampler("sghmc_c3_scan")
    s._fill_hyp({"t_max": 12.0, "lr0": 0.07, "eta_min": 0.035})
    jh = _jax_hyp(s._hyp)
    for epoch in range(13):
        got = sgmcmc._cosine_hyp_lr(s._hyp, _t(epoch), _t(3, torch.int64), _t(40, torch.int64))
        assert torch.equal(got, sgmcmc._cosine_hyp_lr(s._hyp, epoch, 3, 40))
        want = float(jsgmcmc._cosine_hyp_lr(jh, jnp.float32(epoch), jnp.int32(3), 40))
        assert float(got) == pytest.approx(want, rel=2e-7, abs=0), epoch


def test_cyclic_device_form_matches_jax_over_a_schedule():
    """cSGHMC's rate over every batch of 12 epochs (three cycles), epoch
    and batch as device scalars: within the host form's tolerance of JAX's
    (``test_torch_schedules.py``), bit-equal to the host-int form."""
    s = _sampler("csghmc_gate_and_cycle")
    jh = _jax_hyp(s._hyp)
    got, want = [], []
    for epoch in range(12):
        for bi in range(s.train.num_batches):
            t = sgmcmc._cyclic_hyp_lr(s._hyp, _t(epoch), _t(bi, torch.int64), _t(0, torch.int64))
            assert torch.equal(t, sgmcmc._cyclic_hyp_lr(s._hyp, epoch, bi, 0))
            got.append(float(t))
            want.append(float(jsgmcmc._cyclic_hyp_lr(jh, jnp.float32(epoch), jnp.int32(bi), 0)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-9)


def test_one_cycle_device_form_matches_jax_over_a_schedule():
    """MCdropout's one-cycle rate over every global step, the step an int64
    device counter: within the host form's tolerance of JAX's, bit-equal to
    the host-int form."""
    _, ts, c = _splits("MNIST")
    s = sgd_map.MCdropout({**MCD_HYP, "epochs": 6}, model=tmodels.get_model("MLP200MNIST").build(c),
                          train=ts["train"], device="cpu", model_name="MLP200MNIST")
    jh = _jax_hyp(s._hyp)
    total = int(float(s._hyp["total_steps"]))
    for step in range(total + 2):
        got = sgd_map._one_cycle_hyp_lr(s._hyp, _t(0), _t(0, torch.int64),
                                        _t(step, torch.int64))
        assert torch.equal(got, sgd_map._one_cycle_hyp_lr(s._hyp, 0, 0, step))
        want = float(jsgd._one_cycle_hyp_lr(jh, 0, 0, jnp.int32(step)))
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7), step


def test_swa_schedule_device_form_matches_jax():
    values = {"lr_init": 0.05, "swag_lr": 0.01, "burn_in_epochs": 10.0}
    th = {k: _t(v) for k, v in values.items()}
    jh = _jax_hyp(th)
    for epoch in range(14):
        got = swa._swa_schedule_hyp_lr(th, _t(epoch), _t(0, torch.int64), _t(0, torch.int64))
        assert torch.equal(got, swa._swa_schedule_hyp_lr(th, epoch, 0, 0))
        want = float(jswa._swa_schedule_hyp_lr(jh, jnp.float32(epoch), 0, 0))
        assert float(got) == pytest.approx(want, rel=1e-6), epoch


# -- the update with device inputs -----------------------------------------------------

@pytest.mark.parametrize("offset", [0, 2])
def test_k1_plain_path_reads_its_seed_from_a_tensor(offset):
    """The plain path of ``sghmc_update`` fed its seed as a one-element
    int64 tensor (what the program hands it) and its first-step flag as a
    bool tensor equals the by-value seed and the Python flag, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    p, v, g = (torch.randn(2, 37, generator=gen) for _ in range(3))
    seed = 0x5DEECE66D123457
    out = []
    for s, first in ((seed, True), (torch.tensor([seed]), torch.tensor(True)),
                     (seed, False), (torch.tensor([seed]), torch.tensor(False))):
        pp, vv = p.clone(), v.clone()
        sghmc_update(pp.view(-1), vv.view(-1), g.view(-1), lr=torch.tensor(0.05),
                     momentum=torch.tensor(0.9), wd_over_n=torch.tensor(1e-3),
                     n_train=torch.tensor(100.0), noise_on=torch.tensor(1.0),
                     is_first_step=first, seed=s, offset=offset, total=2 * 37 + offset)
        out.append((pp, vv))
    for a, b in ((out[0], out[1]), (out[2], out[3])):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(out[0][1], out[2][1])


def test_sgd_update_takes_a_device_flag():
    gen = torch.Generator().manual_seed(1)
    p, v, g = (torch.randn(50, generator=gen) for _ in range(3))
    for first in (True, False):
        a, b = (p.clone(), v.clone()), (p.clone(), v.clone())
        sgd_momentum_update(*a, g, lr=0.1, momentum=0.9, weight_decay=1e-3, is_first_step=first)
        sgd_momentum_update(*b, g, lr=0.1, momentum=0.9, weight_decay=1e-3,
                            is_first_step=torch.tensor(first))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        d = g + 1e-3 * p
        assert torch.equal(a[1], d if first else 0.9 * v + d)


def test_the_cuda_wrapper_refuses_cpu_tensors_and_a_host_seed_tensor():
    """The kernel's wrapper launches on CUDA tensors only, and a seed tensor
    must lie on the buffers' device (K1 reads it there)."""
    from ursabench_tpu_torch.kernels.sghmc import _check_seed, sghmc_update_flat

    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        sghmc_update_flat(p, p.clone(), p.clone(), torch.zeros(5), torch.tensor([1]))
    with pytest.raises(ValueError, match="seed tensor"):
        _check_seed(torch.tensor([1]), p)


def test_program_runs_the_update_once_a_step():
    """Each step of the program calls the sampler's update once, with a
    device flag and a one-element seed tensor; the flag is set on the first
    global step only."""
    s = _sampler("sghmc_c1_prn8")
    calls = []
    update = s._UPDATE_FN

    def spy(state, hyp, **kw):
        calls.append((bool(kw["is_first_step"]), tuple(kw["seed"].shape), int(kw["seed"])))
        return update(state, hyp, **kw)

    s._UPDATE_FN = spy
    seeds = torch.Generator()
    seeds.set_state(s._noise_gen.get_state())
    for _ in range(2):
        _epoch(s)
    nb = s.train.num_batches
    want = torch.randint(0, 2 ** 63 - 1, (nb,), generator=seeds).tolist()
    want += torch.randint(0, 2 ** 63 - 1, (nb,), generator=seeds).tolist()
    assert [c[0] for c in calls] == [True] + [False] * (2 * nb - 1)
    assert all(c[1] == (1,) for c in calls) and [c[2] for c in calls] == want


def test_launch_counts_take_a_captured_launch_at_each_replay(monkeypatch):
    """A wrapper's count takes a launch that runs; a launch made under a
    capture runs nothing then, and counts once for each replay of the graph
    that recorded it (how the program's replays count K1's launches)."""
    from ursabench_tpu_torch import tracing

    def a():
        pass

    def b():
        pass

    a.launches = b.launches = 0
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    tracing.count(a)
    assert (a.launches, b.launches) == (1, 0)
    capturing[0] = True
    tracing.count(a)  # a capture that records nothing counts nothing
    with tracing.record() as captured:
        tracing.count(a)
        tracing.count(b)
        tracing.count(b)
    capturing[0] = False
    assert (a.launches, b.launches) == (1, 0) and captured == [a, b, b]
    for _ in range(3):
        tracing.replayed(captured)
    assert (a.launches, b.launches) == (4, 6)
