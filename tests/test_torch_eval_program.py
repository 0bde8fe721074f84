"""The evaluation programs of ursabench_tpu_torch against the JAX package's
compiled passes, on the CPU (where a program runs its step eagerly, its
plain version): the BMA pass (``tasks.base.accumulate_split``'s program)
against ``ursabench_tpu.tasks.base.accumulate_split``, the members batched
(``Ensemble.member_logits`` under vmap) against the members in turn, the
BatchNorm refresh program against ``make_bn_refresh_fn`` and the eager
``bn_refresh``, the loss program against ``make_eval_loss_fn``, and when a
program is kept or built anew."""

import jax
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu.inference.engine import make_bn_refresh_fn as jrefresh
from ursabench_tpu.inference.engine import make_eval_loss_fn as jloss
from ursabench_tpu.inference.ensemble import Ensemble as JEnsemble
from ursabench_tpu.tasks.base import accumulate_split as jaccumulate
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import inference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import tracing
from ursabench_tpu_torch.inference import engine
from ursabench_tpu_torch.inference.ensemble import EVAL_PROGRAMS, Ensemble
from ursabench_tpu_torch.models.common import Dropout, dropout_generator
from ursabench_tpu_torch.tasks import base as tbase
from ursabench_tpu_torch.transfer import params_from_jax
from ursabench_tpu_torch.util import make_generator

from test_torch_bn_refresh import MixedMomentumNet, TorchMixedMomentumNet, _data

torch.set_num_threads(1)

DATASET = {"MLP200MNIST": ("MNIST", (28, 28, 1)), "LeNet5MNIST": ("MNIST", (28, 28, 1)),
           "PreResNet8": ("CIFAR10", (32, 32, 3))}
# 20 test images in batches of 16: the last batch is filled up and sliced off
SPLIT = dict(batch_size=16, use_validation=False, synthetic_n_train=16, synthetic_n_test=20)


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def _splits(model):
    dataset, _ = DATASET[model]
    sj, c = jdata.loaders(dataset, None, **SPLIT)
    st, _ = tdata.loaders(dataset, None, **SPLIT)
    return sj["test"], st["test"], c


def _ensembles(model, members, num_classes, dtype=None):
    """The same ``members`` flax initialisations as a JAX and a port
    ensemble (the port's built with ``dtype``)."""
    jm = jmodels.get_model(model).build(num_classes)
    variables = [jax.tree.map(np.array, jinit(jm, jax.random.PRNGKey(10 + k),
                                              DATASET[model][1])) for k in range(members)]
    build = lambda: tmodels.get_model(model).build(  # noqa: E731
        num_classes, **({} if dtype is None else {"dtype": dtype}))
    states = [{k: v.clone() for k, v in params_from_jax(build(), v).state_dict().items()}
              for v in variables]
    return JEnsemble.from_list(jm, variables), Ensemble.from_list(build(), states)


# -- the BMA pass -------------------------------------------------------------------------------

@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("members", [1, 3])
@pytest.mark.parametrize("model", sorted(DATASET))
def test_pass_program_matches_jax(model, members, smooth):
    jsplit, tsplit, c = _splits(model)
    jens, tens = _ensembles(model, members, c)
    want_p, want_e = jaccumulate(jens, jsplit, smooth_probs=smooth)
    before = tracing.counters()["bma.pass"]["passes"]
    got_p, got_e = tbase.accumulate_split(tens, tsplit, smooth_probs=smooth)
    assert got_p.shape == (tsplit.n, c) and got_e.shape == (tsplit.n,)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_e, want_e, rtol=1e-6, atol=1e-6)
    prog = tbase.bma_program(tens, tsplit, smooth)
    assert prog.path == "eager" and prog.steps_run == tsplit.num_batches  # the CPU's
    assert tracing.counters()["bma.pass"]["passes"]["eager"] == before["eager"] + 1
    assert EVAL_PROGRAMS["bma"] == "graph"  # what the card runs


@pytest.mark.parametrize("strategy", ["scan", "vmap"])
def test_both_layouts_in_the_pass_match_jax(strategy):
    jsplit, tsplit, c = _splits("PreResNet8")
    jens, tens = _ensembles("PreResNet8", 3, c)
    tens.member_strategy = strategy
    want = jaccumulate(jens, jsplit, smooth_probs=False)
    got = tbase.accumulate_split(tens, tsplit, smooth_probs=False)
    assert tbase.bma_program(tens, tsplit, False).strategy == strategy
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_the_pass_restores_the_modules_mode_and_equals_its_eager_steps():
    _, tsplit, c = _splits("LeNet5MNIST")
    _, tens = _ensembles("LeNet5MNIST", 2, c)
    tens.module.train()
    prog = tbase.bma_program(tens, tsplit, True)
    eager_steps = prog(eager=True)
    got = tbase.accumulate_split(tens, tsplit, smooth_probs=True)
    assert tens.module.training
    for g, e in zip(got, eager_steps):
        assert np.array_equal(g, e)


# -- members batched against in turn ------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(DATASET))
def test_batched_logits_equal_the_members_in_turn_in_fp32(model):
    _, tsplit, c = _splits(model)
    _, tens = _ensembles(model, 3, c)
    h, w, ch = DATASET[model][1]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, ch, h, w)).astype(np.float32))
    batched, in_turn = tens.member_logits(x, "vmap"), tens.member_logits(x, "scan")
    np.testing.assert_allclose(batched.numpy(), in_turn.numpy(), rtol=1e-6, atol=1e-6)
    plain = []
    for i in range(3):  # a plain module loaded with member i's state
        m = tmodels.get_model(model).build(c)
        m.load_state_dict(tens.member(i))
        with torch.no_grad():
            plain.append(m.eval()(x))
    assert torch.equal(in_turn, torch.stack(plain))


@pytest.mark.parametrize("model", ["LeNet5MNIST", "PreResNet8"])
def test_batched_logits_equal_the_members_in_turn_in_bf16(model):
    """bf16 members within the port's bf16 tolerance on probabilities
    (tests/test_torch_profiling.py's engines: 1e-3)."""
    _, tsplit, c = _splits(model)
    _, tens = _ensembles(model, 3, c, dtype=torch.bfloat16)
    h, w, ch = DATASET[model][1]
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, ch, h, w)).astype(np.float32))
    probs = [torch.softmax(tens.member_logits(x, s).float(), -1) for s in ("vmap", "scan")]
    np.testing.assert_allclose(probs[0].numpy(), probs[1].numpy(), rtol=0, atol=1e-3)


def _dropout_ensemble(members=3, seed=7):
    module = tmodels.get_model("MLP200MNIST_dropout").build(10)
    module.init_parameters(make_generator("cpu", 0, "init"))
    state = {k: v.detach().clone().expand((members,) + tuple(v.shape))
             for k, v in module.state_dict().items()}
    return Ensemble(module, state, members, dropout_seed=seed)


def _recorded_masks(ens, x, batch_idx):
    """Each member's masks as a plain forward with its generator bound
    draws them (``Dropout.draw`` recorded), and that forward's logits."""
    masks, logits = [], []
    draw = Dropout.draw

    def recording(layer, shape, gen):
        out = draw(layer, shape, gen)
        masks[-1].append(out)
        return out

    Dropout.draw = recording
    try:
        for i in range(ens.local_members):
            masks.append([])
            m = tmodels.get_model("MLP200MNIST_dropout").build(10)
            m.load_state_dict({k: v.clone() for k, v in ens.member(i).items()})
            with torch.no_grad(), dropout_generator(
                    m, make_generator("cpu", ens.dropout_seed, i, batch_idx)):
                logits.append(m.eval()(x))
    finally:
        Dropout.draw = draw
    return masks, torch.stack(logits)


@pytest.mark.parametrize("batch_idx", [0, 3])
def test_dropout_members_draw_bit_equal_masks_batched_and_in_turn(batch_idx):
    ens = _dropout_ensemble()
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(6, 1, 28, 28)).astype(np.float32))
    want_masks, want_logits = _recorded_masks(ens, x, batch_idx)
    calls = ens.dropout_calls(x)
    masks = ens.draw_masks(calls, batch_idx)
    assert len(calls) == 2
    for layer, drawn in enumerate(masks):
        for i in range(ens.local_members):
            assert torch.equal(drawn[i], want_masks[i][layer])
    layers = [layer for layer, _ in calls]
    scan = ens.member_logits(x, "scan", layers, masks)
    vmapped = ens.member_logits(x, "vmap", layers, masks)
    assert torch.equal(scan, want_logits)
    np.testing.assert_allclose(vmapped.numpy(), want_logits.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(ens.logits_all(x, batch_idx), vmapped)  # the MLP rule: vmap
    assert not torch.equal(ens.logits_all(x, batch_idx + 1), vmapped)


def test_a_dropout_ensembles_pass_equals_its_members_in_turn():
    ens = _dropout_ensemble()
    _, tsplit, _ = _splits("MLP200MNIST")
    p, e = tbase.accumulate_split(ens, tsplit, smooth_probs=False)
    from ursabench_tpu_torch.data.transforms import normalize

    want_p = np.zeros_like(p)
    for bi, lo in enumerate(range(0, tsplit.n, tsplit.batch_size)):
        x = normalize(torch.from_numpy(tsplit.images[lo:lo + tsplit.batch_size]), tsplit.spec)
        x = x.permute(0, 3, 1, 2).contiguous()
        if x.shape[0] < tsplit.batch_size:  # the last batch, filled up with index 0
            fill = normalize(torch.from_numpy(tsplit.images[:1]), tsplit.spec)
            fill = fill.permute(0, 3, 1, 2).expand(tsplit.batch_size - x.shape[0], -1, -1, -1)
            x = torch.cat([x, fill])
        _, logits = _recorded_masks(ens, x, bi)
        probs = torch.softmax(logits, -1).sum(0)[:tsplit.n - lo]
        want_p[lo:lo + tsplit.batch_size] = probs.numpy()
    np.testing.assert_allclose(p, want_p, rtol=1e-6, atol=1e-6)
    assert np.isfinite(e).all()


# -- BatchNorm refresh ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 70])  # 70: the last batch filled up with the first 10
def test_refresh_program_with_mixed_momenta_matches_jax(n):
    jsplit, tsplit = _data(n, 16)
    module = MixedMomentumNet()
    variables = jax.tree.map(np.array, jinit(module, jax.random.PRNGKey(0), (8, 8, 1)))
    want = jrefresh(module, jsplit)(variables["params"], variables["batch_stats"])
    net = params_from_jax(TorchMixedMomentumNet(), variables)
    net.bn1.running_mean.fill_(3.0)  # the refresh starts from its own reset
    net.eval()
    engine.make_bn_refresh_fn(net, tsplit)()
    assert not net.training and (net.bn1.momentum, net.bn2.momentum) == (0.1, 0.9)
    for layer, name in ((net.bn1, "BatchNorm_0"), (net.bn2, "BatchNorm_1")):
        for buf, key in ((layer.running_mean, "mean"), (layer.running_var, "var")):
            np.testing.assert_allclose(buf.numpy(), np.asarray(want[name][key]),
                                       rtol=0, atol=1e-5, err_msg=f"{name}/{key}")


def test_wrn_refresh_program_matches_jax():
    """A small WideResNet: the blocks at torch momentum 0.1, the head at
    0.9."""
    jm = jmodels.get_model("WideResNet28x10").build(10, depth=10, widen_factor=1)
    variables = jax.tree.map(np.array, jinit(jm, jax.random.PRNGKey(1), (32, 32, 3)))
    rng = np.random.default_rng(2)
    images = rng.integers(0, 255, (40, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 40)
    from ursabench_tpu.data import DataSplit as JSplit
    from ursabench_tpu.data.transforms import ImageSpec as JSpec
    from ursabench_tpu_torch.data.arrays import DataSplit as TSplit
    from ursabench_tpu_torch.data.transforms import ImageSpec as TSpec

    mean, std = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
    jsplit = JSplit(images, labels, 16, JSpec(32, 3, mean, std))
    tsplit = TSplit(images, labels, 16, TSpec(32, 3, mean, std))
    want = jrefresh(jm, jsplit)(variables["params"], variables["batch_stats"])
    build = lambda: tmodels.get_model("WideResNet28x10").build(  # noqa: E731
        10, depth=10, widen_factor=1)
    got = params_from_jax(build(), variables)
    engine.make_bn_refresh_fn(got, tsplit)()
    ref = params_from_jax(build(), {"params": variables["params"],
                                    "batch_stats": jax.tree.map(np.array, want)})
    for k, v in ref.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(got.state_dict()[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)


def _cifar_split(n=50, bsz=16, seed=3):
    from ursabench_tpu_torch.data.arrays import DataSplit
    from ursabench_tpu_torch.data.transforms import ImageSpec

    rng = np.random.default_rng(seed)
    return DataSplit(rng.integers(0, 255, (n, 32, 32, 3), dtype=np.uint8),
                     rng.integers(0, 10, n), bsz, ImageSpec(32, 3, (0.5,) * 3, (0.25,) * 3))


# the dropout twin's masks come from (dropout_seed 0, batch) as bn_refresh draws them
@pytest.mark.parametrize("model", ["PreResNet8", "WideResNet28x10", "WideResNet28x10_dropout"])
def test_refresh_program_equals_the_eager_refresh_after_weights_change_in_place(model):
    kw = dict(depth=10, widen_factor=1) if model.startswith("WideResNet") else {}
    split = _cifar_split()
    a = tmodels.get_model(model).build(10, **kw)
    a.init_parameters(make_generator("cpu", 0, "a"))
    b = tmodels.get_model(model).build(10, **kw)
    b.load_state_dict(a.state_dict())
    refresh = engine.make_bn_refresh_fn(a, split)
    refresh()
    with torch.no_grad():  # new weights, written in place
        for pa, pb in zip(a.parameters(), b.parameters()):
            noise = torch.randn(pa.shape, generator=torch.Generator().manual_seed(pa.numel()))
            pa.add_(0.1 * noise)
            pb.add_(0.1 * noise)
    refresh()
    engine.bn_refresh(b, split)
    assert refresh.steps_run == 2 * split.num_batches
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        if "running" in k:
            np.testing.assert_allclose(va.numpy(), vb.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


# -- validation loss -----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 70])  # 70: the padded rows masked out
def test_loss_program_matches_jax(n):
    jsplit, tsplit = _data(n, 16, seed=4)
    module = MixedMomentumNet()
    variables = jax.tree.map(np.array, jinit(module, jax.random.PRNGKey(5), (8, 8, 1)))
    want = float(jloss(module, jsplit)(variables["params"], variables["batch_stats"]))
    net = params_from_jax(TorchMixedMomentumNet(), variables)
    other = TorchMixedMomentumNet()  # the program's module holds other weights
    loss = engine.make_eval_loss_fn(other, tsplit)
    got = loss(net.state_dict())
    assert got.dim() == 0 and float(got) == pytest.approx(want, rel=1e-6, abs=1e-6)
    assert float(loss(net.state_dict())) == float(got) and loss.steps_run == 2 * tsplit.num_batches
    assert float(got) == float(engine.eval_loss(net, tsplit))


def test_a_dropout_twins_loss_program_equals_eval_loss():
    """The twin's dropout stays on in eval mode: each batch's masks drawn
    into static buffers from (dropout_seed 0, batch), as eval_loss draws
    them."""
    split = _cifar_split(n=40, seed=6)
    twin = tmodels.get_model("WideResNet28x10_dropout").build(10, depth=10, widen_factor=1)
    twin.init_parameters(make_generator("cpu", 0, "twin"))
    loss = engine.make_eval_loss_fn(twin, split)
    assert len(loss.calls) == 4
    assert float(loss()) == float(engine.eval_loss(twin, split))


def test_compute_val_loss_keeps_one_program_a_split():
    splits, c = tdata.loaders("MNIST", None, batch_size=16, use_validation=False,
                              synthetic_n_train=32, synthetic_n_test=24)
    s = inference.SGD({"lr": 0.05, "epochs": 1, "momentum": 0.9, "weight_decay": 5e-4},
                      model=tmodels.get_model("MLP200MNIST").build(c), train=splits["train"],
                      device="cpu")
    first = s.compute_val_loss(splits["test"])
    prog = s._val_loss_programs[id(splits["test"])][1]
    assert s.compute_val_loss(splits["test"]) == first
    assert s._val_loss_programs[id(splits["test"])][1] is prog
    assert first == pytest.approx(float(engine.eval_loss(s.module, splits["test"])), rel=1e-6)
    s.compute_val_loss(splits["train"])
    assert len(s._val_loss_programs) == 2


# -- when programs are kept ----------------------------------------------------------------------

def test_a_second_pass_reuses_the_program_and_a_new_ensemble_builds_one():
    _, tsplit, c = _splits("MLP200MNIST")
    _, tens = _ensembles("MLP200MNIST", 2, c)
    first = tbase.accumulate_split(tens, tsplit, smooth_probs=False)
    prog = tbase.bma_program(tens, tsplit, False)
    with torch.no_grad():  # in place: the same program reads the new weights
        for v in tens.state.values():
            v.mul_(0.5)
    second = tbase.accumulate_split(tens, tsplit, smooth_probs=False)
    assert tbase.bma_program(tens, tsplit, False) is prog
    assert prog.steps_run == 2 * tsplit.num_batches
    assert not np.array_equal(first[0], second[0])
    tbase.accumulate_split(tens, tsplit, smooth_probs=True)  # another program: the flag
    assert len(tens._programs) == 2
    other = Ensemble(tens.module, tens.state, tens.num_members)
    tbase.accumulate_split(other, tsplit, smooth_probs=False)
    assert tbase.bma_program(other, tsplit, False) is not prog
    tens.state = {k: v.clone() for k, v in tens.state.items()}  # new state tensors
    again = tbase.accumulate_split(tens, tsplit, smooth_probs=False)
    assert tbase.bma_program(tens, tsplit, False) is not prog
    for a, b in zip(again, second):
        assert np.array_equal(a, b)


def test_swag_keeps_one_refresh_program_across_its_draws():
    splits, c = tdata.loaders("CIFAR10", None, batch_size=16, use_validation=False,
                              synthetic_n_train=32, synthetic_n_test=16)
    hyp = {"swag_lr": 0.01, "swag_wd": 5e-4, "lr_init": 0.05, "num_samples": 3,
           "momentum": 0.9, "burn_in_epochs": 1, "num_iterates": 2}
    s = inference.SWAG(hyp, model=tmodels.get_model("PreResNet8").build(c),
                       train=splits["train"], device="cpu", max_rank=2, pca_rank=2)
    ens = s.sample(3)
    refresh = s._bn_refresh
    assert ens.num_members == 3 and refresh.steps_run == 3 * splits["train"].num_batches
    s.sample(1)
    assert s._bn_refresh is refresh and refresh.path == "eager"
    assert EVAL_PROGRAMS["bn_refresh"] == EVAL_PROGRAMS["val_loss"] == "graph"


def test_a_dropped_ensemble_frees_its_programs_without_a_collection():
    """The programs refer to their ensemble weakly: dropping the ensemble
    frees them (on the card their graphs) at once, never in a garbage
    collection that could run inside another program's capture."""
    import gc
    import weakref

    _, tsplit, c = _splits("MLP200MNIST")
    _, tens = _ensembles("MLP200MNIST", 2, c)
    tbase.accumulate_split(tens, tsplit, smooth_probs=False)
    prog = weakref.ref(tbase.bma_program(tens, tsplit, False))
    assert prog() is not None
    gc.disable()
    try:
        del tens
        assert prog() is None
    finally:
        gc.enable()
