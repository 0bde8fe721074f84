"""Channels-last activations for the port's 16-bit convolutions
(``models.common.Conv2d``), on the CPU.

On a CUDA device a bf16 conv casts its input and kernel channels-last and
the activations after the stem stay so, but for a 1x1 conv that narrows its
channels, which runs NCHW; float32 convs, the CPU, and forwards under
``torch.func.vmap`` keep their input's format. The CPU is left out by the layer's own
device rule, so these tests widen that rule to the CPU to run the
channels-last path here: its logits and one training step's gradients
against a plain NCHW forward written below with ``F.conv2d`` on contiguous
tensors, the flat gradient buffer's views, the layout of every activation,
and the paths that keep NCHW."""

import copy

import pytest
import torch
import torch.nn.functional as F

from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import tracing
from ursabench_tpu_torch.inference import engine, sgmcmc
from ursabench_tpu_torch.inference.ensemble import Ensemble
from ursabench_tpu_torch.models import common
from ursabench_tpu_torch.models.resnet_imagenet import TVResNet

torch.set_num_threads(1)

SMALL = {"depth": 10, "widen_factor": 2}  # one block a stage, 32/64/128 channels
BF16 = torch.bfloat16
CL = torch.channels_last


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def on_cpu(monkeypatch):
    """The channels-last rule of a CUDA device, applied to the CPU's tensors."""
    monkeypatch.setattr(common, "_CHANNELS_LAST_DEVICES", ("cuda", "cpu"))


def _wrn(seed=0, dtype=BF16):
    m = tmodels.get_model("WideResNet28x10").build(10, **SMALL, dtype=dtype)
    m.init_parameters(torch.Generator().manual_seed(seed))
    return m


def _batch(seed, n=16):
    gen = torch.Generator().manual_seed(seed + 100)
    return torch.randn(n, 3, 32, 32, generator=gen), torch.randint(0, 10, (n,), generator=gen)


def _plain_conv(conv, x):
    d = conv.compute_dtype
    assert x.is_contiguous()
    y = F.conv2d(x.to(d), conv.weight.to(d), None, conv.stride, conv.padding)
    return y if conv.bias is None else y + conv.bias.to(d).view(1, -1, 1, 1)


def _plain_wrn(m, x):
    """``WideResNet.forward`` with every conv on contiguous NCHW tensors."""
    out = _plain_conv(m.conv1, x)
    for blk in m.blocks:
        h = _plain_conv(blk.conv1, F.relu(blk.bn1(out)))
        h = _plain_conv(blk.conv2, F.relu(blk.bn2(h)))
        out = h + (out if blk.shortcut is None else _plain_conv(blk.shortcut, out))
    return m.fc(F.relu(m.bn(out)).to(torch.float32).mean(dim=(2, 3)))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _n_convs(m) -> int:
    return sum(isinstance(c, common.Conv2d) for c in m.modules())


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_logits_match_a_plain_nchw_forward(on_cpu, seed):
    """The same weights, the same convs and BatchNorms in another memory
    order: within one bf16 rounding of the logits' scale."""
    m = _wrn(seed).eval()
    x, _ = _batch(seed)
    with torch.no_grad():
        got, want = m(x), _plain_wrn(copy.deepcopy(m), x)
    assert tracing.counters()["conv.layout"] == {"channels_last": _n_convs(m), "nchw": 0}
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=2 ** -8 * float(want.abs().max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_training_step_gradients_match_a_plain_forward_in_the_flat_buffer(on_cpu, seed):
    """One training step's flat gradient buffer against the plain forward's:
    no further apart than bf16's own error (the plain bf16 step's distance
    from the float32 step's, 0.10-0.11 here, against 0.04-0.06). The
    parameters' ``.grad`` stay the views of the buffer, written in place.
    The running statistics, taken from the bf16 activations, are held to
    the same bound."""
    m = _wrn(seed).train()
    plain = copy.deepcopy(m)
    fp32 = _wrn(seed, dtype=None).train()
    x, y = _batch(seed)
    grads = {}
    for name, module, fwd in (("cl", m, m), ("plain", plain, lambda x: _plain_wrn(plain, x)),
                              ("fp32", fp32, fp32)):
        _, flat = engine.flatten_parameters(module)
        views = [p.grad for p in module.parameters()]
        engine.backward_into_views(F.cross_entropy(fwd(x), y))
        assert all(p.grad is v for p, v in zip(module.parameters(), views))
        assert all(v.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
                   for v in views)
        grads[name] = flat
    assert float(grads["cl"].abs().max()) > 0
    assert _rel(grads["cl"], grads["plain"]) <= _rel(grads["plain"], grads["fp32"]) < 0.25
    stats = {name: torch.cat([b.reshape(-1) for b in module.buffers()])
             for name, module in (("cl", m), ("plain", plain), ("fp32", fp32))}
    assert 0 < _rel(stats["cl"], stats["plain"]) <= _rel(stats["plain"], stats["fp32"])


@pytest.mark.parametrize("train", [False, True])
def test_activations_after_the_stem_are_channels_last(on_cpu, train):
    """The stem's input is the data path's NCHW batch; the output of every
    layer after it, forward and backward, is channels-last, up to the pooled
    features."""
    m = _wrn().train(train)
    seen = []
    hooks = [mod.register_forward_hook(lambda mod, i, o, n=n: seen.append((n, i[0], o)))
             for n, mod in m.named_modules() if n]
    x, y = _batch(0)
    x.requires_grad_(train)
    logits = m(x)
    for h in hooks:
        h.remove()
    stem = [i for n, i, _ in seen if n == "conv1"]
    assert len(stem) == 1 and stem[0].is_contiguous()
    maps = [(n, o) for n, _, o in seen if o.dim() == 4]
    assert maps and all(o.is_contiguous(memory_format=CL) and not o.is_contiguous()
                        for _, o in maps), [n for n, o in maps if not o.is_contiguous(
                            memory_format=CL)]
    if train:
        grad_of = {}
        for n, o in maps:
            o.register_hook(lambda g, n=n: grad_of.__setitem__(n, g))
        F.cross_entropy(logits, y).backward()
        assert set(grad_of) and all(g.is_contiguous(memory_format=CL) for g in grad_of.values())


@pytest.mark.parametrize("kernel,cin,cout,dtype,want", [
    (3, 16, 16, BF16, CL),
    (1, 16, 32, BF16, CL),  # widens, as a WideResNet shortcut
    (1, 32, 32, BF16, CL),
    (1, 32, 16, BF16, torch.contiguous_format),  # narrows, as a bottleneck's first conv
    (3, 16, 16, None, torch.preserve_format),
])
def test_a_conv_runs_the_format_its_rule_gives(on_cpu, kernel, cin, cout, dtype, want):
    """Given a channels-last input, as a layer before it hands it on, a conv
    runs and returns the format ``memory_format`` gives, and computes what a
    plain NCHW conv computes."""
    conv = common.Conv2d(cin, cout, kernel, padding=kernel // 2, dtype=dtype, bias=True)
    x = torch.randn(2, cin, 8, 8, generator=torch.Generator().manual_seed(3))
    assert conv.memory_format(x.contiguous(memory_format=CL)) == want
    y = conv(x.contiguous(memory_format=CL))
    assert y.is_contiguous(memory_format=CL if want == torch.preserve_format else want)
    assert tracing.counters()["conv.layout"] == {"channels_last": int(want == CL),
                                                 "nchw": int(want != CL)}
    with torch.no_grad():
        want_y = (_plain_conv(conv, x) if dtype else
                  F.conv2d(x, conv.weight, conv.bias, padding=kernel // 2))
    torch.testing.assert_close(y.detach(), want_y, rtol=0,
                               atol=2 ** -8 * float(want_y.abs().max()))


def test_a_bottleneck_resnet_narrows_in_nchw(on_cpu, monkeypatch):
    """A bf16 bottleneck ResNet mixes the two: its narrowing 1x1 convs run
    NCHW and every other conv channels-last, in a training step whose
    gradients all reach the parameters; its eval logits match the same
    model with every conv in NCHW within one bf16 rounding of their scale."""
    m = TVResNet(layers=(1, 1, 1, 1), bottleneck=True, num_classes=10, dtype=BF16)
    m.init_parameters(torch.Generator().manual_seed(0))
    outs = {}
    hooks = [c.register_forward_hook(lambda c, i, o, n=n: outs.__setitem__(n, o))
             for n, c in m.named_modules() if isinstance(c, common.Conv2d)]
    gen = torch.Generator().manual_seed(4)
    x, y = torch.randn(4, 3, 64, 64, generator=gen), torch.randint(0, 10, (4,), generator=gen)
    F.cross_entropy(m.train()(x), y).backward()
    for h in hooks:
        h.remove()
    narrow = {n for n, c in m.named_modules() if isinstance(c, common.Conv2d)
              and c.kernel_size == (1, 1) and c.in_channels > c.out_channels}
    assert narrow == {"layer2.0.conv1", "layer3.0.conv1", "layer4.0.conv1"}
    assert all(o.is_contiguous() == (n in narrow) for n, o in outs.items())
    assert all(o.is_contiguous(memory_format=CL) for n, o in outs.items() if n not in narrow)
    assert tracing.counters()["conv.layout"] == {"channels_last": len(outs) - 3, "nchw": 3}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in m.parameters())
    with torch.no_grad():
        got = m.eval()(x)
        monkeypatch.setattr(common, "_CHANNELS_LAST_DEVICES", ("cuda",))
        want = m(x)
    torch.testing.assert_close(got, want, rtol=0, atol=2 ** -8 * float(want.abs().max()))


@pytest.mark.parametrize("name,dtype,widened", [
    ("PreResNet8", None, True),  # float32: cuDNN's fp32 kernels read NCHW
    ("WideResNet28x10", BF16, False),  # the CPU, by the device rule
])
def test_these_convs_keep_nchw(monkeypatch, name, dtype, widened):
    """A float32 PreResNet on a device that runs 16-bit convs channels-last,
    and a bf16 WideResNet on the CPU, keep NCHW throughout and count no
    channels-last call."""
    if widened:
        monkeypatch.setattr(common, "_CHANNELS_LAST_DEVICES", ("cuda", "cpu"))
    m = tmodels.get_model(name).build(10, **(SMALL if name == "WideResNet28x10" else {}),
                                      dtype=dtype)
    outs = []
    hooks = [mod.register_forward_hook(lambda mod, i, o: outs.append(o))
             for mod in m.modules() if isinstance(mod, (common.Conv2d, common.BatchNorm2d))]
    x, y = _batch(0, 4)
    F.cross_entropy(m.train()(x), y).backward()
    for h in hooks:
        h.remove()
    assert outs and all(o.is_contiguous() for o in outs)
    assert tracing.counters()["conv.layout"] == {"channels_last": 0, "nchw": _n_convs(m)}


def test_vmap_members_keep_nchw_and_equal_scan_members(on_cpu):
    """bf16 members under ``member_strategy="vmap"`` run NCHW (a batched
    tensor cannot be channels-last) and give the logits ``"scan"`` gives
    channels-last, within one bf16 rounding of their scale."""
    m = _wrn()
    states = []
    for k in range(3):
        gen = torch.Generator().manual_seed(k)
        states.append({n: v + 0.05 * torch.randn(v.shape, generator=gen)
                       if v.is_floating_point() and "running" not in n else v
                       for n, v in m.state_dict().items()})
    ens = Ensemble.from_list(m, states)
    x, _ = _batch(2, 8)
    with torch.no_grad():
        vmapped = ens.member_logits(x, "vmap")
        assert tracing.counters()["conv.layout"] == {"channels_last": 0, "nchw": _n_convs(m)}
        scanned = ens.member_logits(x, "scan")
    assert tracing.counters()["conv.layout"]["channels_last"] == 3 * _n_convs(m)
    assert vmapped.shape == scanned.shape == (3, 8, 10)
    torch.testing.assert_close(vmapped, scanned, rtol=0,
                               atol=2 ** -8 * float(scanned.abs().max()))


@pytest.mark.parametrize("strategy", ["vmap", "scan"])
def test_two_bf16_chains_step_in_either_strategy(on_cpu, strategy):
    """A 2-chain bf16 SGHMC epoch runs under each chain strategy: "vmap"'s
    one batched forward keeps NCHW, "scan"'s chains run channels-last; both
    write finite, distinct chains into the flat buffers."""
    splits, c = tdata.loaders("CIFAR10", None, batch_size=16, use_validation=False,
                              synthetic_n_train=32, synthetic_n_test=16)
    hyp = {"lr": 0.01, "prior_std": 1.0, "alpha": 0.1, "burn_in_epochs": 1, "num_samples": 1}
    s = sgmcmc.SGHMC(hyp, model=tmodels.get_model("WideResNet28x10").build(c, **SMALL,
                                                                         dtype=BF16),
                     train=splits["train"], seed=0, device="cpu", chains=2,
                     chain_strategy=strategy)
    assert s._resolved_chain_strategy == strategy
    start = s._state.params.clone()
    tracing.reset()
    loss = s._run_epoch(noise_on=True)
    layout = tracing.counters()["conv.layout"]
    assert layout["channels_last" if strategy == "vmap" else "nchw"] == 0
    assert layout["nchw" if strategy == "vmap" else "channels_last"] > 0
    assert s._state.step == 2 and bool(torch.isfinite(loss).all())
    assert bool(torch.isfinite(s._state.params).all())
    moved = (s._state.params - start).abs().amax(1)
    assert float(moved.min()) > 0
    assert float((s._state.params[0] - s._state.params[1]).abs().max()) > 0
