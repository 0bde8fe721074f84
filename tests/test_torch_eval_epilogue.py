"""The fused eval epilogue of a bf16 WideResNet (``kernels/eval_epilogue.py``
and ``models.common.eval_epilogue_fused``), on the CPU.

The kernels run only on the card; here their wrappers take their plain
twins, which define where the results round to bf16. The twins against the
layers' own ops, bit for bit; a small WideResNet whose rule is widened to
the CPU (as ``tests/test_torch_channels_last.py`` widens the channels-last
rule) against the same model with the rule refused; and every case the rule
leaves to the unfused ops, each counted in ``tracing``'s ``bn.eval``."""

import copy
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import tracing
from ursabench_tpu_torch.inference import engine
from ursabench_tpu_torch.inference.ensemble import Ensemble
from ursabench_tpu_torch.kernels import eval_epilogue as ee
from ursabench_tpu_torch.models import common, wideresnet

torch.set_num_threads(1)

BF16 = torch.bfloat16
CL = torch.channels_last
SHAPES = {"one_block": {"depth": 10, "widen_factor": 2},  # a shortcut in every stage
          "two_blocks": {"depth": 16, "widen_factor": 2}}  # and a block without one


@pytest.fixture(autouse=True)
def _fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def on_cpu(monkeypatch):
    """The rules of a CUDA device (channels-last, fused epilogue) on the CPU."""
    monkeypatch.setattr(common, "_CHANNELS_LAST_DEVICES", ("cuda", "cpu"))


def _unfused():
    """The rule refusing every epilogue: the layers' own ops."""
    return mock.patch.object(wideresnet, "eval_epilogue_fused", lambda *a: False)


def _randomize_bns(m, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in m.modules():
            if isinstance(bn, common.BatchNorm2d):
                bn.weight.uniform_(0.5, 1.5, generator=gen)
                bn.bias.normal_(0.0, 0.2, generator=gen)
                bn.running_mean.normal_(0.0, 0.5, generator=gen)
                bn.running_var.uniform_(0.5, 2.0, generator=gen)


def _wrn(shape="one_block", seed=0, dtype=BF16, name="WideResNet28x10"):
    m = tmodels.get_model(name).build(10, **SHAPES[shape], dtype=dtype)
    m.init_parameters(torch.Generator().manual_seed(seed))
    _randomize_bns(m, seed + 1)
    return m


def _batch(seed, n=4):
    gen = torch.Generator().manual_seed(seed + 100)
    return torch.randn(n, 3, 32, 32, generator=gen), torch.randint(0, 10, (n,), generator=gen)


def _n_bns(m) -> int:
    return sum(isinstance(b, common.BatchNorm2d) for b in m.modules())


def _activation(seed, c=16, ties=False):
    """A channels-last bf16 (2, c, 4, 4) batch; with ``ties``, values whose
    sum with a bias of 2^-8 or 3 * 2^-8 falls halfway between two bf16
    numbers (1 and 1 + 2^-7 have an ulp of 2^-7)."""
    gen = torch.Generator().manual_seed(seed)
    if ties:
        base = torch.tensor([1.0, 1.0 + 2 ** -7, -1.0, -(1.0 + 2 ** -7)])
        t = base[torch.randint(0, 4, (2, c, 4, 4), generator=gen)]
    else:
        t = torch.randn(2, c, 4, 4, generator=gen) * 2
    return t.to(BF16).contiguous(memory_format=CL)


def _tie_bias(c):
    return torch.tensor([2 ** -8, 3 * 2 ** -8, -(2 ** -8), 0.5])[torch.arange(c) % 4]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("folded", [False, True])
def test_bn_relu_twin_is_the_layers_ops(folded, ties):
    """``fused_batchnorm_eval_relu_reference`` (and the wrapper on the CPU)
    equals ``F.relu(bn(conv(a)))`` or ``F.relu(bn(x))`` of the layers
    themselves, bit for bit, the conv's bias folded in or not."""
    bn = common.BatchNorm2d(16, dtype=BF16)
    _randomize_bns(bn, 3)
    bn.eval()
    t = _activation(1, ties=ties)
    conv_bias = (_tie_bias(16) if ties else torch.randn(16)) if folded else None
    with torch.no_grad():
        want = F.relu(bn(t if conv_bias is None else t + conv_bias.to(BF16).view(1, -1, 1, 1)))
        for fn in (ee.fused_batchnorm_eval_relu_reference, ee.fused_batchnorm_eval_relu):
            got = fn(t, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps, conv_bias)
            assert got.dtype == BF16 and got.is_contiguous(memory_format=CL)
            assert torch.equal(got, want)
    if ties and folded:  # the bias add rounds before the normalization
        rounded = (t.float() + conv_bias.to(BF16).float().view(1, -1, 1, 1)).to(BF16)
        assert not torch.equal(rounded.float(), t.float() + conv_bias.view(1, -1, 1, 1))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shortcut", [False, True])
def test_bias_residual_add_twin_is_the_layers_ops(shortcut, ties):
    """``bias_residual_add_reference`` of a conv's output without its bias
    (``Conv2d.convolve``) equals ``conv(a) + x``, or ``conv(a) +
    shortcut(x)``, of the layers themselves, bit for bit."""
    conv = common.Conv2d(16, 16, 3, padding=1, dtype=BF16, bias=True)
    short = common.Conv2d(16, 16, 1, dtype=BF16, bias=True) if shortcut else None
    if ties:
        with torch.no_grad():
            conv.bias.copy_(_tie_bias(16))
    a, x = _activation(2, ties=ties), _activation(3, ties=ties)
    with torch.no_grad():
        want = conv(a) + (x if short is None else short(x))
        r, r_bias = (x, None) if short is None else (short.convolve(x), short.bias)
        for fn in (ee.bias_residual_add_reference, ee.bias_residual_add):
            got = fn(conv.convolve(a), conv.bias, r, r_bias)
            assert got.dtype == BF16 and got.is_contiguous(memory_format=CL)
            assert torch.equal(got, want)


def test_convolve_is_forward_without_its_bias():
    """``Conv2d.convolve`` is the rounded convolution that ``forward`` adds
    its bias to, and counts in ``conv.layout`` as ``forward`` does."""
    conv = common.Conv2d(16, 32, 3, padding=1, dtype=BF16, bias=True)
    a = _activation(4)
    with torch.no_grad():
        y = conv.convolve(a)
        assert torch.equal(y + conv.bias.to(BF16).view(1, -1, 1, 1), conv(a))
    assert tracing.counters()["conv.layout"] == {"channels_last": 0, "nchw": 2}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fused_wideresnet_logits_equal_the_unfused_ones(on_cpu, shape, seed):
    """A bf16 WideResNet in eval mode, its epilogues fused (the kernels'
    twins on the CPU), gives the unfused forward's logits bit for bit; every
    BatchNorm call reads as fused in ``bn.eval``, and the convs run as many
    channels-last calls as unfused."""
    m = _wrn(shape, seed).eval()
    x, _ = _batch(seed)
    with torch.no_grad():
        fused = m(x)
        counts = tracing.counters()
        with _unfused():
            unfused = m(x)
    assert counts["bn.eval"] == {"fused": _n_bns(m), "unfused": 0}
    after = tracing.counters()
    assert after["bn.eval"] == {"fused": _n_bns(m), "unfused": _n_bns(m)}
    assert after["conv.layout"]["channels_last"] == 2 * counts["conv.layout"]["channels_last"] > 0
    assert fused.dtype == torch.float32
    assert torch.equal(fused, unfused)


def test_fused_members_in_turn_equal_the_unfused_ones(on_cpu):
    """Members run in turn (``"scan"``) through ``Ensemble.logits_all``
    take the fused path, each member's state swapped in, and give the
    unfused members' logits bit for bit."""
    m = _wrn("one_block")
    states = []
    for k in range(2):
        gen = torch.Generator().manual_seed(k)
        states.append({n: v + 0.05 * torch.randn(v.shape, generator=gen)
                       if v.is_floating_point() and "running" not in n else v
                       for n, v in m.state_dict().items()})
    ens = Ensemble.from_list(m, states)
    x, _ = _batch(5)
    with torch.no_grad():
        fused = ens.member_logits(x, "scan")
        with _unfused():
            unfused = ens.member_logits(x, "scan")
    assert tracing.counters()["bn.eval"] == {"fused": 2 * _n_bns(m), "unfused": 2 * _n_bns(m)}
    assert torch.equal(fused, unfused)


def _bypass(case):
    """(model, input, context of the forward, eval-mode bf16 BN calls) of a
    case the rule leaves unfused, on the CPU with the rule widened unless
    the case is the CPU itself."""
    x, _ = _batch(7)
    if case == "fp32":
        return _wrn(dtype=None).eval(), x, torch.no_grad(), 0
    if case == "grad_enabled":
        m = _wrn().eval()
        return m, x, torch.enable_grad(), _n_bns(m)
    if case == "dropout_twin":
        m = _wrn(name="WideResNet28x10_dropout").eval()
        ctx = common.dropout_generator(m, torch.Generator().manual_seed(0))
        return m, x, ctx, _n_bns(m)
    if case == "meta":
        m = _wrn().eval().to("meta")
        return m, x.to("meta"), torch.no_grad(), _n_bns(m)
    m = _wrn().eval()
    return m, x, torch.no_grad(), _n_bns(m)


@pytest.mark.parametrize("case", ["fp32", "grad_enabled", "dropout_twin", "meta", "cpu"])
def test_the_rule_leaves_these_forwards_unfused(monkeypatch, case):
    """A float32 model, a forward that autograd records, the always-on
    dropout twin, the meta device, and the CPU by the device rule run the
    layers' own ops: no BatchNorm reads as fused, and the logits are those
    of the forward with the rule refused."""
    if case != "cpu":
        monkeypatch.setattr(common, "_CHANNELS_LAST_DEVICES", ("cuda", "cpu"))
    m, x, ctx, bf16_bns = _bypass(case)
    with ctx:
        got = m(x)
    assert tracing.counters()["bn.eval"] == {"fused": 0, "unfused": bf16_bns}
    if case in ("meta", "dropout_twin"):
        assert got.shape == (x.shape[0], 10)
        return
    with ctx, _unfused():
        want = m(x)
    assert torch.equal(got.detach(), want.detach())


def test_vmapped_members_stay_unfused(on_cpu):
    """Members under ``torch.func.vmap`` (the ``"vmap"`` layout) run the
    layers' own ops once for the batched forward."""
    m = _wrn()
    ens = Ensemble.from_list(m, [m.state_dict(), m.state_dict()])
    x, _ = _batch(8)
    with torch.no_grad():
        ens.member_logits(x, "vmap")
    assert tracing.counters()["bn.eval"] == {"fused": 0, "unfused": _n_bns(m)}


def test_an_nchw_block_input_stays_unfused(on_cpu):
    """A block given an NCHW activation (not channels-last) runs unfused and
    returns what its layers compute."""
    blk = _wrn().blocks[1].eval()
    x = _activation(9, c=blk.bn1.weight.numel()).contiguous()
    with torch.no_grad():
        got = blk(x)
        assert tracing.counters()["bn.eval"] == {"fused": 0, "unfused": 2}
        with _unfused():
            want = blk(x)
        fused = blk(x.contiguous(memory_format=CL))
    assert tracing.counters()["bn.eval"] == {"fused": 2, "unfused": 4}
    assert torch.equal(got, want)
    assert torch.equal(fused, want)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_training_mode_is_the_parents_ops(on_cpu, shape):
    """In training mode nothing fuses and nothing counts in ``bn.eval``:
    the logits, the flat gradient buffer and the running statistics equal
    those of the blocks written out as the unfused layers, bit for bit."""
    m = _wrn(shape).train()
    plain = copy.deepcopy(m)
    x, y = _batch(10)

    def plain_forward(x):
        out = plain.conv1(x)
        for blk in plain.blocks:
            h = blk.conv2(F.relu(blk.bn2(blk.conv1(F.relu(blk.bn1(out))))))
            out = h + (out if blk.shortcut is None else blk.shortcut(out))
        return plain.fc(F.relu(plain.bn(out)).to(torch.float32).mean(dim=(2, 3)))

    logits, grads = {}, {}
    for name, module, fwd in (("model", m, m), ("plain", plain, plain_forward)):
        _, flat = engine.flatten_parameters(module)
        logits[name] = fwd(x)
        engine.backward_into_views(F.cross_entropy(logits[name], y))
        grads[name] = flat
    assert tracing.counters()["bn.eval"] == {"fused": 0, "unfused": 0}
    assert torch.equal(logits["model"], logits["plain"])
    assert float(grads["model"].abs().max()) > 0
    assert torch.equal(grads["model"], grads["plain"])
    for a, b in zip(m.buffers(), plain.buffers()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad,match", [("none", "CUDA tensor"), ("nchw", "channels-last"),
                                       ("float32", "bfloat16"), ("channels", "multiple of 8")])
def test_the_wrappers_raise_on_what_the_kernels_do_not_take(bad, match):
    """Off the CPU a wrapper launches its kernel or raises: here on meta
    tensors, which no kernel takes, with the reason it finds first."""
    c = 12 if bad == "channels" else 16
    t = torch.empty(2, c, 4, 4, dtype=torch.float32 if bad == "float32" else BF16,
                    device="meta")
    if bad != "nchw":
        t = t.contiguous(memory_format=CL)
    p = torch.ones(c, device="meta")
    with pytest.raises(ValueError, match=match):
        ee.fused_batchnorm_eval_relu(t, p, p, p, p, 1e-5)
    with pytest.raises(ValueError, match=match):
        ee.bias_residual_add(t, p, t)
    assert ee.fused_batchnorm_eval_relu.launches == ee.bias_residual_add.launches == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_the_add_wrapper_needs_the_conv_bias(device):
    """``bias_residual_add`` takes the conv's bias always (every WideResNet
    conv has one): None raises, on the CPU twin's path as off it."""
    t = torch.zeros(2, 16, 4, 4, dtype=BF16, device=device).contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="bias must be"):
        ee.bias_residual_add(t, None, t)
    assert ee.bias_residual_add.launches == 0
