"""WideResNet, the MLPs and the ``_dropout`` twins of ursabench_tpu_torch
against the flax models, loaded with the same weights through
ursabench_tpu_torch.transfer: logits and BatchNorm statistics in float32 and
bf16, parameter counts, and the twins' dropout, which is checked in
distribution only (the two packages' random streams differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import models as jmodels
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

SMALL = {"depth": 10, "widen_factor": 2}  # one block a stage, 32/64/128 channels


def _as_numpy(tree):
    return jax.tree.map(np.array, tree)


def _stir(variables, seed):
    """Random running statistics, so that eval mode tests them."""
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda v: (rng.uniform(0.5, 1.5, v.shape) if v.ndim else v)
                         .astype(np.float32), variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def _small_wrn(seed=0, **kw):
    jm = jmodels.get_model("WideResNet28x10").build(10, **SMALL, **kw)
    variables = _stir(_as_numpy(jinit(jm, jax.random.PRNGKey(seed), (32, 32, 3))), seed + 1)
    return jm, variables


def _buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items() if "running" in k}


def test_wrn_matches_flax():
    """Eval and train logits, and the running statistics after one train
    forward (the blocks' momentum 0.1 and the head's 0.9, torch's
    convention), with biased convs."""
    jm, variables = _small_wrn()
    tm = params_from_jax(tmodels.get_model("WideResNet28x10").build(10, **SMALL), variables)
    assert all(m.bias is not None for m in tm.modules() if isinstance(m, torch.nn.Conv2d))
    x = np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()

    eval_j = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        eval_t = tm.eval()(xt).numpy()
    np.testing.assert_allclose(eval_t, eval_j, rtol=1e-5, atol=1e-5)

    train_j, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    with torch.no_grad():
        train_t = tm.train()(xt).numpy()
    np.testing.assert_allclose(train_t, np.asarray(train_j), rtol=1e-5, atol=1e-5)
    want = params_from_jax(tmodels.get_model("WideResNet28x10").build(10, **SMALL),
                           {"params": variables["params"],
                            "batch_stats": _as_numpy(mutated["batch_stats"])})
    got, expect = _buffers(tm), _buffers(want)
    assert got.keys() == expect.keys() and len(got) == 2 * 7  # 3 blocks x 2 BN + head
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), expect[k].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert tm.bn.momentum == 0.9 and tm.blocks[0].bn1.momentum == 0.1


def test_wrn_bf16_matches_flax():
    """bf16 convs and BatchNorm, float32 pooling and head: within 2e-2 of
    max|logit| of flax's bf16 forward, eval and train mode (the bf16
    tolerance of tests/test_torch_resnet_imagenet.py)."""
    jm, variables = _small_wrn(seed=3)
    jm16 = jmodels.get_model("WideResNet28x10").build(10, **SMALL, dtype=jnp.bfloat16)
    t16 = params_from_jax(
        tmodels.get_model("WideResNet28x10").build(10, **SMALL, dtype=torch.bfloat16),
        variables)
    x = np.random.default_rng(4).normal(size=(4, 32, 32, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    for train in (False, True):
        out = jm16.apply(variables, jnp.asarray(x), train=train,
                         **({"mutable": ["batch_stats"]} if train else {}))
        want = np.asarray((out[0] if train else out).astype(jnp.float32))
        with torch.no_grad():
            got = t16.train(train)(xt)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-2 * float(np.abs(want).max()))


def _jax_count(name, num_classes, shape):
    jm = jmodels.get_model(name).build(num_classes)
    shapes = jax.eval_shape(lambda k: jinit(jm, k, shape), jax.random.PRNGKey(0))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("name,num_classes,count", [
    ("WideResNet28x10", 10, 36489290),
    ("WideResNet28x10", 100, 36546980),
    ("WideResNet28x10_dropout", 10, 36489290),
    ("WideResNet_dropout", 100, 36546980),
    ("MLP200MNIST", 10, 199210),
    ("MLP200MNIST_dropout", 10, 199210),
    ("MLP400MNIST", 10, None),
    ("MLP600MNIST", 10, None),
])
def test_param_counts(name, num_classes, count):
    """tests/test_models.py's counts, and the flax model's for the others;
    each twin has its base's parameters."""
    shape = (28, 28, 1) if name.startswith("MLP") else (32, 32, 3)
    want = _jax_count(name, num_classes, shape)
    assert count is None or want == count
    assert sum(p.numel() for p in tmodels.get_model(name).build(num_classes).parameters()) == want


@pytest.mark.parametrize("twin,base,num_classes", [
    ("INResNet50_dropout", "INResNet50", 10),
    ("ResNet_dropout", "ResNet50", 10),
    ("TVResNet50_dropout", "TVResNet50", 1000),
])
def test_resnet_twins_equal_their_base(twin, base, num_classes):
    t, b = (tmodels.get_model(n).build(num_classes) for n in (twin, base))
    assert [(k, v.shape) for k, v in t.state_dict().items()] == \
           [(k, v.shape) for k, v in b.state_dict().items()]
    assert t.dropout.p == 0.2 and t.dropout.always
    if twin == base + "_dropout":  # ResNet_dropout is the reference's alias
        assert tmodels.dropout_twin(base).name == twin


def _mlp_pair(name, **kw):
    jm = jmodels.get_model(name).build(10)
    variables = _as_numpy(jinit(jm, jax.random.PRNGKey(5), (28, 28, 1)))
    return variables, params_from_jax(tmodels.get_model(name).build(10, **kw), variables)


def test_twin_at_p0_equals_base():
    """The twin's weights load from flax's twin (dropout has no scope), and
    at p = 0 it is its base, in eval and train mode."""
    variables, base = _mlp_pair("MLP200MNIST")
    twin = params_from_jax(tmodels.get_model("MLP200MNIST_dropout").build(10, dropout=0.0),
                           variables)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(5, 1, 28, 28))
                         .astype(np.float32))
    with torch.no_grad():
        for train in (False, True):
            assert torch.equal(twin.train(train)(x), base.train(train)(x))
    assert torch.equal(tmodels.Dropout(0.0, always=True)(x), x)
    _, wrn = _small_wrn()
    j_twin = jmodels.get_model("WideResNet28x10_dropout").build(10, **SMALL)
    v_twin = _as_numpy(jinit(j_twin, jax.random.PRNGKey(0), (32, 32, 3)))
    t_twin = params_from_jax(tmodels.get_model("WideResNet28x10_dropout").build(10, **SMALL),
                             v_twin)
    assert len(tmodels.common.dropout_layers(t_twin)) == 3 + 1  # each block + the head


def test_twin_dropout_in_eval_mode():
    """Always on in eval mode; equal under one seed, different under two;
    zeroes a share within 4 sigma of p and scales what it keeps by
    1/(1 - p); raises without a generator."""
    _, twin = _mlp_pair("MLP200MNIST_dropout")
    twin.eval()
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(5, 1, 28, 28))
                         .astype(np.float32))

    def run(seed):
        with torch.no_grad(), tmodels.dropout_generator(twin, torch.Generator().manual_seed(seed)):
            return twin(x)

    assert torch.equal(run(1), run(1)) and not torch.allclose(run(1), run(2))
    with pytest.raises(RuntimeError, match="generator"):
        twin(x)

    p, n = 0.2, 200_000
    layer = tmodels.Dropout(p, always=True).eval()
    layer.generator = torch.Generator().manual_seed(0)
    out = layer(torch.ones(n))
    zeroed = float((out == 0).float().mean())
    assert abs(zeroed - p) < 4 * (p * (1 - p) / n) ** 0.5
    assert torch.allclose(out[out != 0], torch.full((), 1 / (1 - p)))
    assert torch.equal(tmodels.Dropout(p).eval()(torch.ones(8)), torch.ones(8))


def test_transfer_checks_conv_bias():
    jm, variables = _small_wrn()
    params = jax.tree.map(lambda v: v, variables["params"])
    del params["Conv_0"]["bias"]
    with pytest.raises(KeyError, match="bias"):
        params_from_jax(tmodels.get_model("WideResNet28x10").build(10, **SMALL),
                        {"params": params, "batch_stats": variables["batch_stats"]})
