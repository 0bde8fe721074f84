"""INResNet and TVResNet in ursabench_tpu_torch against the flax models,
loaded with the same weights through ursabench_tpu_torch.transfer:
parameter counts and layout, eval and train-mode logits, the BatchNorm
running statistics after one train-mode forward, and the compute ``dtype``
(bf16 convs and BatchNorm, float32 pooling and head) in PreResNet and
TVResNet. TVResNet is compared with flax's plain 7x7 stem (``stem_s2d=False``)
at the float32 bound of tests/test_torch_models.py, and with its default
space-to-depth stem at the JAX package's own bound for that rewrite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import models as jmodels
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu.models.resnet_imagenet import INResNet as JINResNet
from ursabench_tpu.models.resnet_imagenet import TVResNet as JTVResNet
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.models.resnet_imagenet import INResNet, TVResNet
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

# (flax module kwargs, torch class, input side, classes)
SMALL = {
    "tv_bottleneck_1111": (dict(layers=(1, 1, 1, 1), bottleneck=True), TVResNet, 64, 10),
    "tv18": (dict(layers=(2, 2, 2, 2), bottleneck=False), TVResNet, 64, 10),
    "in18": (dict(layers=(2, 2, 2, 2), bottleneck=False), INResNet, 32, 10),
}


def _as_numpy(tree):
    return jax.tree.map(np.array, tree)


def _flax(cls, kw, classes, **extra):
    if cls is TVResNet:
        return JTVResNet(num_classes=classes, **kw, **extra)
    return JINResNet(num_classes=classes, **kw, **extra)


def _stir_batchnorm(variables, seed):
    """BatchNorm scales, biases and running statistics away from their
    initial 1/0, so that eval mode is not an identity."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for name, node in params.items():
            if name.startswith("BatchNorm"):
                c = node["scale"].shape
                node["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                node["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[name]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                stats[name]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            elif isinstance(node, dict) and "kernel" not in node:
                walk(node, stats[name])

    walk(variables["params"], variables["batch_stats"])
    return variables


@pytest.fixture(scope="module", params=sorted(SMALL))
def small(request):
    kw, cls, side, classes = SMALL[request.param]
    jm = _flax(cls, kw, classes, **({"stem_s2d": False} if cls is TVResNet else {}))
    variables = _stir_batchnorm(_as_numpy(jinit(jm, jax.random.PRNGKey(0),
                                                (side, side, 3))), seed=1)
    tm = params_from_jax(cls(num_classes=classes, **kw), variables)
    x = np.random.default_rng(2).normal(size=(4, side, side, 3)).astype(np.float32)
    return {"name": request.param, "kw": kw, "cls": cls, "classes": classes, "jm": jm,
            "variables": variables, "tm": tm, "x": x,
            "xt": torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()}


def _buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items() if "running" in k}


def test_eval_and_train_logits_and_running_stats_match_flax(small):
    jm, variables, tm, x = small["jm"], small["variables"], small["tm"], small["x"]
    eval_j = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        eval_t = tm.eval()(small["xt"]).numpy()
    np.testing.assert_allclose(eval_t, eval_j, rtol=1e-5, atol=1e-5)

    train_j, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    with torch.no_grad():
        train_t = tm.train()(small["xt"]).numpy()
    np.testing.assert_allclose(train_t, np.asarray(train_j), rtol=1e-5, atol=1e-5)

    want = params_from_jax(small["cls"](num_classes=small["classes"], **small["kw"]),
                           {"params": variables["params"],
                            "batch_stats": _as_numpy(mutated["batch_stats"])})
    got, expect = _buffers(tm), _buffers(want)
    assert got.keys() == expect.keys() and len(got) > 0
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), expect[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_plain_stem_matches_the_space_to_depth_stem():
    """The JAX package's default TVResNet stem is the space-to-depth rewrite;
    the port's plain 7x7/2 conv agrees with it within the bound the JAX
    package holds the rewrite to (tests/test_models.py:124-125)."""
    kw = SMALL["tv_bottleneck_1111"][0]
    jm = JTVResNet(num_classes=10, **kw)  # stem_s2d=True
    variables = _stir_batchnorm(_as_numpy(jinit(jm, jax.random.PRNGKey(3), (64, 64, 3))),
                                seed=4)
    tm = params_from_jax(TVResNet(num_classes=10, **kw), variables)
    x = np.random.default_rng(5).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,count,side,classes", [
    ("TVResNet50", 25557032, 64, 1000),
    ("TVResNet18", 11689512, 64, 1000),
    ("INResNet18", 11173962, 32, 10),
    ("INResNet50", 23520842, 32, 10),
])
def test_param_counts_and_layout(name, count, side, classes):
    """The counts of tests/test_models.py:26-32, and every flax leaf lands on
    a torch tensor of the transposed shape."""
    jm = jmodels.get_model(name).build(classes)
    shapes = jax.eval_shape(lambda k: jinit(jm, k, (side, side, 3)), jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = params_from_jax(tmodels.get_model(name).build(classes), variables)
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(variables["params"])) == count
    assert sum(p.numel() for p in tm.parameters()) == count


def test_tvresnet50_params_from_jax_round_trip():
    """Random values in TVResNet-50's flax tree come out of the torch module
    unchanged, in torch's layouts; the tree is Conv_0, BatchNorm_0,
    Bottleneck_0..15 and Dense_0, and each block's shortcut is Conv_3."""
    jm = jmodels.get_model("TVResNet50").build(1000)
    shapes = jax.eval_shape(lambda k: jinit(jm, k, (64, 64, 3)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    params = variables["params"]
    assert set(params) == {"Conv_0", "BatchNorm_0", "Dense_0",
                           *(f"Bottleneck_{i}" for i in range(16))}
    tm = params_from_jax(tmodels.get_model("TVResNet50").build(1000), variables)
    sd = tm.state_dict()
    pairs = {
        "conv1.weight": np.transpose(params["Conv_0"]["kernel"], (3, 2, 0, 1)),
        "bn1.weight": params["BatchNorm_0"]["scale"],
        "bn1.running_var": variables["batch_stats"]["BatchNorm_0"]["var"],
        "fc.weight": params["Dense_0"]["kernel"].T,
        "fc.bias": params["Dense_0"]["bias"],
        "layer1.0.conv1.weight":
            np.transpose(params["Bottleneck_0"]["Conv_0"]["kernel"], (3, 2, 0, 1)),
        "layer1.0.downsample.0.weight":
            np.transpose(params["Bottleneck_0"]["Conv_3"]["kernel"], (3, 2, 0, 1)),
        "layer1.0.downsample.1.bias": params["Bottleneck_0"]["BatchNorm_3"]["bias"],
        "layer2.0.conv2.weight":
            np.transpose(params["Bottleneck_3"]["Conv_1"]["kernel"], (3, 2, 0, 1)),
        "layer4.2.bn3.running_mean":
            variables["batch_stats"]["Bottleneck_15"]["BatchNorm_2"]["mean"],
    }
    assert params["Bottleneck_0"]["Conv_3"]["kernel"].shape == (1, 1, 64, 256)
    for key, want in pairs.items():
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
    n_leaves = len(jax.tree.leaves(params)) + len(jax.tree.leaves(variables["batch_stats"]))
    assert len(sd) == n_leaves


def test_init_statistics_match_flax_initialisers():
    """INResNet: kaiming-normal convs and head (fan in); TVResNet: fan-out
    normal convs and torch's default head; both reproducible from a seed."""
    m = INResNet(layers=(1, 1, 1, 1), num_classes=10)
    m.init_parameters(torch.Generator().manual_seed(0))
    w = m.layer4[0].conv2.weight.detach()  # 512 -> 512, 3x3
    assert abs(float(w.std()) / (2.0 / (9 * 512)) ** 0.5 - 1) < 0.05
    fc = m.fc.weight.detach()
    assert abs(float(fc.std()) / (2.0 / 512) ** 0.5 - 1) < 0.05
    assert float(m.fc.bias.detach().abs().max()) <= 1 / 512 ** 0.5
    t = TVResNet(layers=(1, 1, 1, 1), bottleneck=True, num_classes=1000)
    t.init_parameters(torch.Generator().manual_seed(0))
    w = t.layer3[0].conv2.weight.detach()  # 256 -> 256, 3x3
    assert abs(float(w.std()) / (2.0 / (9 * 256)) ** 0.5 - 1) < 0.05
    assert float(t.fc.weight.detach().abs().max()) <= 1 / 2048 ** 0.5
    again = TVResNet(layers=(1, 1, 1, 1), bottleneck=True, num_classes=1000)
    again.init_parameters(torch.Generator().manual_seed(0))
    for a, b in zip(t.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_registry_has_the_imagenet_resnets():
    for name in ("INResNet18", "INResNet34", "INResNet50", "INResNet101", "INResNet152",
                 "ResNet50", "TVResNet18", "TVResNet50"):
        cfg = tmodels.get_model(name)
        assert cfg.transform_test.size == (224 if name.startswith("TV") else 32)
    assert tmodels.get_model("TVResNet50").transform_train.random_flip


# -- the compute dtype -----------------------------------------------------------


def _bf16_pair(name):
    if name == "PreResNet8":
        jm = jmodels.get_model(name).build(10)
        jm16 = jmodels.get_model(name).build(10, dtype=jnp.bfloat16)
        side = 32
        make = lambda **kw: tmodels.get_model(name).build(10, **kw)  # noqa: E731
    else:
        kw = SMALL["tv_bottleneck_1111"][0]
        jm = JTVResNet(num_classes=10, stem_s2d=False, **kw)
        jm16 = JTVResNet(num_classes=10, stem_s2d=False, dtype=jnp.bfloat16, **kw)
        side = 64
        make = lambda **dkw: TVResNet(num_classes=10, **kw, **dkw)  # noqa: E731
    variables = _stir_batchnorm(_as_numpy(jinit(jm, jax.random.PRNGKey(7),
                                                (side, side, 3))), seed=8)
    x = np.random.default_rng(9).normal(size=(4, side, side, 3)).astype(np.float32)
    return jm16, variables, make, x


@pytest.mark.parametrize("name", ["PreResNet8", "TVResNetSmall"])
def test_bf16_build_computes_in_bf16(name):
    """``build(..., dtype=torch.bfloat16)`` keeps float32 parameters, runs
    every conv and BatchNorm in bf16 and returns float32 logits; its
    logits stay within 2e-2 max|logit| of flax's bf16 forward on the same
    weights and of the port's own float32 forward, in eval and train mode."""
    jm16, variables, make, x = _bf16_pair(name)
    t16 = params_from_jax(make(dtype=torch.bfloat16), variables)
    t32 = params_from_jax(make(), variables)
    assert all(p.dtype == torch.float32 for p in t16.parameters())
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((type(m).__name__, o.dtype)))
             for m in t16.modules() if isinstance(m, (torch.nn.Conv2d, tmodels.BatchNorm2d))]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    for train in (False, True):
        jout = jm16.apply(variables, jnp.asarray(x), train=train,
                          **({"mutable": ["batch_stats"]} if train else {}))
        want = np.asarray((jout[0] if train else jout).astype(jnp.float32))
        with torch.no_grad():
            got = t16.train(train)(xt)
            ref32 = t32.train(train)(xt).numpy()
        assert got.dtype == torch.float32
        bound = 2e-2 * float(np.abs(ref32).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bound)
        np.testing.assert_allclose(got.numpy(), ref32, rtol=0, atol=bound)
    for h in hooks:
        h.remove()
    assert seen and all(dtype == torch.bfloat16 for _, dtype in seen), set(seen)


def test_bf16_gradients_reach_float32_parameters():
    """Autograd casts the bf16 gradients back to the float32 parameters, so
    the flat float32 buffers of the sampler take them unchanged."""
    m = tmodels.get_model("PreResNet8").build(10, dtype=torch.bfloat16)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    torch.nn.functional.cross_entropy(m.train()(x), torch.tensor([1, 2])).backward()
    grads = [p.grad for p in m.parameters()]
    assert all(g is not None and g.dtype == torch.float32 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
