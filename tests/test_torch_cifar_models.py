"""LeNet5MNIST and the option-A CIFAR ResNets of ursabench_tpu_torch against
the flax models, loaded with the same weights through
ursabench_tpu_torch.transfer: eval and train-mode logits in float32 and bf16,
the BatchNorm running statistics after one train-mode forward, parameter
counts, the initialisers' scales, and one noise-off SGHMC epoch on LeNet5
with the JAX package's permutation injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu.inference import sgmcmc as jsgmcmc
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.inference import engine, sgmcmc
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

SHAPES = {"LeNet5MNIST": (28, 28, 1), "ResNet20": (32, 32, 3), "ResNet32": (32, 32, 3)}


def _as_numpy(tree):
    return jax.tree.map(np.array, tree)


def _stir(variables, seed):
    """BatchNorm scales, biases and running statistics away from 1/0, so
    that eval mode is not an identity."""
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

    walk(variables["params"], variables.get("batch_stats", {}))
    return variables


@pytest.fixture(scope="module", params=sorted(SHAPES))
def pair(request):
    name = request.param
    jm = jmodels.get_model(name).build(10)
    variables = _stir(_as_numpy(jinit(jm, jax.random.PRNGKey(0), SHAPES[name])), 1)
    x = np.random.default_rng(2).normal(size=(4,) + SHAPES[name]).astype(np.float32)
    return {"name": name, "jm": jm, "variables": variables, "x": x,
            "tm": params_from_jax(tmodels.get_model(name).build(10), variables),
            "xt": torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()}


def _buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items() if "running" in k}


def test_forward_and_batch_stats_match_flax(pair):
    jm, variables, tm = pair["jm"], pair["variables"], pair["tm"]
    x = jnp.asarray(pair["x"])
    with torch.no_grad():
        eval_t = tm.eval()(pair["xt"]).numpy()
    np.testing.assert_allclose(eval_t, np.asarray(jm.apply(variables, x, train=False)),
                               rtol=1e-5, atol=1e-5)
    train_j, mutated = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        train_t = tm.train()(pair["xt"]).numpy()
    np.testing.assert_allclose(train_t, np.asarray(train_j), rtol=1e-5, atol=1e-5)
    got = _buffers(tm)
    want = _buffers(params_from_jax(
        tmodels.get_model(pair["name"]).build(10),
        {"params": variables["params"],
         "batch_stats": _as_numpy(mutated.get("batch_stats", {}))}))
    assert got.keys() == want.keys()
    assert len(got) == (0 if pair["name"] == "LeNet5MNIST" else 2 * (1 + 2 * 3 * (
        3 if pair["name"] == "ResNet20" else 5)))
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_bf16_forward_matches_flax(pair):
    """bf16 convs, BatchNorm and (for LeNet) dense layers, float32 pooling and
    head for the ResNets: within 2e-2 of max|logit| of flax's bf16 forward
    (the bf16 tolerance of tests/test_torch_wideresnet.py)."""
    name, variables = pair["name"], pair["variables"]
    j16 = jmodels.get_model(name).build(10, dtype=jnp.bfloat16)
    t16 = params_from_jax(tmodels.get_model(name).build(10, dtype=torch.bfloat16), variables)
    for train in (False, True):
        out = j16.apply(variables, jnp.asarray(pair["x"]), train=train,
                        **({"mutable": ["batch_stats"]} if train else {}))
        want = np.asarray((out[0] if train else out).astype(jnp.float32))
        with torch.no_grad():
            got = t16.train(train)(pair["xt"]).float()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("name,shape,count", [
    ("LeNet5MNIST", (28, 28, 1), 61706),
    ("ResNet20", (32, 32, 3), 269722),
    ("ResNet32", (32, 32, 3), None),
    ("ResNet56", (32, 32, 3), 853018),
])
def test_param_counts(name, shape, count):
    """tests/test_models.py's counts, and the flax model's for ResNet32."""
    jm = jmodels.get_model(name).build(10)
    shapes = jax.eval_shape(lambda k: jinit(jm, k, shape), jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    assert count is None or want == count
    assert sum(p.numel() for p in tmodels.get_model(name).build(10).parameters()) == want


def test_option_a_shortcut_and_initialisers():
    """The stage-changing block subsamples and pads planes // 4 zero channels
    a side; convs and the head are N(0, 2/fan_in), LeNet U(+-1/sqrt(fan_in))."""
    m = tmodels.get_model("ResNet20").build(10)
    m.init_parameters(torch.Generator().manual_seed(0))
    blk = m.blocks[3]  # the first block of the 32-channel stage
    assert blk.pad == 8 and m.blocks[0].pad is None and len(m.blocks) == 9
    x = torch.randn(2, 16, 8, 8)
    with torch.no_grad():
        sc = torch.nn.functional.pad(x[:, :, ::2, ::2], (0, 0, 0, 0, 8, 8))
    assert sc.shape == (2, 32, 4, 4) and float(sc[:, :8].abs().max()) == 0.0
    w = m.blocks[8].conv2.weight.detach()
    assert float(w.std()) == pytest.approx((2 / (64 * 9)) ** 0.5, rel=0.05)
    assert float(m.fc.weight.detach().std()) == pytest.approx((2 / 64) ** 0.5, rel=0.15)
    assert float(m.fc.bias.abs().max()) <= 1 / 8
    le = tmodels.get_model("LeNet5MNIST").build(10)
    le.init_parameters(torch.Generator().manual_seed(1))
    assert float(le.conv2.weight.abs().max()) <= (1 / 150) ** 0.5
    assert float(le.fc1.weight.abs().max()) <= (1 / 400) ** 0.5
    assert float(le.fc1.weight.abs().max()) > 0.9 * (1 / 400) ** 0.5


def test_lenet_sghmc_epoch_matches_jax(monkeypatch):
    """One noise-off SGHMC epoch of LeNet5MNIST (96 images, batch 32) from
    the same weights over JAX's permutation: within 1e-5."""
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")
    kw = dict(batch_size=32, use_validation=False, synthetic_n_train=96, synthetic_n_test=32)
    js_, c = jdata.loaders("MNIST", None, **kw)
    ts_, _ = tdata.loaders("MNIST", None, **kw)
    hyp = {"lr": 0.05, "prior_std": 1.0, "num_samples": 1, "alpha": 0.1, "burn_in_epochs": 0}
    js = jsgmcmc.SGHMC(hyp, model=jmodels.get_model("LeNet5MNIST").build(c),
                       train=js_["train"], key=jax.random.PRNGKey(5))
    start = _as_numpy({"params": js._state.params, "batch_stats": js._state.batch_stats})
    _, k_perm, _, _, _ = jax.random.split(js._state.key, 5)
    perm = np.array(jax.random.permutation(k_perm, 96))
    js._state, loss_j = js._epoch_fn(js._state, jnp.float32(0.0), jnp.float32(0.0),
                                     js._hyp_scalars)
    ts = sgmcmc.SGHMC(hyp, model=tmodels.get_model("LeNet5MNIST").build(c),
                      train=ts_["train"], device="cpu")
    params_from_jax(ts.module, start)
    loss_t = engine.train_steps(
        ts._state, ts._images, ts._labels, torch.from_numpy(perm).view(1, -1, 32),
        spec=ts.train.spec, epoch=0, noise_on=torch.tensor(0.0), hyp=ts._hyp,
        lr_fn=ts._LR_FN, update_fn=ts._UPDATE_FN, seeds=[1] * 3)
    assert float(loss_t) == pytest.approx(float(loss_j), abs=1e-5)
    want = params_from_jax(tmodels.get_model("LeNet5MNIST").build(c),
                           _as_numpy({"params": js._state.params})).state_dict()
    for k, v in ts.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)
