"""PreResNet in ursabench_tpu_torch against the flax model, loaded with the
same weights through ursabench_tpu_torch.transfer: eval logits, train-mode
logits and the BatchNorm running statistics after one train-mode forward
(flax keeps the biased running variance, torch's BatchNorm2d would not)."""

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


def _as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(name, seed=0, num_classes=10):
    jm = jmodels.get_model(name).build(num_classes)
    variables = _as_numpy(jinit(jm, jax.random.PRNGKey(seed), (32, 32, 3)))
    tm = params_from_jax(tmodels.get_model(name).build(num_classes), variables)
    return jm, variables, tm


def _buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items() if "running" in k}


def test_preresnet20_matches_flax():
    name = "PreResNet20"
    jm, variables, tm = _pair(name)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(variables["params"]))
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

    # the flax running stats after the update, loaded into a second module,
    # must equal the torch module's own update
    want = params_from_jax(tmodels.get_model(name).build(10),
                           {"params": variables["params"],
                            "batch_stats": _as_numpy(mutated["batch_stats"])})
    got, expect = _buffers(tm), _buffers(want)
    assert got.keys() == expect.keys() and len(got) > 0
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), expect[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name,count", [("PreResNet8", 77850),
                                        ("PreResNet20", 272282),
                                        ("PreResNet56", 590426)])
def test_param_counts_and_layout(name, count):
    """Equal parameter counts, and every flax leaf (basic and bottleneck
    blocks) lands on a torch tensor of the transposed shape."""
    jm = jmodels.get_model(name).build(10)
    shapes = jax.eval_shape(lambda k: jinit(jm, k, (32, 32, 3)), jax.random.PRNGKey(0))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = params_from_jax(tmodels.get_model(name).build(10), variables)
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(variables["params"])) == count
    assert sum(p.numel() for p in tm.parameters()) == count


def test_init_statistics_match_flax_initialisers():
    """Fan-out normal convs and torch-default uniform Dense, as nn/init.py."""
    m = tmodels.get_model("PreResNet20").build(10)
    m.init_parameters(torch.Generator().manual_seed(0))
    w = m.blocks[8].conv2.weight.detach()  # 64 -> 64, 3x3
    assert abs(float(w.std()) - (2.0 / (9 * 64)) ** 0.5) < 0.05 * (2.0 / (9 * 64)) ** 0.5
    bound = 1.0 / 64 ** 0.5
    assert float(m.fc.weight.detach().abs().max()) <= bound
    assert float(m.fc.bias.detach().abs().max()) <= bound
    assert float(m.bn.weight.detach().min()) == 1.0 and float(m.bn.running_var.min()) == 1.0
    again = tmodels.get_model("PreResNet20").build(10)
    again.init_parameters(torch.Generator().manual_seed(0))
    for a, b in zip(m.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)


def test_transfer_rejects_mismatch():
    _, variables, _ = _pair("PreResNet8")
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tmodels.get_model("PreResNet8").build(100), variables)
    params = dict(variables["params"])
    del params["PreBasicBlock_2"]
    with pytest.raises(KeyError, match="PreBasicBlock_2"):
        params_from_jax(tmodels.get_model("PreResNet8").build(10),
                        {"params": params, "batch_stats": variables["batch_stats"]})
    params = dict(variables["params"], Extra_0={})
    with pytest.raises(KeyError, match="Extra_0"):
        params_from_jax(tmodels.get_model("PreResNet8").build(10),
                        {"params": params, "batch_stats": variables["batch_stats"]})
    with pytest.raises(KeyError):
        tmodels.get_model("nope")
