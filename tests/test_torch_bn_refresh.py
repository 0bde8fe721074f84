"""``engine.bn_refresh`` of ursabench_tpu_torch against the JAX package's
``make_bn_refresh_fn``: the exact batch-size-weighted mean of per-batch
(biased) statistics, with per-layer momenta that differ (flax's 0.9 and
0.1, as in tests/test_bn_refresh.py), a padded last batch, and the
WideResNet head's momentum; plus ``eval_loss`` on a padded split."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu.data import DataSplit as JSplit
from ursabench_tpu.data.transforms import ImageSpec as JSpec
from ursabench_tpu.inference.engine import init_variables, make_bn_refresh_fn
from ursabench_tpu import models as jmodels
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.data.arrays import DataSplit as TSplit
from ursabench_tpu_torch.data.transforms import ImageSpec as TSpec
from ursabench_tpu_torch.inference import engine
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)


class MixedMomentumNet(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        x = nn.Conv(4, (3, 3), padding=1)(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        x = nn.relu(x)
        x = nn.Conv(4, (3, 3), padding=1)(x)
        x = nn.BatchNorm(use_running_average=not train, momentum=0.1)(x)
        x = jnp.mean(x, axis=(1, 2))
        return nn.Dense(3)(x)


class TorchMixedMomentumNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tmodels.Conv2d(1, 4, 3, 1, 1, bias=True)
        self.bn1 = tmodels.BatchNorm2d(4, momentum=0.1)
        self.conv2 = tmodels.Conv2d(4, 4, 3, 1, 1, bias=True)
        self.bn2 = tmodels.BatchNorm2d(4, momentum=0.9)
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        x = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return self.fc(x.mean(dim=(2, 3)))


def _data(n, bsz, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (n, 8, 8, 1), dtype=np.uint8)
    labels = rng.integers(0, 3, n)
    return (JSplit(images, labels, bsz, JSpec(8, 1, (0.5,), (0.5,))),
            TSplit(images, labels, bsz, TSpec(8, 1, (0.5,), (0.5,))))


@pytest.mark.parametrize("n", [64, 70])  # 70: the last batch filled up with the first 10
def test_refresh_with_mixed_momenta_matches_jax(n):
    jsplit, tsplit = _data(n, 16)
    module = MixedMomentumNet()
    variables = jax.tree.map(np.array, init_variables(module, jax.random.PRNGKey(0),
                                                      (8, 8, 1)))
    want = make_bn_refresh_fn(module, jsplit)(variables["params"], variables["batch_stats"])
    net = params_from_jax(TorchMixedMomentumNet(), variables)
    net.bn1.running_mean.fill_(3.0)  # the refresh starts from its own reset
    net.eval()
    engine.bn_refresh(net, tsplit)
    assert not net.training and (net.bn1.momentum, net.bn2.momentum) == (0.1, 0.9)
    for layer, name in ((net.bn1, "BatchNorm_0"), (net.bn2, "BatchNorm_1")):
        for buf, key in ((layer.running_mean, "mean"), (layer.running_var, "var")):
            np.testing.assert_allclose(buf.numpy(), np.asarray(want[name][key]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name}/{key}")


def test_refresh_is_the_weighted_mean_of_biased_batch_statistics():
    """A plain recomputation from forward hooks over the same batches."""
    _, tsplit = _data(70, 16, seed=1)
    net = TorchMixedMomentumNet()
    torch.manual_seed(0)
    engine.bn_refresh(net, tsplit)
    refreshed = {m: (m.running_mean.clone(), m.running_var.clone()) for m in (net.bn1, net.bn2)}
    seen = {net.bn1: [], net.bn2: []}
    hooks = [m.register_forward_hook(lambda m, i, o: seen[m].append(i[0].double()))
             for m in seen]
    idx = np.concatenate([np.arange(70), np.arange(10)]).reshape(5, 16)
    from ursabench_tpu_torch.data.transforms import normalize

    with torch.no_grad():
        net.train()
        for b in idx:
            net(normalize(torch.from_numpy(tsplit.images[b]), tsplit.spec).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    for m, xs in seen.items():
        mean = torch.stack([x.mean(dim=(0, 2, 3)) for x in xs]).mean(0)
        var = torch.stack([x.var(dim=(0, 2, 3), unbiased=False) for x in xs]).mean(0)
        np.testing.assert_allclose(refreshed[m][0].numpy(), mean.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(refreshed[m][1].numpy(), var.numpy(), rtol=1e-5, atol=1e-6)


def test_wrn_refresh_matches_jax():
    """A small WideResNet: the blocks at torch momentum 0.1, the head at
    0.9."""
    jm = jmodels.get_model("WideResNet28x10").build(10, depth=10, widen_factor=1)
    variables = jax.tree.map(np.array, init_variables(jm, jax.random.PRNGKey(1), (32, 32, 3)))
    rng = np.random.default_rng(2)
    images = rng.integers(0, 255, (40, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 40)
    mean, std = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)
    jsplit = JSplit(images, labels, 16, JSpec(32, 3, mean, std))
    tsplit = TSplit(images, labels, 16, TSpec(32, 3, mean, std))
    want = make_bn_refresh_fn(jm, jsplit)(variables["params"], variables["batch_stats"])
    got = params_from_jax(tmodels.get_model("WideResNet28x10").build(
        10, depth=10, widen_factor=1), variables)
    engine.bn_refresh(got, tsplit)
    ref = params_from_jax(tmodels.get_model("WideResNet28x10").build(
        10, depth=10, widen_factor=1),
        {"params": variables["params"], "batch_stats": jax.tree.map(np.array, want)})
    for k, v in ref.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(got.state_dict()[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_eval_loss_masks_the_padded_rows():
    _, tsplit = _data(70, 16, seed=3)
    net = TorchMixedMomentumNet().eval()
    got = float(engine.eval_loss(net, tsplit))
    from ursabench_tpu_torch.data.transforms import normalize

    with torch.no_grad():
        x = normalize(torch.from_numpy(tsplit.images), tsplit.spec).permute(0, 3, 1, 2)
        want = float(torch.nn.functional.cross_entropy(net(x), torch.from_numpy(tsplit.labels)))
    assert got == pytest.approx(want, rel=1e-6)
