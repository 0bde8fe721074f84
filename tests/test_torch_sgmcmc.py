"""The SGHMC step of ursabench_tpu_torch (kernel K1's module) against the
JAX package: ops.sgmcmc.sghmc_update on flat buffers and the plain version
of K1 against ursabench_tpu.ops.sgmcmc.sghmc_update on a pytree, with the
noise off and, for one leaf, with the JAX package's own normals; and the
Pallas kernel (run in interpret mode, as tests/test_pallas.py runs it)
against the plain version. The CUDA kernel itself runs only on the card
(chip_smoke.py compares it there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks.pallas_sgmcmc import sghmc_update_flat as pallas_sghmc
from ursabench_tpu.ops import sgmcmc as jops
from ursabench_tpu_torch.inference.engine import flatten_parameters
from ursabench_tpu_torch.kernels import sghmc as k1
from ursabench_tpu_torch.ops import sgmcmc as tops

torch.set_num_threads(1)

HYP = dict(lr=0.1, wd_over_n=0.02, n_train=100.0)


def _tree(rng):
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _ravel(tree):
    return np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(tree)])


def _flat(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_noise_off_matches_jax_tree_update(first, momentum):
    rng = np.random.default_rng(0)
    p, v, g = _tree(rng), _tree(rng), _tree(rng)
    pj, vj = jops.sghmc_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, v),
        jax.tree.map(jnp.asarray, g), lr=jnp.float32(HYP["lr"]),
        momentum=jnp.float32(momentum), wd_over_n=jnp.float32(HYP["wd_over_n"]),
        n_train=jnp.float32(HYP["n_train"]), noise_on=jnp.float32(0.0),
        is_first_step=jnp.asarray(first), key=jax.random.PRNGKey(0))
    want_p, want_v = _ravel(pj), _ravel(vj)

    tp, tv, tg = _flat(_ravel(p), _ravel(v), _ravel(g))
    tops.sghmc_update(tp, tv, tg, momentum=momentum, noise_on=0.0,
                      is_first_step=first, seed=1, **HYP)
    np.testing.assert_allclose(tp.numpy(), want_p, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), want_v, rtol=1e-6, atol=1e-6)

    rp, rv, rg = _flat(_ravel(p), _ravel(v), _ravel(g))
    scalars = tops.sghmc_scalars(momentum=momentum, noise_on=0.0,
                                 is_first_step=first, device="cpu", **HYP)
    k1.sghmc_update_flat_reference(rp, rv, rg, scalars, torch.randn(rp.shape))
    np.testing.assert_allclose(rp.numpy(), want_p, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rv.numpy(), want_v, rtol=1e-6, atol=1e-6)


def test_noise_on_matches_jax_given_its_normals():
    rng = np.random.default_rng(1)
    n, m = 4099, 0.9
    p, v, g = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(11)
    pj, vj = jops.sghmc_update(
        {"w": jnp.asarray(p)}, {"w": jnp.asarray(v)}, {"w": jnp.asarray(g)},
        lr=jnp.float32(HYP["lr"]), momentum=jnp.float32(m),
        wd_over_n=jnp.float32(HYP["wd_over_n"]), n_train=jnp.float32(HYP["n_train"]),
        noise_on=jnp.float32(1.0), is_first_step=jnp.asarray(False), key=key)
    # ops/sgmcmc.py:52 draws the whole tree's normals in one call
    eps = np.array(jax.random.normal(key, (n,), jnp.float32))
    tp, tv, tg = _flat(p, v, g)
    tops.sghmc_update(tp, tv, tg, momentum=m, noise_on=1.0, is_first_step=False,
                      seed=0, noise=torch.from_numpy(eps), **HYP)
    np.testing.assert_allclose(tp.numpy(), np.asarray(pj["w"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(vj["w"]), rtol=1e-6, atol=1e-6)


def test_cpu_noise_statistics_and_seeding():
    n, m, lr, ntr = 65536, 0.9, 0.1, 100.0
    outs = []
    for seed in (7, 7, 8):
        p, v, g = (torch.zeros(n) for _ in range(3))
        tops.sghmc_update(p, v, g, lr=lr, momentum=m, wd_over_n=0.0, n_train=ntr,
                          noise_on=1.0, is_first_step=False, seed=seed)
        outs.append(p)
    expected = np.sqrt(2 * (1 - m) * lr) / ntr
    assert float(outs[0].std()) == pytest.approx(expected, rel=0.05)
    assert abs(float(outs[0].mean())) < 0.05 * expected
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("n", [1000, 8193])
@pytest.mark.parametrize("first", [0.0, 1.0])
def test_pallas_kernel_matches_plain_version(n, first):
    rng = np.random.default_rng(2)
    p, v, g = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    lr, m, wd_n, ntr = 0.1, 0.9, 0.02, 100.0
    with pltpu.force_tpu_interpret_mode():
        pj, vj = pallas_sghmc(
            jnp.asarray(p), jnp.asarray(v), jnp.asarray(g), lr=lr, momentum=m,
            wd_over_n=wd_n, n_train=ntr, noise_on=0.0, is_first_step=first, seed=0)
    tp, tv, tg = _flat(p, v, g)
    scalars = tops.sghmc_scalars(lr=lr, momentum=m, wd_over_n=wd_n, n_train=ntr,
                                 noise_on=0.0, is_first_step=bool(first), device="cpu")
    k1.sghmc_update_flat_reference(tp, tv, tg, scalars, torch.zeros(n))
    np.testing.assert_allclose(tp.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(vj), rtol=1e-6, atol=1e-6)


def test_scalars_layout():
    s = tops.sghmc_scalars(lr=0.05, momentum=0.9, wd_over_n=1e-3, n_train=50.0,
                           noise_on=1.0, is_first_step=True, device="cpu")
    want = [0.05, 0.9, 1e-3, np.sqrt(2 * 0.1 * 0.05) / 50.0, 1.0]
    np.testing.assert_allclose(s.numpy(), want, rtol=1e-6)
    assert s.dtype == torch.float32 and s.shape == (5,)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the CUDA kernel or raises: it never falls back
    to the plain version, and counts only launches."""
    before = k1.sghmc_update_flat.launches
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        k1.sghmc_update_flat(z, z.clone(), z.clone(), torch.zeros(5), seed=0)
    assert k1.sghmc_update_flat.launches == before


def test_kernel_source_and_build_flags():
    src = k1.SOURCE.read_text()
    assert "benchmarks/pallas_sgmcmc.py::sghmc_update_flat" in src
    assert 'extern "C" int sghmc_update_f32' in src
    assert "arch=compute_90a,code=sm_90a" in k1.NVCC_FLAGS
    assert k1.BUILD_DIR.name == "_build"


def test_gradients_land_in_the_flat_buffer():
    """Autograd adds each parameter's gradient into its view of the flat
    gradient buffer in place; values equal those of an ordinary module."""
    from ursabench_tpu_torch import models

    torch.manual_seed(0)
    flat = models.get_model("PreResNet8").build(10)
    plain = models.get_model("PreResNet8").build(10)
    plain.load_state_dict(flat.state_dict())
    params, grads = flatten_parameters(flat)
    x = torch.randn(4, 3, 32, 32)
    y = torch.tensor([0, 1, 2, 3])
    for _ in range(2):  # a second backward after zero_() reuses the views
        grads.zero_()
        torch.nn.functional.cross_entropy(flat(x), y).backward()
    plain.zero_grad()
    torch.nn.functional.cross_entropy(plain(x), y).backward()
    lo, hi = grads.data_ptr(), grads.data_ptr() + 4 * grads.numel()
    plo, phi = params.data_ptr(), params.data_ptr() + 4 * params.numel()
    for p, q in zip(flat.parameters(), plain.parameters()):
        assert lo <= p.grad.data_ptr() < hi
        assert plo <= p.data_ptr() < phi
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-6)
    assert int((grads != 0).sum()) > 0.9 * grads.numel()


def test_sgd_momentum_update_matches_jax():
    rng = np.random.default_rng(3)
    p, v, g = _tree(rng), _tree(rng), _tree(rng)
    for first in (True, False):
        pj, vj = jops.sgd_momentum_update(
            jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, v),
            jax.tree.map(jnp.asarray, g), lr=jnp.float32(0.1),
            momentum=jnp.float32(0.9), weight_decay=jnp.float32(5e-4),
            is_first_step=jnp.asarray(first))
        tp, tv, tg = _flat(_ravel(p), _ravel(v), _ravel(g))
        tops.sgd_momentum_update(tp, tv, tg, lr=0.1, momentum=0.9,
                                 weight_decay=5e-4, is_first_step=first)
        np.testing.assert_allclose(tp.numpy(), _ravel(pj), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tv.numpy(), _ravel(vj), rtol=1e-6, atol=1e-7)
