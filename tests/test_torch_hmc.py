"""HMC of ursabench_tpu_torch against the JAX package's.

One transition on MLP200MNIST (no BatchNorm) and on PreResNet-8 (eval-mode
BatchNorm with non-trivial running statistics) from the same weights, with
the momentum and the accept uniform that JAX's key draws injected; the
gradient batch (40) is smaller than the split (96) and does not divide it.
The JAX side's proposal and log ratio are recomputed from its own
potential (``_build_fns``), since its transition returns only the chain.
Then the ensemble's layout, the statistical twins of
tests/test_mcmc_correctness.py and the float64 oracles of the
difference-form log ratio."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_samplers import _as_numpy, _splits, flat_permutation
from torch import nn

from ursabench_tpu import models as jmodels
from ursabench_tpu.inference import hmc as jhmc
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.inference import hmc
from ursabench_tpu_torch.nn.init import torch_linear_
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

HYP = {"step_size": 1e-2, "num_samples": 3, "L": 3, "tau": 1.0, "burn": 0, "mass": 0.5,
       "grad_batch": 40}


def _jax_transition(jh, theta, ll_cur, key):
    """JAX's transition of one chain (its chunk program), and the proposal
    and log ratio recomputed from its potential with the same draws."""
    nlp, chunk = jh._build_fns()
    thetas, us, accs = chunk(theta[None], ll_cur[None], key.reshape(1, 1, 2))
    k_mom, k_acc = jax.random.split(key)
    p0 = jax.random.normal(k_mom, theta.shape) * math.sqrt(jh.mass)
    u = jax.random.uniform(k_acc)
    grad_u = jax.jit(lambda t: jax.grad(lambda s: nlp(s[None])[0])(t) + jh.tau * t)
    eps, inv_mass = jh.step_size, 1.0 / jh.mass
    p = p0 - 0.5 * eps * grad_u(theta)
    th = theta
    for _ in range(jh.L):
        th = th + eps * inv_mass * p
        g = grad_u(th)
        p = p - eps * g
    p_new = p + 0.5 * eps * g
    ll_new = nlp(th[None])[0]
    log_ratio = ((ll_cur - ll_new) - 0.5 * jh.tau * jhmc._sq_diff_sum(th, theta)
                 - 0.5 * inv_mass * jhmc._sq_diff_sum(p_new, p0))
    return {"theta": thetas[0, 0], "ll": us[0, 0], "accept": bool(accs[0, 0]), "p0": p0,
            "u": u, "proposal": th, "ll_new": ll_new, "log_ratio": log_ratio}


def _f32_ulp(x) -> float:
    return float(np.spacing(np.float32(abs(float(x)))))


@pytest.mark.parametrize("name,dataset", [("MLP200MNIST", "MNIST"), ("PreResNet8", "CIFAR10")])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_transition_matches_jax(name, dataset, seed):
    """Positions within 1e-5. The CE sums (about 220 here) and the log
    ratio, a difference of two of them, within 4 float32 ulps of the CE sum
    (6.1e-5): summing the cross entropies in another order moves their
    last bits. Then the same transition with u = 1, which rejects every
    proposal that lowers the target."""
    js_, ts_, c = _splits(dataset)
    jh = jhmc.HMC(HYP, model=jmodels.get_model(name).build(c), train=js_["train"],
                  key=jax.random.PRNGKey(seed))
    th = hmc.HMC(HYP, model=tmodels.get_model(name).build(c), train=ts_["train"],
                 device="cpu")
    if jh._bstats:  # eval-mode BatchNorm with statistics other than the init's
        rng = np.random.default_rng(seed)
        jh._bstats = jax.tree.map(
            lambda x: jnp.asarray((np.abs(rng.normal(size=x.shape)) + 0.5).astype(np.float32)),
            jh._bstats)
    variables = _as_numpy({"params": jh._params0, "batch_stats": jh._bstats})
    params_from_jax(th.module, variables)
    perm = flat_permutation(th.module, variables).numpy()
    theta = jh._theta0[0]
    ll_cur = jh._build_fns()[0](theta[None])[0]
    want = _jax_transition(jh, theta, ll_cur, jax.random.PRNGKey(100 + seed))
    tol = 4 * _f32_ulp(ll_cur)

    def t(a):
        a = np.array(a)
        return torch.from_numpy(a[perm] if a.ndim else a)

    theta_t, ll_t = t(theta), t(ll_cur)
    assert float(th._ce_sum(theta_t, grad=False)) == pytest.approx(float(ll_cur), abs=tol)
    got_theta, got_ll, accept, log_ratio, (prop, _, _, ll_new) = th._transition(
        theta_t, ll_t, draws=(t(want["p0"]), t(want["u"])))
    np.testing.assert_allclose(prop.numpy(), np.asarray(want["proposal"])[perm], rtol=0,
                               atol=1e-5)
    assert float(ll_new) == pytest.approx(float(want["ll_new"]), abs=tol)
    assert abs(float(want["log_ratio"])) > 30 * tol  # a real decision, not a rounding one
    assert float(log_ratio) == pytest.approx(float(want["log_ratio"]), abs=tol)
    assert bool(accept) == want["accept"]
    np.testing.assert_allclose(got_theta.numpy(), np.asarray(want["theta"])[perm], rtol=0,
                               atol=1e-5)
    assert float(got_ll) == pytest.approx(float(want["ll"]), abs=tol)
    if float(log_ratio) < 0:
        kept, ll, accept, _, _ = th._transition(theta_t, ll_t,
                                                draws=(t(want["p0"]), torch.tensor(1.0)))
        assert not bool(accept) and torch.equal(kept, theta_t) and torch.equal(ll, ll_t)


@pytest.mark.parametrize("burn", [0, 2, -1])
@pytest.mark.parametrize("chains", [1, 2])
def test_sample_keeps_chain_burn_draw_major(burn, chains):
    """``chain[burn:]`` of the trajectory with its initial point, by
    Python's slice rules; members draw-major, chains within a draw; the
    init's BatchNorm buffers on every member."""
    _, ts_, c = _splits("CIFAR10", synthetic_n_train=48)
    th = hmc.HMC({**HYP, "burn": burn, "L": 1}, model=tmodels.get_model("PreResNet8").build(c),
                 train=ts_["train"], device="cpu", chains=chains, seed=3)
    trajectory, accepts = [th._theta0.clone()], []
    draw = th._draw

    def recording(theta, ll):
        out = draw(theta, ll)
        trajectory.append(out[0].clone())
        accepts.append(out[2])
        return out

    th._draw = recording
    ens = th.sample()
    kept = trajectory[burn:]
    assert ens.num_members == len(kept) * chains == {0: 4, 2: 2, -1: 1}[burn] * chains
    names = [n for n, _ in th.module.named_parameters()]
    for i in range(ens.num_members):
        member = ens.member(i)
        flat = torch.cat([member[n].reshape(-1) for n in names])
        assert torch.equal(flat, kept[i // chains][i % chains]), i
        assert torch.equal(member["bn.running_var"], torch.ones_like(member["bn.running_var"]))
    assert th.accept_rate == pytest.approx(float(torch.stack(accepts).float().mean()))
    assert chains == 1 or not torch.equal(th._theta0[0], th._theta0[1])  # own inits


class _Micro(nn.Module):
    """Dense(3) on the first 8 pixels, tanh, Dense(10)."""

    def __init__(self, hidden=3, inputs=8):
        super().__init__()
        self.inputs = inputs
        self.fc1, self.fc2 = nn.Linear(inputs, hidden), nn.Linear(hidden, 10)

    @torch.no_grad()
    def init_parameters(self, gen):
        for m in (self.fc1, self.fc2):
            torch_linear_(m.weight, m.bias, gen)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x.reshape(x.shape[0], -1)[:, :self.inputs])))


def _member_variance(ens):
    flat = torch.stack([torch.cat([v.reshape(-1) for k, v in ens.member(i).items()])
                        for i in range(ens.num_members)])
    return float(flat.var(dim=0, unbiased=False).mean())


def test_hmc_samples_gaussian():
    """Port twin of tests/test_mcmc_correctness.py's: on a prior-dominated
    posterior the draws' marginal variance is 1/tau."""
    _, ts_, c = _splits(batch_size=16, synthetic_n_train=16, synthetic_n_test=16)
    tau = 400.0
    th = hmc.HMC({"step_size": 0.004, "num_samples": 600, "L": 12, "tau": tau, "burn": 200,
                  "mass": 1.0}, model=_Micro(), train=ts_["train"], device="cpu")
    ens = th.sample()
    assert th.accept_rate > 0.6
    assert _member_variance(ens) == pytest.approx(1.0 / tau, rel=0.5)


def test_hmc_large_model_energy():
    """Port twin: above 1e6 parameters the difference-form log ratio keeps
    acceptance healthy and the marginal variance at 1/tau."""
    _, ts_, c = _splits(batch_size=16, synthetic_n_train=16, synthetic_n_test=16)
    tau = 400.0
    th = hmc.HMC({"step_size": 0.002, "num_samples": 120, "L": 16, "tau": tau, "burn": 40,
                  "mass": 1.0, "draw_chunk": 40}, model=_Micro(1280, 784),
                 train=ts_["train"], device="cpu")
    assert th._theta0.shape[1] > 1_000_000
    # start in the prior's typical set (see the JAX test's comment)
    th._theta0 = torch.randn(th._theta0.shape, generator=torch.Generator().manual_seed(42))
    th._theta0 /= math.sqrt(tau)
    ens = th.sample()
    assert 0.6 < th.accept_rate < 1.0
    assert _member_variance(ens) == pytest.approx(1.0 / tau, rel=0.35)


def _f64_sq_diff(a, b, chunk=1 << 22):
    return sum(float(np.sum(a[i:i + chunk].astype(np.float64) ** 2)
                     - np.sum(b[i:i + chunk].astype(np.float64) ** 2))
               for i in range(0, a.size, chunk))


def test_sq_diff_sum_f64_oracle():
    """Port twin: the difference form against a float64 oracle where the
    naive float32 form has lost the signal."""
    rng = np.random.default_rng(0)
    n = 4_000_000
    base = rng.standard_normal(n, dtype=np.float32) * 3.0
    a, b = base + rng.standard_normal(n, dtype=np.float32) * np.float32(1e-4), base
    exact = _f64_sq_diff(a, b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    stable = float(hmc._sq_diff_sum(ta, tb))
    naive = float(torch.sum(ta ** 2) - torch.sum(tb ** 2))
    assert abs(stable - exact) / abs(exact) < 1e-4
    assert abs(naive - exact) > 50 * abs(stable - exact)


def test_mh_log_ratio_f64_oracle_at_wrn_scale():
    """Port twin: the float32 log ratio as ``HMC._transition`` forms it, at
    WideResNet-28x10's 36,489,290 parameters with a prior-typical state
    and a leapfrog-sized move, within 3% of a float64 oracle; the
    absolute-energy form has lost the decision."""
    d, tau, inv_mass = 36_489_290, 1.0, 1.0
    rng = np.random.default_rng(7)
    theta = rng.standard_normal(d, dtype=np.float32)
    theta_new = theta + rng.standard_normal(d, dtype=np.float32) * np.float32(2e-4)
    p0 = rng.standard_normal(d, dtype=np.float32)
    p_new = p0 + rng.standard_normal(d, dtype=np.float32) * np.float32(2e-4)
    ll_cur, ll_new = np.float32(181.25), np.float32(180.75)
    exact = (float(ll_cur) - float(ll_new) - 0.5 * tau * _f64_sq_diff(theta_new, theta)
             - 0.5 * inv_mass * _f64_sq_diff(p_new, p0))
    t = [torch.from_numpy(x) for x in (theta, theta_new, p0, p_new)]
    stable = float(torch.tensor(ll_cur) - torch.tensor(ll_new)
                   - 0.5 * tau * hmc._sq_diff_sum(t[1], t[0])
                   - 0.5 * inv_mass * hmc._sq_diff_sum(t[3], t[2]))
    naive = float((0.5 * tau * torch.sum(t[0] ** 2) + 0.5 * inv_mass * torch.sum(t[2] ** 2))
                  - (0.5 * tau * torch.sum(t[1] ** 2) + 0.5 * inv_mass * torch.sum(t[3] ** 2))
                  + (torch.tensor(ll_cur) - torch.tensor(ll_new)))
    assert abs(exact) > 0.1
    assert abs(stable - exact) / abs(exact) < 0.03
    assert abs(naive - exact) > 10 * abs(stable - exact)


def test_tf32_is_off_inside_the_potential_and_restored_after():
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with hmc.float32_matmuls():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_refusals():
    _, ts_, c = _splits()
    model = tmodels.get_model("MLP200MNIST").build(c)
    with pytest.raises(NotImplementedError, match="open item 15"):
        hmc.HMC(HYP, model=model, train=ts_["train"], device="cpu", mesh=object())
    vmapped = hmc.HMC(HYP, model=model, train=ts_["train"], device="cpu", chains=2,
                      chain_strategy="vmap")
    assert vmapped._resolved_chain_strategy == "vmap"
    with pytest.raises(ValueError, match="chain_strategy"):
        hmc.HMC(HYP, model=model, train=ts_["train"], device="cpu", chains=2,
                chain_strategy="lockstep")
    with pytest.raises(ValueError, match="L >= 1"):
        hmc.HMC({**HYP, "L": 0}, model=model, train=ts_["train"], device="cpu")
    th = hmc.HMC(None, model=model, train=ts_["train"], device="cpu")
    assert th.hyperparameters == hmc.HMC._DEFAULT_HYP and th.burn == -1
