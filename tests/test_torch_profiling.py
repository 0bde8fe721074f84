"""The latency-profiling path of ursabench_tpu_torch against the JAX
package: int8 weight quantization of state dicts, the fp32/bf16/int8
ensemble engines on PreResNet-8, MLP200MNIST and a small WideResNet
(biased convolutions) ensembles transferred from flax, the 30/10/10 timing
protocol, the sweep cache, ``trace_dir``'s profiler trace, the LaTeX table,
the device peak table and Prediction in latency mode. The device engine (CUDA graphs) and
every time on the card are checked by ``chip_smoke.py``."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu import models as jmodels
from ursabench_tpu import tasks as jtasks
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu.inference.ensemble import Ensemble as JEnsemble
from ursabench_tpu.models.wideresnet import WideResNet as JWideResNet
from ursabench_tpu.profiling.latency import build_engine as j_build_engine
from ursabench_tpu.profiling.quantize import quantize_tree
from ursabench_tpu.util import tree_stack
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch import tasks as ttasks
from ursabench_tpu_torch.inference.ensemble import Ensemble as TEnsemble
from ursabench_tpu_torch.models.common import BatchNorm2d
from ursabench_tpu_torch.profiling import hw
from ursabench_tpu_torch.profiling import latency as L
from ursabench_tpu_torch.profiling import quantize as Q
from ursabench_tpu_torch.profiling.tables import make_latex_table
from ursabench_tpu_torch.tasks.base import accumulate_split
from ursabench_tpu_torch.transfer import _flax_children, params_from_jax
from ursabench_tpu_torch.util import stack_state_dicts

torch.set_num_threads(1)

NAME, MEMBERS, BATCH = "PreResNet8", 2, 4


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


@pytest.fixture(scope="module")
def pair():
    """A 2-member PreResNet-8 ensemble in both packages, the same weights;
    the head is scaled up so that the members' predictions spread out
    (a fresh network predicts near-uniform probabilities)."""
    jm = jmodels.get_model(NAME).build(10)
    variables = []
    for k in range(MEMBERS):
        v = jax.tree.map(np.array, jinit(jm, jax.random.PRNGKey(k), (32, 32, 3)))
        v["params"]["Dense_0"]["kernel"] = v["params"]["Dense_0"]["kernel"] * 20.0
        variables.append(v)
    states = [{k: t.clone() for k, t in params_from_jax(
        tmodels.get_model(NAME).build(10), v).state_dict().items()} for v in variables]
    x = np.random.default_rng(0).normal(size=(BATCH, 32, 32, 3)).astype(np.float32)
    return {
        "jm": jm, "variables": variables,
        "params": tree_stack([v["params"] for v in variables]),
        "bstats": tree_stack([v["batch_stats"] for v in variables]),
        "state": stack_state_dicts(states), "x": x,
        "xt": torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
    }


def _flax_paths(module, prefix=()):
    """torch state key -> path of the flax leaf it was loaded from, for conv
    and dense weights and biases (the walk of ``transfer.params_from_jax``)."""
    names = {id(m): n for n, m in module.named_modules()}
    out = {}

    def walk(m, path):
        for flax_name, child in _flax_children(m):
            key = names[id(child)]
            if isinstance(child, torch.nn.Conv2d):
                out[f"{key}.weight"] = path + (flax_name, "kernel")
            elif isinstance(child, torch.nn.Linear):
                out[f"{key}.weight"] = path + (flax_name, "kernel")
                out[f"{key}.bias"] = path + (flax_name, "bias")
            elif not isinstance(child, BatchNorm2d):
                walk(child, path + (flax_name,))

    walk(module, prefix)
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _to_torch_layout(a):
    """(S, H, W, I, O) -> (S, O, I, H, W); (S, in, out) -> (S, out, in)."""
    return np.transpose(a, (0, 4, 3, 1, 2)) if a.ndim == 5 else np.transpose(a, (0, 2, 1))


def test_quantize_state_matches_jax_quantize_tree(pair):
    """Per member and per output channel, wherever each layout keeps it:
    after the HWIO -> OIHW and (in, out) -> (out, in) transposes, the int8
    values and the scales are equal."""
    jq = quantize_tree(pair["params"], member_axis=True)
    tq = Q.quantize_state(pair["state"], member_axis=True)
    paths = _flax_paths(tmodels.get_model(NAME).build(10))
    kernels = [k for k, p in paths.items() if p[-1] == "kernel"]
    assert len(kernels) == 10  # 9 convs and the head
    for key, path in paths.items():
        node = _leaf(jq, path)
        if path[-1] == "bias":
            assert "raw" in node and "raw" in tq[key]
            continue
        q8, scale = tq[key]["q8"], tq[key]["scale"]
        assert q8.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q8.numpy(), _to_torch_layout(np.asarray(node["q8"])))
        np.testing.assert_array_equal(scale.numpy(),
                                      _to_torch_layout(np.asarray(node["scale"])))
    for key in tq:
        if "bn" in key or key.endswith(("running_mean", "running_var")):
            assert "raw" in tq[key], key


def test_quantize_roundtrip_exact_on_grid_and_scales_per_member():
    scale = torch.tensor([0.5, 0.25])
    grid = torch.arange(-127, 127, dtype=torch.float32)
    w = (scale[:, None] * grid[None, :])[None]  # (1, 2 out, 254 in): on the grid
    enc = Q.quantize_state({"w": w}, member_axis=True)
    torch.testing.assert_close(Q.dequantize_state(enc, torch.float32)["w"], w,
                               rtol=0, atol=0)
    assert enc["w"]["scale"].shape == (1, 2, 1)
    conv = torch.stack([torch.ones(8, 4, 3, 3), 10.0 * torch.ones(8, 4, 3, 3)])
    enc = Q.quantize_state({"conv.weight": conv, "fc.bias": torch.ones(2, 8)},
                           member_axis=True)
    s = enc["conv.weight"]["scale"]
    assert s.shape == (2, 8, 1, 1, 1)
    torch.testing.assert_close(s[1], 10 * s[0])
    assert "raw" in enc["fc.bias"]
    # the scale is rounded to the compute dtype before the product
    dec = Q.dequantize_state(enc, torch.bfloat16)["conv.weight"]
    want = enc["conv.weight"]["q8"].to(torch.bfloat16) * s.to(torch.bfloat16)
    assert dec.dtype == torch.bfloat16 and torch.equal(dec, want)


def test_quantization_error_small_on_model_state(pair):
    assert Q.quantization_error(pair["state"], member_axis=True) < 0.015


@pytest.fixture(scope="module")
def engines(pair):
    """Posterior-mean probabilities of the JAX engines and of the port's,
    both member strategies, at every precision, on the same batch."""
    tm = tmodels.get_model(NAME).build(10)
    out = {}
    for prec in L.PRECISIONS:
        je, _ = j_build_engine(pair["jm"], pair["params"], pair["bstats"], BATCH,
                               (32, 32, 3), prec, "vmap")
        out[("jax", prec)] = np.asarray(je(jnp.asarray(pair["x"])))
        for strategy in L.MEMBER_STRATEGIES:
            te, x = L.build_engine(tm, pair["state"], BATCH, (3, 32, 32), prec, strategy)
            assert x.shape == (BATCH, 3, 32, 32)
            p = te(pair["xt"])
            assert p.dtype == torch.float32 and p.shape == (BATCH, 10)
            out[(strategy, prec)] = p.numpy()
    return out


@pytest.mark.parametrize("strategy", L.MEMBER_STRATEGIES)
@pytest.mark.parametrize("prec,tol", [
    ("fp32", 1e-5),
    # both cast every float weight and the input to bf16 and run the head in
    # float32 on bf16-rounded weights; the convolutions round in bf16 at the
    # same places on this CPU (measured 1.2e-7), the tolerance leaves room for
    # other accumulation orders
    ("bf16", 1e-3),
    # XLA fuses the dequantization product into the convolution it feeds and
    # need not round it to bf16 first, where the port rounds q * scale to
    # bf16 as JAX's dequantize_tree spells it (measured 8.6e-4)
    ("int8", 5e-3)])
def test_engines_match_jax(engines, prec, tol, strategy):
    got, want = engines[(strategy, prec)], engines[("jax", prec)]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def _small_models():
    """(JAX module, port factory, NHWC input) of MLP200MNIST (no BatchNorm,
    linear layers only) and WideResNet-10-1 (convolutions with biases)."""
    return {
        "MLP200MNIST": (jmodels.get_model("MLP200MNIST").build(10),
                        lambda: tmodels.get_model("MLP200MNIST").build(10), (28, 28, 1)),
        "WRN10x1": (JWideResNet(depth=10, widen_factor=1, num_classes=10),
                    lambda: tmodels.WideResNet(depth=10, widen_factor=1, num_classes=10),
                    (32, 32, 3)),
    }


@pytest.fixture(scope="module", params=["MLP200MNIST", "WRN10x1"])
def more_engines(request):
    """As ``engines``, for a 2-member ensemble of each of ``_small_models``."""
    jm, make, hwc = _small_models()[request.param]
    variables = []
    for k in range(MEMBERS):
        v = jax.tree.map(np.array, jinit(jm, jax.random.PRNGKey(10 + k), hwc))
        head = sorted(n for n in v["params"] if n.startswith("Dense"))[-1]
        v["params"][head]["kernel"] = v["params"][head]["kernel"] * 20.0
        variables.append(v)
    state = stack_state_dicts([{k: t.clone() for k, t in params_from_jax(make(), v)
                               .state_dict().items()} for v in variables])
    params = tree_stack([v["params"] for v in variables])
    bstats = (tree_stack([v["batch_stats"] for v in variables])
              if "batch_stats" in variables[0] else None)
    x = np.random.default_rng(1).normal(size=(BATCH,) + hwc).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    chw = (hwc[2],) + hwc[:2]
    out = {"model": request.param}
    for prec in L.PRECISIONS:
        je, _ = j_build_engine(jm, params, bstats, BATCH, hwc, prec, "vmap")
        out[("jax", prec)] = np.asarray(je(jnp.asarray(x)))
        for strategy in L.MEMBER_STRATEGIES:
            te, _ = L.build_engine(make(), state, BATCH, chw, prec, strategy)
            out[(strategy, prec)] = te(xt).numpy()
    return out


@pytest.mark.parametrize("prec,tol", [("fp32", 1e-5), ("bf16", 1e-3), ("int8", 5e-3)])
def test_engines_match_jax_on_mlp_and_wideresnet(more_engines, prec, tol):
    """The tolerances of ``test_engines_match_jax``, but for the MLP in bf16:
    it runs in bf16 throughout, logits included (flax promotes its bf16
    input and weights to bf16), and XLA and torch round a layer's product
    and bias at different points, so the logits differ by up to one bf16
    ulp of the largest (0.0156 measured at |logit| <= 3.3), which moves a
    probability by up to ~4e-3: 1e-2 there, the export's bf16 tolerance.
    The WRN's head runs in float32 on the pooled float32 features."""
    if prec == "bf16" and more_engines["model"] == "MLP200MNIST":
        tol = 1e-2
    for strategy in L.MEMBER_STRATEGIES:
        got = more_engines[(strategy, prec)]
        np.testing.assert_allclose(got, more_engines[("jax", prec)], rtol=0, atol=tol)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("prec", ["bf16", "int8"])
def test_low_precision_engines_within_envelope_of_fp32(engines, prec):
    """The envelope of tests/test_quantize.py:60."""
    for strategy in L.MEMBER_STRATEGIES:
        np.testing.assert_allclose(engines[(strategy, prec)], engines[(strategy, "fp32")],
                                   atol=0.03)


@pytest.mark.parametrize("prec", L.PRECISIONS)
def test_scan_equals_vmap(engines, prec):
    np.testing.assert_allclose(engines[("scan", prec)], engines[("vmap", prec)],
                               rtol=0, atol=1e-6)


def test_engine_costs(pair):
    tm = tmodels.get_model(NAME).build(10)
    e32, _ = L.build_engine(tm, pair["state"], BATCH, (3, 32, 32), "fp32")
    e8, x = L.build_engine(tm, pair["state"], BATCH, (3, 32, 32), "int8")
    n = sum(v.numel() for v in pair["state"].values())
    io = x.numel() * 4 + BATCH * 10 * 4
    assert e32.cost_bytes == 4 * n + io
    assert e8.cost_bytes < 0.4 * e32.cost_bytes  # 1 byte a weight plus scales
    assert e8.cost_flops == e32.cost_flops
    with torch.no_grad():
        want = MEMBERS * hw.forward_flops(tm, x)
    assert e32.cost_flops == want > 0


def test_engine_rejects_unknown_precision_and_strategy(pair):
    tm = tmodels.get_model(NAME).build(10)
    with pytest.raises(ValueError):
        L.build_engine(tm, pair["state"], BATCH, (3, 32, 32), "fp8")
    with pytest.raises(ValueError):
        L.build_engine(tm, pair["state"], BATCH, (3, 32, 32), "fp32", "auto")
    with pytest.raises(ValueError, match="CUDA"):
        L.build_amortized_engine(tm, pair["state"], BATCH, (3, 32, 32), "fp32")


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_time_engine_protocol(monkeypatch):
    """30 warm-up calls, then 20 batches of 10 timed calls; the aggregate
    drops the first 10 batches. Each call advances a fake clock: 1 s in the
    burn-in batches, 0.5 s after it."""
    clock = _Clock()
    monkeypatch.setattr(L.time, "perf_counter", clock)
    calls = []

    def engine(x):
        calls.append(len(calls))
        timed = len(calls) - L.WARM_UP_ITERS
        clock.now += 1.0 if 0 < timed <= L.BURN_IN_BATCHES * L.REPS_PER_BATCH else 0.5
        return x

    mean, std = L.time_engine(engine, torch.zeros(1))
    monkeypatch.undo()
    assert (L.WARM_UP_ITERS, L.REPS_PER_BATCH, L.BURN_IN_BATCHES) == (30, 10, 10)
    assert len(calls) == 30 + 20 * 10
    assert mean == pytest.approx(0.5) and std == pytest.approx(0.0)


def test_member_strategy_auto_rule():
    """The faster strategy as measured on an H100, from one member's FLOPs on
    one image: scan for one member; vmap without convolutions; with them,
    vmap while a member's forward stays within 40 (fp32), 14 (bf16) and 46
    (int8) GFLOP, in fp32 only at batch 1 (under 64 pixels up to batch 7)."""
    r = L.resolve_member_strategy
    cifar, imagenet = (3, 32, 32), (3, 224, 224)
    pre, _ = L.member_cost("PreResNet20", 10, cifar)
    wrn, _ = L.member_cost("WideResNet28x10", 10, cifar)
    tv, convs = L.member_cost("TVResNet50", 1000, imagenet)
    inr, _ = L.member_cost("INResNet50", 1000, imagenet)
    mlp, mlp_convs = L.member_cost("MLP200MNIST", 10, (1, 28, 28))
    assert convs and not mlp_convs
    assert 0.08e9 < pre < 0.09e9 and 11.8e9 < wrn < 12e9 and 8.1e9 < tv < 8.3e9
    assert 126e9 < inr < 128e9
    for prec in ("bf16", "int8"):
        assert r("auto", 6, 1, cifar, prec, pre) == "vmap"
        assert r("auto", 6, 128, cifar, prec, pre) == "vmap"
        assert r("auto", 6, 1, cifar, prec, wrn) == "vmap"
        assert r("auto", 6, 128, cifar, prec, wrn) == "scan"
    assert r("auto", 6, 1, cifar, "fp32", pre) == "vmap"
    assert r("auto", 6, 8, cifar, "fp32", pre) == "scan"
    assert r("auto", 6, 128, cifar, "fp32", pre) == "scan"
    assert r("auto", 6, 1, cifar, "fp32", wrn) == "vmap"
    assert r("auto", 6, 128, cifar, "fp32", wrn) == "scan"
    for prec in L.PRECISIONS:
        assert r("auto", 2, 1, imagenet, prec, tv) == "vmap"
        assert r("auto", 2, 8, imagenet, prec, tv) == "scan"
        assert r("auto", 2, 1, imagenet, prec, inr) == "scan"
        for b in (1, 128):
            assert r("auto", 6, b, (1, 28, 28), prec, mlp, convs=False) == "vmap"
            assert r("auto", 1, b, (1, 28, 28), prec, mlp, convs=False) == "scan"
    assert r("auto", 2, 32, imagenet, "bf16", tv) == "scan"
    assert r("auto", 2, 2, imagenet, "fp32", tv) == "scan"
    assert r("auto", 2, 2, imagenet, "bf16", tv) == "scan"
    assert r("auto", 2, 4, imagenet, "int8", tv) == "vmap"
    assert r("auto", 1, 1, imagenet, "int8", tv) == "scan"
    assert r("auto", 1, 1, cifar, "bf16", pre) == "scan"
    assert r("scan", 6, 1, cifar, "bf16", pre) == "scan"


def test_run_sweep_resumes_from_cache_and_table_renders(tmp_path, monkeypatch):
    measured = []

    def fake(cfg, amortize_k=0, per_call=True, member_strategy="vmap", device=None,
             trace_dir=None):
        measured.append((cfg.key(), per_call, amortize_k))
        out = {**L.asdict(cfg), "device": "fake", "achieved_tflops": 1.0}
        if per_call:
            out.update(latency_mean_s=1e-3, latency_std_s=1e-4)
        if amortize_k:
            out.update(amortized_latency_s=5e-4, amortized_latency_std_s=1e-5,
                       amortized_loop_k=amortize_k, mfu_pct_of_bf16_peak=1.5)
        return out

    monkeypatch.setattr(L, "profile_config", fake)
    cache_path = str(tmp_path / "cache.json")
    configs = [L.ProfileConfig("PreResNet20", "CIFAR10", p, 6, b)
               for p in ("fp32", "int8") for b in (1, 128)]
    L.run_sweep(configs, cache_path)
    assert len(measured) == 4 and all(m[1] and m[2] == 0 for m in measured)
    L.run_sweep(configs, cache_path)
    assert len(measured) == 4  # all cached
    cache = L.run_sweep(configs, cache_path, amortize_k=100)
    assert len(measured) == 8 and all(not m[1] and m[2] == 100 for m in measured[4:])
    L.run_sweep(configs, cache_path, amortize_k=50)
    assert len(measured) == 8  # a smaller K than cached is not measured again
    entry = cache[configs[0].key()]
    assert entry["latency_mean_s"] == 1e-3 and entry["amortized_loop_k"] == 100

    table = make_latex_table(cache)
    rows = [line for line in table.splitlines() if line.startswith("PreResNet20")]
    assert len(rows) == 2  # S=6 at batch 1 and 128; precisions are columns
    assert "fp32 call (ms)" in table and "int8 device (ms)" in table
    assert "$1.000 \\pm 0.100$" in rows[0] and "$0.500 \\pm 0.010$" in rows[0]
    assert "1.5" in rows[0] and "\\bottomrule" in table
    assert "tunnel" not in table


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 SXM5 80GB", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12)),
    ("NVIDIA H200", (989e12, 4.8e12)),
    ("NVIDIA A100-SXM4-80GB", (None, None)),
    ("cpu", (None, None)),
])
def test_device_peaks_by_name(name, want):
    assert hw.device_peaks(name) == want


def test_peaks_of_a_cpu_device():
    assert hw.device_peaks(torch.device("cpu")) == (None, None)
    assert hw.device_name(torch.device("cpu")) == "cpu"


def _loaders(n_test=70, batch=32):
    kw = dict(batch_size=batch, use_validation=False, synthetic_n_train=32,
              synthetic_n_test=n_test)
    return jdata.loaders("CIFAR10", None, **kw), tdata.loaders("CIFAR10", None, **kw)


def test_prediction_latency_mode_matches_plain_path_and_jax(pair):
    """As tests/test_tasks.py:68-97: the timed per-batch loop (short last
    batch) and the padded BMA pass agree to float noise, and so do their
    metrics; the timed loop also equals the JAX package's latency mode."""
    (sj, c), (st, _) = _loaders()
    tens = TEnsemble(tmodels.get_model(NAME).build(c), pair["state"], MEMBERS)
    fast = ttasks.Prediction({"in_distribution_test": st["test"]}, c)
    timed = ttasks.Prediction({"in_distribution_test": st["test"]}, c, latency_mode=True)
    p_fast, e_fast = accumulate_split(tens, st["test"], smooth_probs=False)
    p_timed, e_timed = timed._accumulate_timed(tens)
    np.testing.assert_allclose(p_timed, p_fast, atol=1e-5)
    np.testing.assert_allclose(e_timed, e_fast, atol=1e-5)
    timed.latencies.clear()

    fast.update_statistics(tens, output_performance=False)
    timed.update_statistics(tens, output_performance=False)
    assert len(timed.latencies) == -(-st["test"].n // st["test"].batch_size) == 3
    assert all(t > 0 for t in timed.latencies)
    m_fast, m_timed = fast.get_performance_metrics(), timed.get_performance_metrics()
    for k, v in m_fast.items():
        tol = 0.05 if k.endswith(("auroc", "aucpr")) else 1e-5
        if np.isnan(v):
            assert np.isnan(m_timed[k]), k
        else:
            assert abs(v - m_timed[k]) < tol, (k, v, m_timed[k])

    jens = JEnsemble.from_list(pair["jm"], pair["variables"])
    jt = jtasks.Prediction({"in_distribution_test": sj["test"]}, c, latency_mode=True)
    jt.update_statistics(jens, output_performance=False)
    np.testing.assert_allclose(timed.ensemble_proba, jt.ensemble_proba, atol=1e-5)
    np.testing.assert_allclose(timed.expected_data_uncertainty,
                               jt.expected_data_uncertainty, atol=1e-5)


def test_profile_config_and_profile_prediction_on_cpu():
    """The whole measurement path at a tiny size; a CPU run labels its
    device and reports no device metric."""
    cfg = L.ProfileConfig(NAME, "CIFAR10", "int8", 2, 1)
    res = L.profile_config(cfg, member_strategy="auto", device="cpu")
    assert res["device"] == "cpu" and res["amortized_member_strategy"] == "vmap"
    assert res["latency_mean_s"] > 0 and res["images_per_sec"] > 0
    assert not {"achieved_tflops", "mfu_pct_of_bf16_peak", "hbm_gb_per_sec"} & set(res)
    with pytest.raises(ValueError, match="CUDA"):
        L.profile_config(cfg, amortize_k=10, per_call=False, device="cpu")

    _, (st, c) = _loaders(n_test=40, batch=16)
    pcfg = L.ProfileConfig(NAME, "CIFAR10", "fp32", 2, 16)
    out = L.profile_prediction(pcfg, st, c, device="cpu")
    assert out["num_batches"] == 3 and out["device"] == "cpu"
    assert set(out["metrics"]) == set(ttasks.Prediction.supported_metric_list)
    ens = L.random_ensemble(NAME, c, 2, "cpu")
    plain = ttasks.Prediction({"in_distribution_test": st["test"]}, c)
    plain.update_statistics(ens, output_performance=False)
    for k, v in plain.get_performance_metrics().items():
        tol = 0.05 if k.endswith(("auroc", "aucpr")) else 1e-5
        assert abs(v - out["metrics"][k]) < tol or (np.isnan(v) and np.isnan(out["metrics"][k]))


def test_trace_dir_writes_a_profiler_trace_on_the_cpu(tmp_path, monkeypatch):
    """``profile_config(trace_dir=)`` times the per-call protocol under
    ``torch.profiler`` and writes ``<trace_dir>/<key>.json``; ``run_sweep``
    passes it through."""
    cfg = L.ProfileConfig("MLP200MNIST", "MNIST", "fp32", 1, 1)
    res = L.profile_config(cfg, device="cpu", trace_dir=str(tmp_path / "traces"))
    path = tmp_path / "traces" / f"{cfg.key()}.json"
    assert res["trace_path"] == str(path) and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert sum(e.get("name") == "aten::linear" for e in events) >= L.WARM_UP_ITERS * 3
    assert res["latency_mean_s"] > 0
    monkeypatch.setattr(L, "profile_config", functools.partial(L.profile_config, device="cpu"))
    cache = L.run_sweep([cfg], str(tmp_path / "cache.json"), trace_dir=str(tmp_path / "t2"))
    assert (tmp_path / "t2" / f"{cfg.key()}.json").exists()
    assert cache[cfg.key()]["trace_path"].endswith(".json")


def test_train_step_flops_on_the_meta_device_match_a_real_step():
    """The count taken from shapes alone (the meta device) equals the count
    of a real training step on the CPU, and leaves the module untouched."""
    from torch.utils.flop_counter import FlopCounterMode

    m = tmodels.get_model(NAME).build(10)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    got = hw.train_step_flops(m, 4, (3, 32, 32))
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        torch.nn.functional.cross_entropy(m.train()(x), torch.zeros(4, dtype=torch.long)
                                          ).backward()
    assert got == counter.get_total_flops() > 3 * hw.forward_flops(m, x) * 0.9
    for k, v in before.items():
        if "running" not in k:  # the real step above moved the running stats
            assert torch.equal(v, m.state_dict()[k])
