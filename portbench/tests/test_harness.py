"""The harness on the CPU: its files load, a cell, an architecture and a
traffic kind added as files are found, a configuration records its cuts,
the result line keeps its schema, the reference models are the port's and
their FLOP counts hold, no run loads JAX, and each cell's CPU twin comes out
correct, and not correct once the program is broken underneath by each
fault of its kind."""

import functools
import json
import subprocess
import sys
import types

import pytest
import torch

from portbench import core, flops, inputs, run
from portbench.reference.philox import philox4x32_10
from portbench.reference.sghmc import first_epoch_draws, sghmc_steps
from portbench.tests import tiny
from portbench.trace import UNTRACED, kernel_class, reduce

BENCH = json.loads((core.CHECKOUT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
TWINNED = [c for c in CELLS if tiny.twin(c) is not None]


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return tiny.write_root(tmp_path_factory.mktemp("tiny"))


# -- the files ---------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_file_loads_and_agrees_with_the_benchmark(cell):
    reg = core.Registry()
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = reg.json("workloads", cell)
    assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == {
        k: entry[k] for k in ("config", "traffic", "chips", "why")}
    cfg, tr = reg.json("configs", wl["config"]), reg.json("traffic", wl["traffic"])
    assert reg.path("drivers", tr["kind"], ".py").is_file()
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    assert reg.model(cfg).parameter_count == cfg["parameters"]


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader(metric):
    assert callable(core.Registry().module("metrics", metric).read)


def unrecorded_cuts(entry: dict, cfg: dict) -> list:
    """What a ``configs`` entry of ``BENCHMARK.json`` and its file leave
    unrecorded of the configuration's cuts. Each key in ``reduced`` has its
    published value under the file's ``published``, and runs at another;
    every key under ``published`` is in ``reduced``; a configuration with a
    cut states in one line the deployment whose share it runs
    (``deployment``, say "8-way expert parallel, 4 pipeline stages")."""
    published, reduced = cfg.get("published", {}), entry["reduced"]
    out = [f"{k}: in reduced, no published value" for k in reduced if k not in published]
    out += [f"{k}: in reduced, runs at its published value {published[k]!r}" for k in reduced
            if k in published and cfg.get(k) == published[k]]
    out += [f"{k}: cut from {published[k]!r}, not in reduced" for k in published
            if k not in reduced]
    deployment = cfg.get("deployment")
    if reduced and not (isinstance(deployment, str) and deployment.strip()
                        and "\n" not in deployment):
        out.append("cut, but no one-line deployment")
    return out


def test_configs_are_the_benchmark_files():
    for c in BENCH["configs"]:
        cfg = json.loads((core.CHECKOUT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and unrecorded_cuts(c, cfg) == []


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new configuration, mix, cell and metric in another directory are
    found by name, with no edit of the harness."""
    for sub in ("configs", "traffic", "workloads", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "new-cfg.json").write_text(
        (tiny.ROOT / "configs" / "tiny-preresnet.json").read_text())
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps({"kind": "bma_pass"}))
    (tmp_path / "workloads" / "new-cfg.new-mix.json").write_text(json.dumps(
        {"config": "new-cfg", "traffic": "new-mix", "chips": 1, "why": "x", "limits": {}}))
    (tmp_path / "metrics" / "new_metric.x.py").write_text("def read(run):\n    return 7.0\n")
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "new_metric.x", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "device", "moves": "bma_images_per_s", "workloads": ["new-cfg.new-mix"]}])
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["new-cfg.new-mix"])
                           if m["name"] == "bma_images_per_s" else m for m in bench["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    reg = core.Registry([tmp_path], tmp_path / "BENCHMARK.json")
    cell = core.Cell.load(reg, "new-cfg.new-mix", 3, "cpu")
    assert cell.config["depth"] == 8 and cell.traffic["kind"] == "bma_pass"
    assert type(cell.driver()).__module__.endswith("bma_pass")
    names = [m["name"] for m in reg.metrics("new-cfg.new-mix", trace=True)]
    assert "new_metric.x" in names and "device_idle_pct.bma" not in names
    assert reg.module("metrics", "new_metric.x").read(None) == 7.0
    assert [m["name"] for m in reg.metrics("new-cfg.new-mix", trace=False)] == [
        "bma_images_per_s", "setup_s"]


# an architecture over token ids, as a later change would add its own file:
# an embedding and a linear head over the vocabulary, next-token cross entropy
TOY_TOKENS = '''
import torch
import torch.nn.functional as F

from portbench.reference.layers import Leaf, Precision
from portbench.reference.models import Model


class Architecture(Model):
    def __init__(self, cfg):
        self.vocab, self.width = int(cfg["vocab_size"]), int(cfg["hidden_size"])
        self.seq = int(cfg["seq_len"])
        self.leaves = [Leaf("embed.weight", (self.vocab, self.width), "uniform", 1, self.width),
                       Leaf("head.weight", (self.vocab, self.width), "uniform", self.width,
                            self.vocab)]

    def forward(self, tensors, x, train, precision=Precision()):
        h = F.embedding(x, tensors["embed.weight"])
        return F.linear(precision.operand(h), precision.operand(tensors["head.weight"])).float()

    def example(self, batch, device="meta"):
        ids = torch.zeros((batch, self.seq), dtype=torch.long, device=device)
        return ids, ids

    def train_batch(self, inputs, labels, draws, i):
        rows = inputs.index_select(0, draws["plan"][i])
        return rows[:, :-1], rows[:, 1:]

    def loss(self, logits, target):
        return F.cross_entropy(logits.flatten(0, 1), target.flatten())
'''
TOY_CONFIG = {"name": "toy-tokens", "reference": "toy_tokens", "vocab_size": 96,
              "hidden_size": 16, "seq_len": 8, "published": {"vocab_size": 768},
              "deployment": "the head's vocabulary split 8 ways, this chip's slice"}
TOY_ENTRY = {"name": "toy-tokens", "source": "a test", "file": "configs/toy-tokens.json",
             "reduced": ["vocab_size"], "why": "a token model added as files"}


@pytest.fixture
def toy_root(tmp_path):
    for sub in ("configs", "traffic", "workloads", "reference"):
        (tmp_path / sub).mkdir()
    (tmp_path / "reference" / "toy_tokens.py").write_text(TOY_TOKENS)
    (tmp_path / "configs" / "toy-tokens.json").write_text(json.dumps(TOY_CONFIG))
    (tmp_path / "traffic" / "toy-sghmc.json").write_text(
        (core.PACKAGE / "traffic" / "sghmc.json").read_text())
    (tmp_path / "workloads" / "toy-tokens.toy-sghmc.json").write_text(json.dumps(
        {"config": "toy-tokens", "traffic": "toy-sghmc", "chips": 1, "why": "x", "limits": {}}))
    bench = dict(BENCH, configs=BENCH["configs"] + [TOY_ENTRY])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_an_architecture_added_as_files_is_found(toy_root):
    """A token architecture, its cut and recorded configuration, a mix and
    a cell in another directory: found by name, counted, and stepped by the
    reference sampler, with no edit of the harness."""
    reg = core.Registry([toy_root], toy_root / "BENCHMARK.json")
    model = core.Cell.load(reg, "toy-tokens.toy-sghmc", 3, "cpu").model()
    assert type(model).__module__ == "portbench_reference_toy_tokens"
    entry = next(c for c in reg.benchmark()["configs"] if c["name"] == "toy-tokens")
    assert unrecorded_cuts(entry, reg.json("configs", "toy-tokens")) == []
    v, d, t = 96, 16, 8
    assert model.parameter_count == 2 * v * d
    assert flops.forward_flops(model, 4) == 2 * 4 * t * d * v
    assert flops.train_step_flops(model, 4) == 3 * 2 * 4 * t * d * v
    n, batch = 40, 8
    ids = torch.randint(0, v, (n, t + 1), generator=torch.Generator().manual_seed(0))
    start = {k: w[0] for k, w in inputs.weights(model.leaves, 3, "chain0", "cpu").items()}
    draws = first_epoch_draws(3, n, batch, 0, False, "cpu")
    out = sghmc_steps(model, start, ids, None, draws, {"lr": 0.1, "prior_std": 1.0,
                      "alpha": 0.1, "burn_in_epochs": 1, "num_samples": 5}, n, 2)
    assert len(out["losses"]) == 2 and all(0 < x < 10 for x in out["losses"])
    assert set(out["grads"]) == {"embed.weight", "head.weight"}
    assert not torch.equal(out["params"][1]["head.weight"], start["head.weight"])


@pytest.mark.parametrize("unrecorded", ["not in reduced", "no published value",
                                        "no deployment", "published value"])
def test_an_unrecorded_cut_fails_the_configuration_check(unrecorded):
    entry, cfg = dict(TOY_ENTRY), dict(TOY_CONFIG)
    if unrecorded == "not in reduced":
        entry["reduced"] = []
    elif unrecorded == "no published value":
        cfg["published"] = {}
    elif unrecorded == "no deployment":
        del cfg["deployment"]
    else:
        cfg["vocab_size"] = 768
    assert unrecorded_cuts(entry, cfg)


def test_result_line_schema():
    checks = core.judge({"gap": 1e-3, "other": 5.0}, {"gap": 1e-2})
    assert checks == {"gap": {"value": 1e-3, "limit": 1e-2, "ok": True}}
    assert not core.judge({"gap": float("nan")}, {"gap": 1.0})["gap"]["ok"]
    assert not core.judge({}, {"gap": 1.0})["gap"]["ok"]
    for breakdown in (None, {"device_ops": [["conv", 1.5]], "idle_gaps": []}):
        line = json.loads(core.result_line(
            correct=True, attempted=3, failed=0, metrics={"setup_s": {"value": 1.0, "unit": "s"}},
            device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                    "memory_peak_bytes": 1}, checks=checks, breakdown=breakdown))
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line) == keys + (["breakdown"] if breakdown else []) + ["checks"]
        assert line["checks"] == {"gap": {"value": 1e-3, "limit": 1e-2}}


# -- the reference -------------------------------------------------------------------


@pytest.mark.parametrize("arch,name,kw,cfg", [
    ("preresnet", "PreResNet8", {}, {"depth": 8, "widths": [16, 32, 64], "num_classes": 10}),
    ("wideresnet", "WideResNet28x10", {"depth": 10, "widen_factor": 1},
     {"depth": 10, "widths": [16, 32, 64], "num_classes": 100}),
])
def test_reference_models_are_the_ports(arch, name, kw, cfg):
    """Small versions of the port's models, float32 on the CPU, give the
    reference's logits in train and eval mode from the same tensors."""
    from ursabench_tpu_torch import models

    model = core.Registry().model({"reference": arch, "image": [32, 32, 3], **cfg})
    port = models.get_model(name).build(cfg["num_classes"], **kw)
    port.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in port.modules():
            if hasattr(m, "running_var"):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    tensors = dict(port.state_dict())
    assert [(n, tuple(p.shape)) for n, p in port.named_parameters()] == [
        (leaf.name, leaf.shape) for leaf in model.leaves if not leaf.buffer]
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    for train in (True, False):
        port.train(train)
        with torch.no_grad():
            torch.testing.assert_close(model.forward(tensors, x, train), port(x),
                                       rtol=1e-5, atol=1e-5)


def test_full_size_models_have_the_ports_leaves():
    """The port's model as the run builds it (``core.served_model``, the
    configuration's ``model_kwargs`` with it) has the reference's leaves."""
    for c in BENCH["configs"]:
        cfg = json.loads((core.CHECKOUT / c["file"]).read_text())
        with torch.device("meta"):
            port = core.served_model(cfg)
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
            leaf.name: leaf.shape for leaf in core.Registry().model(cfg).leaves}


# the FLOP counts of the two configurations at the batches the metrics use
# (``step_mfu_pct``: a training step at 128; ``bma_mfu_pct``: a forward of one
# image), as counted before the architectures were found by name
FLOPS = {"preresnet20-cifar10": (31_231_279_104, 81_626_368),
         "wrn28x10-cifar100": (4_570_389_282_816, 11_902_350_336)}


@pytest.mark.parametrize("config", sorted(FLOPS))
def test_flop_counts_hold(config):
    model = core.Registry().model(core.Registry().json("configs", config))
    assert (flops.train_step_flops(model, 128), flops.forward_flops(model, 1)) == FLOPS[config]


def test_philox_known_answers():
    """Random123's known-answer vectors of Philox4x32-10."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                                     0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = philox4x32_10(*(t(c) for c in ctr), *key)
        assert [int(w) for w in got] == list(want)


def test_trace_reduce_takes_the_union_and_names_the_gaps():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class E:
        def __init__(self, name, dev, start, dur):
            self.n, self.d, self.s, self.t = name, dev, start, dur

        def name(self):
            return self.n

        def device_type(self):
            return self.d

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.t

    tr = reduce([E("k_a", cuda, 0, 100), E("k_b", cuda, 50, 100), E("k_a", cuda, 300, 100),
                 E("aten::randperm", cpu, 160, 100), E("outer", cpu, 0, 600)])
    assert tr.window_s == pytest.approx(600e-9)
    assert tr.busy_s == pytest.approx(250e-9)
    assert tr.device["k_a"] == (2, pytest.approx(200e-9))
    assert tr.gaps == {"aten::randperm": pytest.approx(150e-9), "outer": pytest.approx(200e-9)}
    assert tr.kernels("k_") == (3, pytest.approx(300e-9))
    tr = reduce([E("k", cuda, 10, 10), E("early", cpu, 0, 5)])  # over by the gap's middle
    assert tr.gaps == {UNTRACED: pytest.approx(10e-9)}


# the kernel-class table before the attention class
OLD_KERNEL_CLASSES = (
    ("K1 (sghmc_update)", ("sghmc_update",)),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("layout transforms", ("nchwToNhwc", "nhwcToNchw", "transpose")),
    ("convolutions and GEMMs", ("conv", "gemm", "sm90_", "sm80_", "cutlass", "xmma", "wgrad",
                                "dgrad", "implicit")),
    ("dropout and random", ("bernoulli", "philox", "random", "distribution")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index", "copy", "fill")),
)


def test_attention_kernels_have_a_class_of_their_own(monkeypatch):
    """Flash, fused multi-head and SDPA kernels classify as ``attention``,
    not as GEMMs; every substring of the old table, and kernels of today's
    cells, classify as they did."""
    for name in ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128, 64>>",
                 "fmha_cutlassF_bf16_aligned_64x128_rf_sm80",
                 "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3",
                 "void mla_attention_decode_kernel<128>"):
        assert kernel_class(name) == "attention", name
    names = [k for _, keys in OLD_KERNEL_CLASSES for k in keys] + [
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64",
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>",
        "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, 1>",
        "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
        "sghmc_update_kernel", "Memcpy DtoH (Device -> Pinned)", "Memset (Device)"]
    now = [kernel_class(n) for n in names]
    monkeypatch.setattr("portbench.trace.KERNEL_CLASSES", OLD_KERNEL_CLASSES)
    assert now == [kernel_class(n) for n in names]


def test_token_ids_come_from_the_seed():
    seed = 2 ** 31 + 3
    ids = inputs.tokens(seed, "train", 6, 33, 97, "cpu")
    assert ids.shape == (6, 33) and ids.dtype == torch.int64
    assert 0 <= int(ids.min()) and int(ids.max()) < 97
    assert torch.equal(ids, inputs.tokens(seed, "train", 6, 33, 97, "cpu"))
    assert not torch.equal(ids, inputs.tokens(seed, "test", 6, 33, 97, "cpu"))


# -- JAX stays out -------------------------------------------------------------------


def test_banned_names_compare_the_top_level_whole():
    assert core.banned_modules(["ursabench_tpu_torch", "ursabench_tpu_torch.models",
                                "jaxtyping", "flaxen"]) == []
    assert core.banned_modules(["jax", "jax.numpy", "jaxlib.xla", "flax.linen",
                                "ursabench_tpu.models"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla", "ursabench_tpu.models"]


def _modules_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=core.CHECKOUT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(core.CHECKOUT)})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_cells_imports_load_no_jax(cell):
    """Every module a run of the cell imports (the harness, its driver, its
    metrics, the reference and the program's modules the driver uses)."""
    code = (
        "import torch\nfrom portbench import core, run, calibrate\n"
        f"reg = core.Registry(); c = core.Cell.load(reg, {cell!r}, 1, 'cpu'); d = c.driver()\n"
        "import ursabench_tpu_torch.inference, ursabench_tpu_torch.tasks.base\n"
        "import ursabench_tpu_torch.data.arrays, ursabench_tpu_torch.kernels.sghmc\n"
        f"[reg.module('metrics', m['name']) for t in (0, 1) for m in reg.metrics({cell!r}, t)]\n"
    )
    assert core.banned_modules(_modules_after(code)) == []


def test_the_reference_imports_nothing_of_the_program():
    code = ("import portbench.reference.models, portbench.reference.sghmc, "
            "portbench.reference.bma, portbench.reference.philox, portbench.flops, "
            "portbench.reference.preresnet, portbench.reference.wideresnet")
    mods = _modules_after(code)
    assert not [m for m in mods if m.split(".")[0] in ("ursabench_tpu_torch", "ursabench_tpu",
                                                       "jax")]
    for path in (core.PACKAGE / "reference").glob("*.py"):
        imports = [line for line in path.read_text().splitlines()
                   if line.startswith(("import ", "from "))]
        assert not [line for line in imports if "ursabench" in line or "portbench" in line
                    and "portbench.reference" not in line], path


def test_the_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=core.CHECKOUT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("where", ["a metric reader", "the check"])
def test_jax_loaded_after_the_window_leaves_no_result(registry, where, monkeypatch, capsys):
    """A module of JAX that a metric reader or the check loads, once the
    window has closed: the run exits other than 0 and prints no result."""
    planted = types.ModuleType("jax")
    if where == "a metric reader":
        load = registry.module

        def module(kind, name):
            if kind == "metrics":
                monkeypatch.setitem(sys.modules, "jax", planted)
            return load(kind, name)

        monkeypatch.setattr(registry, "module", module)
    else:
        make = core.Cell.driver

        def driver(self):
            d = make(self)
            check = d.check

            def planting_check():
                monkeypatch.setitem(sys.modules, "jax", planted)
                return check()

            d.check = planting_check
            return d

        monkeypatch.setattr(core.Cell, "driver", driver)
    monkeypatch.setattr(run, "run_cell",
                        functools.partial(run.run_cell, registry=registry, device="cpu"))
    cell = tiny.tiny_name("preresnet20-cifar10.bma-pass")
    assert run.main(["--workload", cell, "--seed", str(2 ** 31 + 7), "--seconds", "0.2"]) != 0
    out = capsys.readouterr()
    assert out.out.strip() == "" and "jax" in out.err


# -- whole runs on the CPU -----------------------------------------------------------


def test_every_cell_has_a_cpu_twin():
    """A cell of ``BENCHMARK.json`` brings its CPU run as files (``tiny``)."""
    assert [c for c in CELLS if tiny.twin(c) is None] == []


@pytest.mark.parametrize("cell", TWINNED)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_correct(registry, cell, trace, monkeypatch):
    if trace:  # the profiler's device trace is the card's: read a stand-in
        monkeypatch.setattr(run, "traced", _fake_trace)
    out = run.run_cell(tiny.tiny_name(cell), 2 ** 31 + 5, 0.2, trace, registry, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in registry.metrics(tiny.tiny_name(cell), trace)}
    assert set(out["metrics"]) <= want and (trace or set(out["metrics"]) == want)
    assert set(out["checks"]) == set(tiny.twin(cell)["limits"])


def _fake_trace(fn):
    from portbench.trace import Trace

    fn()
    return Trace(window_s=1.0, busy_s=0.9, device={"sghmc_update_kernel": (2, 1e-5)},
                 gaps={"cudaGraphLaunch": 0.1})


def test_every_kind_has_its_faults(registry):
    """Each twinned cell's kind brings the faults its runs have to fail on
    (``faults/<kind>.py``), and some."""
    kinds = {tiny.kind(c) for c in TWINNED}
    assert kinds and sorted(k for k in kinds if not tiny.kind_faults(k, registry)) == []


# each twin's faults, by its kind; a kind without any leaves its cells none
# here (``test_every_kind_has_its_faults`` fails for it)
CELL_FAULTS = [(c, f) for c in TWINNED for f in tiny.kind_faults(tiny.kind(c))]


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_broken_program_is_not_correct(registry, cell, fault, monkeypatch):
    """The run, with the look for the card skipped and the timed path broken
    underneath, reads ``correct`` false."""
    tiny.kind_faults(tiny.kind(cell), registry)[fault](monkeypatch)
    out = run.run_cell(tiny.tiny_name(cell), 2 ** 31 + 6, 0.2, False, registry, device="cpu")
    assert not out["correct"], out["checks"]


# a traffic kind over other data, as a later change would add its files: a
# driver that subclasses the sampler's and overrides its data methods (here
# ``data_count`` alone, to the same value, counting its calls), its faults
# (the sampler's), and a twin over a tiny PreResNet
TOY_KIND_DRIVER = '''
from portbench.drivers import sampler


class Driver(sampler.Driver):
    calls = 0

    def data_count(self):
        Driver.calls += 1
        return len(self.train_labels)
'''
TOY_KIND_FAULTS = "from portbench.tests.tiny.faults.sampler import FAULTS  # noqa: F401\n"
TOY_TWIN = "tiny.toy-preresnet.toy-sghmc"


def add_kind(root, base: core.Registry, kind: str, faults: str = None) -> core.Registry:
    """Under ``root``: the driver of traffic kind ``kind``, its faults (none
    where ``faults`` is None), a mix of it and a twin of it over the tiny
    PreResNet, with the sampler twin's limits and metrics; a registry that
    finds them before ``base``'s roots."""
    for sub in ("drivers", "faults", "traffic", "workloads"):
        (root / sub).mkdir(exist_ok=True)
    (root / "drivers" / f"{kind}.py").write_text(TOY_KIND_DRIVER)
    if faults is not None:
        (root / "faults" / f"{kind}.py").write_text(faults)
    like = tiny.tiny_name("preresnet20-cifar10.sghmc")
    (root / "traffic" / "toy-sghmc.json").write_text(
        json.dumps(dict(base.json("traffic", "tiny-sghmc"), kind=kind)))
    (root / "workloads" / f"{TOY_TWIN}.json").write_text(json.dumps(
        dict(base.json("workloads", like), traffic="toy-sghmc", why="a kind added as files")))
    bench = base.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(TOY_TWIN)
    bench["workloads"].append(dict(next(w for w in bench["workloads"] if w["name"] == like),
                                   name=TOY_TWIN, traffic="toy-sghmc"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return core.Registry([root] + base.roots[:-1], root / "BENCHMARK.json")


@pytest.fixture(scope="module")
def toy_kind(registry, tmp_path_factory):
    return add_kind(tmp_path_factory.mktemp("toy_kind"), registry, "toy_sampler",
                    TOY_KIND_FAULTS)


def test_a_kind_added_as_files_is_found_and_runs_correct(toy_kind):
    """A new kind's driver, faults and twin in another directory: found by
    name and run correct on the CPU, with no edit of the harness."""
    cell = core.Cell.load(toy_kind, TOY_TWIN, 1, "cpu")
    assert cell.traffic["kind"] == "toy_sampler"
    assert list(tiny.kind_faults("toy_sampler", toy_kind)) == list(tiny.kind_faults("sampler"))
    driver = cell.driver()
    assert type(driver).__module__ == "portbench_drivers_toy_sampler"
    out = run.run_cell(TOY_TWIN, 2 ** 31 + 5, 0.2, False, toy_kind, device="cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and set(out["checks"]) == set(tiny.twin(
        "preresnet20-cifar10.sghmc")["limits"])
    assert type(driver).calls > 0  # the reference took N from the kind's own method


@pytest.mark.parametrize("fault", list(tiny.kind_faults("sampler")))
def test_a_kind_added_as_files_fails_on_its_faults(toy_kind, fault, monkeypatch):
    tiny.kind_faults("toy_sampler", toy_kind)[fault](monkeypatch)
    out = run.run_cell(TOY_TWIN, 2 ** 31 + 6, 0.2, False, toy_kind, device="cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("faults", [None, "FAULTS = {}\n"], ids=["no file", "empty"])
def test_a_kind_without_faults_is_found_out(registry, tmp_path, faults):
    """A twinned kind with no faults file, or an empty one, is what
    ``test_every_kind_has_its_faults`` fails for; it leaves its cells no
    fault cases, and the test modules still load."""
    reg = add_kind(tmp_path, registry, "toy_bare", faults)
    assert core.Cell.load(reg, TOY_TWIN, 1, "cpu").traffic["kind"] == "toy_bare"
    assert tiny.kind_faults("toy_bare", reg) == {}
