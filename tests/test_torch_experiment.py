"""The benchmark runner and the CLI of ursabench_tpu_torch against the JAX
package's: both drivers' ``main`` with the same arguments and, in place of
the sampler, the same two-member ensemble (transferred from flax), give
the same results, CSV rows and ``.npz`` keys; the flags whose machinery is
not ported raise naming their ROADMAP.md item; ``cli`` dispatches; the
default method (HMC) and the PCA subspace sampler run, ``--checkpoint_path``
resumes and ``--pretrained_model_path`` warm-starts."""

import csv
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ursabench_tpu import experiment as jexp
from ursabench_tpu import models as jmodels
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu.inference.ensemble import Ensemble as JEnsemble
from ursabench_tpu_torch import cli as tcli
from ursabench_tpu_torch import experiment as texp
from ursabench_tpu_torch import inference as tinference
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.inference.ensemble import Ensemble as TEnsemble
from ursabench_tpu_torch.parallel import distributed as tdist
from ursabench_tpu_torch.transfer import params_from_jax

torch.set_num_threads(1)

HYP = {"lr": 0.03, "prior_std": 1.0, "num_samples": 2, "burn_in_epochs": 1}
ARGV = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--inference_method", "SGLD",
        "--batch_size", "32", "--hyperparams", json.dumps(HYP),
        "--synthetic_n_train", "96", "--synthetic_n_test", "70"]


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


class _Drawn:
    """Stands in for a sampler: ``sample()`` returns a given ensemble."""

    def __init__(self, ensemble):
        self.ensemble = ensemble

    def sample(self):
        return self.ensemble


def _ensembles():
    """Two 2-member MLP200MNIST ensembles, the trials' stand-ins, with
    sharpened heads so that no metric rests on a near tie."""
    jm = jmodels.get_model("MLP200MNIST").build(10)
    jens, tens = [], []
    for trial in range(2):
        variables = []
        for k in range(2):
            v = jinit(jm, jax.random.PRNGKey(20 + 2 * trial + k), (28, 28, 1))
            head = v["params"]["Dense_2"]
            v = {"params": {**v["params"], "Dense_2": {"kernel": head["kernel"] * 8.0,
                                                       "bias": head["bias"]}}}
            variables.append(v)
        jens.append(JEnsemble.from_list(jm, variables))
        states = [{k: t.clone() for k, t in params_from_jax(
            tmodels.get_model("MLP200MNIST").build(10),
            jax.tree.map(np.array, v)).state_dict().items()} for v in variables]
        tens.append(TEnsemble.from_list(tmodels.get_model("MLP200MNIST").build(10), states))
    return jens, tens


@pytest.fixture
def injected(monkeypatch):
    jens, tens = _ensembles()
    monkeypatch.setattr(jexp, "_make_sampler",
                        lambda args, hyp, module, train, seed: _Drawn(jens[seed % 2]))
    monkeypatch.setattr(texp, "_make_sampler",
                        lambda args, hyp, module, train, seed, device, mesh=None:
                        _Drawn(tens[seed % 2]))


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_rows_match(got, want, n_fixed):
    assert len(got) == len(want) == 1 and len(got[0]) == len(want[0])
    assert got[0][:n_fixed] == want[0][:n_fixed]
    for g, w in zip(got[0][n_fixed:], want[0][n_fixed:]):
        if np.isnan(float(w)):
            assert np.isnan(float(g))
        else:
            assert float(g) == pytest.approx(float(w), abs=1e-5)


@pytest.mark.parametrize("imbalance", [False, True])
def test_test_mode_matches_jax(tmp_path, injected, imbalance):
    argv = ARGV + ["--num_trials", "2"] + (["--use_dm_imbalance"] if imbalance else [])
    want = jexp.main(argv + ["--save_path", str(tmp_path / "jax")])
    got = texp.main(argv + ["--save_path", str(tmp_path / "torch")], device="cpu")
    assert list(got) == list(want)
    assert "cost_mean" in got and "total_uncertainty_auroc_KMNIST_std" in got
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-5), (k, got[k], want[k])
    _assert_rows_match(_rows(tmp_path / "torchresults.csv"), _rows(tmp_path / "jaxresults.csv"),
                       6 + len(HYP))
    zj, zt = np.load(tmp_path / "jax_tests.npz"), np.load(tmp_path / "torch_tests.npz")
    assert sorted(zt.files) == sorted(zj.files) == sorted(want)
    assert texp.TIMINGS["Prediction_images"] == 2 * 70
    assert texp.TIMINGS["OODDetection_images"] == 2 * 2 * (70 + 70)


def test_validation_mode_matches_jax(tmp_path, injected):
    argv = ARGV + ["--use_val", "--seed", "3"]
    want = jexp.main(argv + ["--save_path", str(tmp_path / "jax")])
    got = texp.main(argv + ["--save_path", str(tmp_path / "torch")], device="cpu")
    assert list(got) == list(want)
    _assert_rows_match(_rows(tmp_path / "torchresults.csv"), _rows(tmp_path / "jaxresults.csv"),
                       6 + len(HYP))


@pytest.mark.parametrize("extra", [
    pytest.param(["--chain_strategy", "vmap", "--chains", "2", "--use_dm_imbalance"],
                 id="extra6-7"),
])
def test_unported_flags_raise(tmp_path, monkeypatch, extra):
    """The flags that raised while their machinery was unported now run: with
    ``--chain_strategy vmap`` both runners build their samplers batched over
    2 chains (each then draws the same injected ensemble), and the port's
    results and CSV row are the JAX runner's."""
    jens, tens = _ensembles()
    built = {"jax": [], "torch": []}

    def drawn(make, ensembles, side, strategy):
        def made(*a, **kw):
            sampler = make(*a, **kw)  # built with the flags, then drawing the injected one
            built[side].append((sampler.chains, strategy(sampler)))
            return _Drawn(ensembles[a[4] % 2])
        return made

    monkeypatch.setattr(jexp, "_make_sampler", drawn(jexp._make_sampler, jens, "jax",
                                                     lambda s: s.chain_strategy))
    monkeypatch.setattr(texp, "_make_sampler", drawn(texp._make_sampler, tens, "torch",
                                                     lambda s: s._resolved_chain_strategy))
    argv = ARGV + ["--num_trials", "2"] + extra
    want = jexp.main(argv + ["--save_path", str(tmp_path / "jax")])
    got = texp.main(argv + ["--save_path", str(tmp_path / "torch")], device="cpu")
    assert built["jax"] == built["torch"] == [(2, "vmap")] * 4  # 2 trials, 2 Decision reruns
    assert list(got) == list(want)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-5), (k, got[k], want[k])
    _assert_rows_match(_rows(tmp_path / "torchresults.csv"), _rows(tmp_path / "jaxresults.csv"),
                       6 + len(HYP))


@pytest.mark.parametrize("method", ["MethodSweep", "SGHMCSweep"])
def test_sweeps_are_not_runner_samplers(tmp_path, method):
    """A sweep runs K configurations; the runner samples one: it names the
    hyperopt entry points instead."""
    assert tinference.get_inference(method) is getattr(tinference, method)
    with pytest.raises(ValueError, match="hyperopt"):
        texp.main(ARGV + ["--save_path", str(tmp_path / "x"), "--inference_method", method],
                  device="cpu")


def test_default_method_is_hmc_and_unknown_ones_raise():
    args = texp.build_parser().parse_args(["--model", "MLP200MNIST"])
    assert args.inference_method == "HMC" and args.mesh == "auto" and args.seed == 1
    with pytest.raises(KeyError):
        tinference.get_inference("NoSuchSampler")
    assert tinference.get_inference("SGHMC") is tinference.SGHMC


def test_mesh_over_several_devices_raises(monkeypatch):
    """``--mesh`` lays the run out over the process group's ranks, as the
    JAX runner's ``_build_mesh`` over its devices: with one process every
    choice is no mesh; over 4 ranks the layouts of ``auto_mesh`` and
    ``chain_mesh``. A layout whose processes do not exist (here, 4 ranks
    claimed by a one-process run) is refused when the run's mesh is built."""
    parse = texp.build_parser().parse_args
    for mesh in ("auto", "chain", "none"):  # one process: no mesh
        assert texp._build_mesh(parse(["--model", "m", "--mesh", mesh, "--chains", "2"])) is None
    layout = lambda argv: texp._mesh_layout(parse(["--model", "m"] + argv), 4)  # noqa: E731
    assert layout([]) == (1, 4)
    assert layout(["--chains", "2"]) == (2, 2)
    assert layout(["--mesh", "chain", "--chains", "2"]) == (2, 1)
    assert layout(["--mesh", "chain"]) is None
    assert layout(["--mesh", "chain", "--chains", "3"]) == (3, 1)  # 3 of the 4 ranks
    assert layout(["--mesh", "none", "--chains", "4"]) is None
    # chains 1 and a batch no rank count divides: nothing to shard, as in JAX
    assert layout(["--batch_size", "35"]) is None
    monkeypatch.setattr(texp, "world_size", lambda: 4)
    with pytest.raises(ValueError, match="initialize"):
        texp._build_mesh(parse(RUN + ["--inference_method", "SGLD"]))


def test_runner_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        texp.main(ARGV)


def test_cli_dispatch(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(texp, "main", lambda argv=None, device=None: seen.append(argv))
    assert tcli.main(["run", "--dataset", "MNIST"]) == 0
    assert seen == [["--dataset", "MNIST"]]
    capsys.readouterr()
    assert tcli.main(["models"]) == 0
    listed = capsys.readouterr().out.split()
    assert listed == tmodels.list_models() and "WideResNet28x10" in listed
    assert set(listed) <= set(jmodels.list_models())
    from ursabench_tpu_torch import run_hypopt, time_script

    monkeypatch.setattr(time_script, "main", lambda argv=None, device=None: seen.append(argv))
    assert tcli.main(["time", "--save_path", "t"]) == 0
    assert seen[-1] == ["--save_path", "t"]

    for cmd, fn in (("hypopt", "main_seq"), ("hypopt-par", "main_par")):
        monkeypatch.setattr(run_hypopt, fn, lambda argv=None, device=None, c=cmd: seen.append(c))
        assert tcli.main([cmd, "--domain_path", "d.json"]) == 0
    assert seen[-2:] == ["hypopt", "hypopt-par"]
    assert tcli.main(["nope"]) == 2
    assert tcli.main([]) == 0


def test_cli_run_refuses_without_a_gpu():
    """``python -m ursabench_tpu_torch.cli run ...`` imports no JAX and,
    without a CUDA device, exits non-zero: no CPU run stands in."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "sys.argv = ['cli'] + sys.argv[1:]\n"
            "runpy.run_module('ursabench_tpu_torch.cli', run_name='__main__', alter_sys=True)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, "run", *ARGV], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA" in out.stderr


HMC_HYP = {"step_size": 1e-3, "num_samples": 3, "L": 2, "tau": 1.0, "burn": 1, "mass": 1.0}
PCA_HYP = {"swag_lr": 0.01, "swag_wd": 1e-4, "lr_init": 0.02, "num_samples": 2,
           "swag_momentum": 0.9, "swag_burn_in_epochs": 1, "num_swag_iterates": 2, "rank": 2,
           "max_rank": 2, "temperature": 100.0, "prior_std": 1.0}
RUN = ["--dataset", "MNIST", "--model", "MLP200MNIST", "--batch_size", "32",
       "--synthetic_n_train", "96", "--synthetic_n_test", "40"]


@pytest.mark.parametrize("method,hyp", [(None, HMC_HYP), ("PCASubspaceSampler", PCA_HYP)])
def test_default_hmc_and_pca_run_and_write_their_row(tmp_path, method, hyp):
    """``cli run`` with its default method, HMC, and with the PCA subspace
    sampler (``experiment.main``, as ``cli run`` calls it, on the CPU)."""
    argv = RUN + ["--hyperparams", json.dumps(hyp), "--use_val", "--save_path",
                  str(tmp_path / "v")]
    if method is not None:
        argv += ["--inference_method", method]
    perf = texp.main(argv, device="cpu")
    rows = _rows(tmp_path / "vresults.csv")
    assert len(rows) == 1 and rows[0][3] == (method or "HMC")
    assert len(rows[0]) == 6 + len(hyp) + len(perf)
    assert all(np.isfinite(v) for k, v in perf.items() if "auroc" not in k)


@pytest.mark.parametrize("method,hyp,where", [("SGLD", HYP, "epoch 3"),
                                              ("HMC", HMC_HYP, "draw 3")])
def test_checkpoint_path_resumes(tmp_path, capsys, method, hyp, where):
    """A second run with the same --checkpoint_path resumes each trial's
    chain from its file; the message counts epochs, or draws for HMC (the
    JAX runner reads ``epochs_run``, which HMC does not have). An epoch
    sampler's resumed chain draws its samples anew from there, as in the
    JAX package; HMC's holds every draw already, so its results repeat."""
    argv = RUN + ["--inference_method", method, "--hyperparams", json.dumps(hyp),
                  "--num_trials", "2", "--checkpoint_path", str(tmp_path / "ck"),
                  "--checkpoint_every", "1"]
    first = texp.main(argv, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["ck.seed0.npz", "ck.seed1.npz"]
    assert "resumed" not in capsys.readouterr().out
    again = texp.main(argv, device="cpu")
    assert capsys.readouterr().out.count(f"resumed chain at {where}") == 2
    if method == "HMC":
        for k in first:
            assert again[k] == first[k] or (np.isnan(again[k]) and np.isnan(first[k])), k
    else:  # two more draws, one epoch each
        from ursabench_tpu_torch.utils_checkpoint import load_pytree

        assert int(load_pytree(str(tmp_path / "ck.seed0.npz"))["epochs_run"]) == 5


def test_pretrained_model_path_warm_starts_sgld(tmp_path):
    """A variables file written by the JAX package warm-starts every chain
    of an epoch sampler; HMC, which has no training state, refuses it."""
    from ursabench_tpu.utils_checkpoint import save_variables

    variables = jax.tree.map(np.asarray, jinit(jmodels.get_model("MLP200MNIST").build(10),
                                               jax.random.PRNGKey(9), (28, 28, 1)))
    path = str(tmp_path / "w.npz")
    save_variables(path, variables)
    want = params_from_jax(tmodels.get_model("MLP200MNIST").build(10), variables)
    args = texp.build_parser().parse_args(RUN + ["--inference_method", "SGLD", "--chains", "2",
                                                 "--pretrained_model_path", path])
    from ursabench_tpu_torch import data as tdata

    splits, c = tdata.loaders("MNIST", None, batch_size=32, use_validation=False,
                              synthetic_n_train=96, synthetic_n_test=40)
    sampler = texp._make_sampler(args, HYP, tmodels.get_model("MLP200MNIST").build(c),
                                 splits["train"], 0, torch.device("cpu"))
    for module in sampler.modules:
        for k, v in want.state_dict().items():
            assert torch.equal(module.state_dict()[k], v), k
    args.inference_method = "HMC"
    with pytest.raises(NotImplementedError, match="pretrained_model_path"):
        texp._make_sampler(args, HMC_HYP, tmodels.get_model("MLP200MNIST").build(c),
                           splits["train"], 0, torch.device("cpu"))
    results = texp.main(RUN + ["--inference_method", "SGLD", "--hyperparams", json.dumps(HYP),
                               "--pretrained_model_path", path], device="cpu")
    assert np.isfinite(results["error_rate_mean"])
