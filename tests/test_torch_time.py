"""The per-method timing entry point (``cli time``) and the metric logger of
ursabench_tpu_torch: the JAX package's protocol (methods, burn-in rules,
tuned hyperparameters), the JSON it writes with each method's trial count,
the validation of per-method trial counts, and no CPU fallback."""

import json

import pytest
import torch

from ursabench_tpu import logging_utils as jlog
from ursabench_tpu import time_script as jtime
from ursabench_tpu_torch import logging_utils, time_script

torch.set_num_threads(1)

SMALL = ["--synthetic_n_train", "96", "--synthetic_n_test", "32"]


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


def test_protocol_matches_jax():
    assert time_script.DEFAULT_METHODS == jtime.DEFAULT_METHODS
    for method in time_script.DEFAULT_METHODS:
        hyp = time_script.load_method_hyp(None, method)
        assert hyp == jtime.load_method_hyp(None, method)
        if hyp is not None:
            assert time_script.normalize_burnin(method, hyp, 3) == \
                jtime.normalize_burnin(method, hyp, 3)
    assert time_script.load_method_hyp(None, "SWAG") is None  # MLP200MNIST has none tuned


def test_time_script_writes_mean_std_and_trials(tmp_path, capsys):
    """Mirrors tests/test_drivers.py::test_time_script over HMC, SGLD and
    the PCA subspace sampler, with a warm-up trial and HMC's own count."""
    timer = time_script.main(["--dataset", "MNIST", "--model", "MLP200MNIST",
                              "--save_path", str(tmp_path / "times"),
                              "--methods", "HMC", "SGLD", "PCASubspaceSampler",
                              "--S", "2", "--T", "2", "--warmup_trials", "1",
                              "--method_trials", "HMC=1"] + SMALL, device="cpu")
    with open(tmp_path / "times.json") as f:
        assert json.load(f) == timer
    for m, trials in (("HMC", 1), ("SGLD", 2), ("PCASubspaceSampler", 2)):
        assert timer[f"{m}_trials"] == trials
        assert timer[f"{m}_mean"] > 0 and timer[f"{m}_std"] >= 0
    assert timer["HMC_std"] == 0.0
    out = capsys.readouterr().out
    assert out.count("Trial: -1") == 3 and out.count("Trial: 1") == 2


@pytest.mark.parametrize("extra", [["--method_trials", "SGLD=0"],
                                   ["--method_trials", "SGD=2"],
                                   ["--method_trials", "SGLD"],
                                   ["--method_trials", "SGLD=-1"],
                                   ["--T", "0"], ["--warmup_trials", "-1"]])
def test_trial_counts_are_validated(tmp_path, extra):
    with pytest.raises(SystemExit):
        time_script.main(["--save_path", str(tmp_path / "t"), "--methods", "SGLD"] + extra
                         + SMALL, device="cpu")


def test_time_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        time_script.main(["--save_path", str(tmp_path / "t"), "--methods", "SGLD"] + SMALL)


def test_metric_logger_and_silent(tmp_path, capsys):
    path = tmp_path / "log.jsonl"
    for mod in (logging_utils, jlog):
        log = mod.MetricLogger(str(path), use_wandb=True, echo=False)
        log.log({"loss": 1.5}, step=3)
        log.log({"acc": 0.5})
        log.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [{k: v for k, v in r.items() if k != "ts"} for r in lines] == \
        [{"step": 3, "loss": 1.5}, {"acc": 0.5}] * 2
    assert logging_utils.silent(lambda: print("hidden") or 7)() == 7
    assert "hidden" not in capsys.readouterr().out
