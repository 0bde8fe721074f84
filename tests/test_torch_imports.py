"""ursabench_tpu_torch and chip_smoke.py import with JAX and flax blocked:
the machine with the GPU has no JAX."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ursabench_tpu_torch"

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import importlib, pkgutil
import ursabench_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ursabench_tpu_torch.__path__,
                                              "ursabench_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "jax" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_reference_package_imports_in_port_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "flax", "optax", "ursabench_tpu"}, path


_RUN_BLOCKED = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
target = sys.argv[1]
sys.argv = sys.argv[1:]
if target.endswith(".py"):
    runpy.run_path(target, run_name="__main__")
else:
    runpy.run_module(target, run_name="__main__", alter_sys=True)
"""


@pytest.mark.parametrize("target", [
    "ursabench_tpu_torch.profiling.latency",
    "ursabench_tpu_torch.profiling.int8_microbench",
    "ursabench_tpu_torch.profiling.conv1x1_probe",
    "ursabench_tpu_torch.profiling.imagenet_train",
    "ursabench_tpu_torch.profiling.step_profile",
    "ursabench_tpu_torch.profiling.k1_regression",
    "ursabench_tpu_torch.profiling.mesh_check",
    "chip_smoke.py",
])
def test_gpu_entry_points_refuse_without_a_gpu(target):
    """The measurement entry points import no JAX, and without a CUDA device
    they exit non-zero and print no result: no CPU run stands in for the
    card."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", _RUN_BLOCKED, target], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert "CUDA" in out.stdout + out.stderr or "cuda" in out.stdout + out.stderr
    assert '"ok": true' not in out.stdout and '"kernels"' not in out.stdout


NEW_MODULES = ["ursabench_tpu_torch.models.wideresnet", "ursabench_tpu_torch.models.mlp",
               "ursabench_tpu_torch.inference.sgd_map", "ursabench_tpu_torch.inference.swa",
               "ursabench_tpu_torch.inference.swag", "ursabench_tpu_torch.inference.subspaces",
               "ursabench_tpu_torch.inference.vectorized", "ursabench_tpu_torch.hyperopt",
               "ursabench_tpu_torch.hyperopt.search", "ursabench_tpu_torch.hyperopt.gp",
               "ursabench_tpu_torch.hyperopt.bayesopt", "ursabench_tpu_torch.hyperopt.vectorized",
               "ursabench_tpu_torch.run_hypopt", "ursabench_tpu_torch.models.lenet",
               "ursabench_tpu_torch.models.resnet_cifar", "ursabench_tpu_torch.inference.hmc",
               "ursabench_tpu_torch.inference.pca_subspace", "ursabench_tpu_torch.ops.ess",
               "ursabench_tpu_torch.utils_checkpoint", "ursabench_tpu_torch.logging_utils",
               "ursabench_tpu_torch.time_script", "ursabench_tpu_torch.parallel",
               "ursabench_tpu_torch.parallel.distributed", "ursabench_tpu_torch.parallel.mesh"]


def test_sampler_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "import importlib\n"
            f"for name in {NEW_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'ursabench_tpu')"
            " and sys.modules[m] is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_parallel_imports_start_no_process_group():
    """``parallel/`` imports with JAX and the JAX package blocked, and
    importing it (or the runner) joins no process group and reads no
    launcher variables: ``initialize()`` does that when called."""
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "sys.modules['ursabench_tpu'] = None\n"
            "import torch.distributed as dist\n"
            "import ursabench_tpu_torch.parallel as p, ursabench_tpu_torch.experiment\n"
            "assert not dist.is_initialized()\n"
            "from ursabench_tpu_torch.parallel.distributed import make_layout\n"
            "assert p.auto_mesh(4) is None and make_layout(8) == (2, 4)\n"
            "assert p.make_mesh().shape == {'chain': 1, 'data': 1}\n"
            "print(sorted(p.__all__))\n")
    env = {**os.environ, "WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(sorted(["Mesh", "make_mesh", "shard_ensemble_eval",
                                             "auto_mesh", "chain_mesh", "initialize"]))


@pytest.mark.parametrize("name", ["SGHMC", "SGLD", "cSGHMC", "cSGLD", "SGD", "DeepEnsemble",
                                  "MCdropout", "SWA", "SWAG", "MethodSweep", "HMC",
                                  "PCASubspaceSampler"])
def test_samplers_default_to_cuda_and_refuse_without_it(name):
    import torch

    from ursabench_tpu_torch import data, inference, models

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    splits, c = data.loaders("MNIST", None, batch_size=8, use_validation=False,
                             synthetic_n_train=16, synthetic_n_test=8)
    hyp = ([{"lr": 0.01, "prior_std": 1.0, "num_samples": 1, "burn_in_epochs": 0}]
           if name == "MethodSweep" else None)  # a sweep takes a list of configs
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(inference, name)(hyp, model=models.get_model("MLP200MNIST_dropout").build(c),
                                 train=splits["train"])
