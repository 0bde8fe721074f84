"""Serialized BMA engines of ursabench_tpu_torch (``profiling/export.py``,
``torch.export``) against the JAX package's (``jax.export``): the same
stacked ensemble, transferred from flax, exported, saved and loaded by both
packages, gives the same posterior-mean probabilities, within 1e-5 in fp32
and 1e-2 in bf16, on PreResNet-8 and MLP200MNIST; the loaded engine runs
without the package's code."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import models as jmodels
from ursabench_tpu.inference.engine import init_variables as jinit
from ursabench_tpu.profiling import export as jexport
from ursabench_tpu.util import tree_stack
from ursabench_tpu_torch import models as tmodels
from ursabench_tpu_torch.profiling import export as texport
from ursabench_tpu_torch.profiling import latency as L
from ursabench_tpu_torch.transfer import params_from_jax
from ursabench_tpu_torch.util import stack_state_dicts

torch.set_num_threads(1)

MEMBERS, BATCH = 3, 4
MODELS = {"PreResNet8": (32, 32, 3), "MLP200MNIST": (28, 28, 1)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    """An S=3 ensemble of ``name`` in both packages, the same weights, the
    heads scaled up so that the members' predictions spread out."""
    name = request.param
    hwc = MODELS[name]
    jm = jmodels.get_model(name).build(10)
    variables = []
    for k in range(MEMBERS):
        v = jax.tree.map(np.array, jinit(jm, jax.random.PRNGKey(k), hwc))
        head = sorted(k for k in v["params"] if k.startswith("Dense"))[-1]
        v["params"][head]["kernel"] = v["params"][head]["kernel"] * 20.0
        variables.append(v)
    states = [{k: t.clone() for k, t in params_from_jax(
        tmodels.get_model(name).build(10), v).state_dict().items()} for v in variables]
    x = np.random.default_rng(0).normal(size=(BATCH,) + hwc).astype(np.float32)
    return {
        "name": name, "jm": jm, "hwc": hwc, "x": x,
        "params": tree_stack([v["params"] for v in variables]),
        "bstats": (tree_stack([v["batch_stats"] for v in variables])
                   if "batch_stats" in variables[0] else None),
        "state": stack_state_dicts(states),
        "xt": torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
    }


@pytest.mark.parametrize("prec,tol", [("fp32", 1e-5), ("bf16", 1e-2)])
def test_exported_engine_matches_jax_export(pair, prec, tol, tmp_path):
    blob = jexport.export_bma_engine(pair["jm"], pair["params"], pair["bstats"], BATCH,
                                     pair["hwc"], prec)
    jexport.save_engine(str(tmp_path / "jax.bin"), blob)
    want = np.asarray(jexport.load_engine(str(tmp_path / "jax.bin"))(jnp.asarray(pair["x"])))

    c = pair["hwc"][2]
    ep = texport.export_bma_engine(tmodels.get_model(pair["name"]).build(10), pair["state"],
                                   BATCH, (c,) + pair["hwc"][:2], prec)
    texport.save_engine(str(tmp_path / "torch.pt2"), ep)
    got = texport.load_engine(str(tmp_path / "torch.pt2"))(pair["xt"])
    assert got.dtype == torch.float32 and got.shape == (BATCH, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_exported_engine_equals_the_eager_engine(pair, prec):
    """The exported program runs the members in a loop, as the latency
    sweep's eager "scan" engine does, and equals it on the same batch."""
    c = pair["hwc"][2]
    shape = (c,) + pair["hwc"][:2]
    module = tmodels.get_model(pair["name"]).build(10)
    ep = texport.export_bma_engine(module, pair["state"], BATCH, shape, prec)
    eager, _ = L.build_engine(module, pair["state"], BATCH, shape, prec, "scan")
    torch.testing.assert_close(ep.module()(pair["xt"]), eager(pair["xt"]), rtol=0, atol=0)


_LOAD_BLOCKED = """
import sys
sys.modules["ursabench_tpu_torch"] = None
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)  # the summation order of this process's calls
probs = torch.export.load(sys.argv[1]).module()(torch.load(sys.argv[2]))
torch.save(probs, sys.argv[3])
"""


def test_loaded_engine_runs_without_the_package(pair, tmp_path):
    c = pair["hwc"][2]
    ep = texport.export_bma_engine(tmodels.get_model(pair["name"]).build(10), pair["state"],
                                   BATCH, (c,) + pair["hwc"][:2])
    texport.save_engine(str(tmp_path / "e.pt2"), ep)
    torch.save(pair["xt"], tmp_path / "x.pt")
    out = subprocess.run([sys.executable, "-c", _LOAD_BLOCKED, str(tmp_path / "e.pt2"),
                          str(tmp_path / "x.pt"), str(tmp_path / "p.pt")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    torch.testing.assert_close(torch.load(tmp_path / "p.pt"), ep.module()(pair["xt"]),
                               rtol=0, atol=0)


def test_export_covers_fp32_and_bf16_only():
    state = stack_state_dicts([tmodels.get_model("MLP200MNIST").build(10).state_dict()])
    with pytest.raises(ValueError, match="fp32 and bf16"):
        texport.export_bma_engine(tmodels.get_model("MLP200MNIST").build(10), state, 2,
                                  (1, 28, 28), "int8")
