"""The int8 weight-streaming kernels of ursabench_tpu_torch (K2, K4a-K4d)
against the TPU kernels they replace, run on the CPU as the JAX package's
own tests run them: ``int8_matvec`` with ``interpret=True``, the probes
under ``pltpu.force_tpu_interpret_mode()``. On CPU tensors the port's
wrappers run their plain versions, so these tests pin the arithmetic the
CUDA kernels are held to on the card (``chip_smoke.py`` checks the kernels
bit for bit against the same plain versions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks import pallas_matvec_probe as probe1
from benchmarks import pallas_matvec_probe2 as probe2
from benchmarks.pallas_int8 import int8_matvec as j_int8_matvec
from ursabench_tpu_torch.kernels import conv1x1 as C1
from ursabench_tpu_torch.kernels import int8_gemv as G
from ursabench_tpu_torch.kernels import stream_probe as SP

torch.set_num_threads(1)


def _quantized(n, k, seed):
    """w (n, k) normal / sqrt(k), its per-row int8 quantization as the JAX
    test builds it (tests/test_pallas.py:70-72), and x (k,) normal."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    x = rng.normal(size=k).astype(np.float32)
    wj = jnp.asarray(w)
    scales = jnp.maximum(jnp.max(jnp.abs(wj), axis=1), 1e-12) / 127.0
    q8 = jnp.clip(jnp.round(wj / scales[:, None]), -127, 127).astype(jnp.int8)
    return w, np.array(q8), np.array(scales, np.float32), x


def _jax_matvec(name, q8, scales, x, tile_n):
    args = (jnp.asarray(q8), jnp.asarray(scales), jnp.asarray(x))
    if name == "int8_matvec":
        return np.asarray(j_int8_matvec(*args, tile_n=tile_n, interpret=True))
    with pltpu.force_tpu_interpret_mode():
        if name == "matvec_row_mxu":
            return np.asarray(probe1.matvec_row(*args, tile_n=tile_n, kernel="mxu"))
        if name == "matvec_row_vpu":
            return np.asarray(probe1.matvec_row(*args, tile_n=tile_n, kernel="vpu"))
        return np.asarray(probe2.vpu_matvec(*args, tile_n=tile_n))


# TPU function -> the port's variant (K2, K4b mxu, K4b vpu, K4d)
PAIRS = [("int8_matvec", "mma"), ("matvec_row_mxu", "mma_row"),
         ("matvec_row_vpu", "dp4a"), ("vpu_matvec", "dp4a")]


@pytest.mark.parametrize("shape,tile_n", [((512, 256), 128), ((1024, 256), 512)])
@pytest.mark.parametrize("jax_name,variant", PAIRS)
def test_int8_matvec_bit_equal_to_jax(jax_name, variant, shape, tile_n):
    """The integer dot is exact in both, and both round the epilogue in the
    same order (f32(acc) * scale, then * x_scale), so the results are equal
    bit for bit."""
    _, q8, scales, x = _quantized(*shape, seed=shape[0] + tile_n)
    want = _jax_matvec(jax_name, q8, scales, x, tile_n)
    got = G.int8_matvec(torch.from_numpy(q8), torch.from_numpy(scales),
                        torch.from_numpy(x), variant).numpy()
    assert got.dtype == np.float32 and got.shape == (shape[0],)
    np.testing.assert_array_equal(got, want)


def test_activation_quantization_matches_jax_exactly():
    """pallas_int8.py:67-69: abs-max scale, round half to even, clip."""
    rng = np.random.default_rng(5)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0], np.float32)
    for x in (rng.normal(size=384).astype(np.float32), ties,
              np.zeros(8, np.float32)):
        xj = jnp.asarray(x)
        x_scale = jnp.maximum(jnp.max(jnp.abs(xj)), 1e-12) / 127.0
        xq = jnp.clip(jnp.round(xj / x_scale), -127, 127).astype(jnp.int8)
        tq, ts = G.quantize_activation(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.shape == (1,) and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(xq))
        assert ts.numpy()[0] == np.float32(x_scale)
    tq, _ = G.quantize_activation(torch.from_numpy(ties))
    assert tq.tolist() == [127, 0, 2, 2, 0, -2, 126, -127]


@pytest.mark.parametrize("variant", G.VARIANTS)
def test_int8_matvec_within_quantization_envelope(variant):
    """As tests/test_pallas.py:87-91: within 5% of the float matvec, and the
    plain version equals an int64 numpy reference."""
    w, q8, scales, x = _quantized(512, 256, seed=1)
    y = G.int8_matvec(torch.from_numpy(q8), torch.from_numpy(scales),
                      torch.from_numpy(x), variant).numpy()
    full = w.astype(np.float64) @ x.astype(np.float64)
    err = np.abs(y - full) / (np.abs(full).mean() + 1e-12)
    assert err.max() < 0.05
    xq, xs = G.quantize_activation(torch.from_numpy(x))
    acc = q8.astype(np.int64) @ xq.numpy().astype(np.int64)
    ref = (acc.astype(np.float32) * scales) * xs.numpy()[0]
    np.testing.assert_array_equal(y, ref)


def test_gemv_reference_exact_at_the_accumulator_bound():
    """|acc| up to K * 127 * 127 stays exact through the float64 product:
    every weight and activation at +-127, K = 6144."""
    k = 6144
    w = torch.full((32, k), 127, dtype=torch.int8)
    w[1::2] = -127
    xq = torch.full((k,), 127, dtype=torch.int8)
    y = G.int8_gemv(w, torch.ones(32), xq, torch.ones(1))
    want = float(np.float32(k * 127 * 127))
    assert y[0].item() == want and y[1].item() == -want


@pytest.mark.parametrize("shape,tile_n", [((512, 256), 128), ((1024, 384), 512)])
def test_stream_probe_matches_both_jax_probes(shape, tile_n):
    """K4a's (G, 1) output equals the port's; K4c writes only column 0 of its
    (G, 128) block and leaves the rest unset (NaN under the interpreter), so
    only column 0 is compared; the port writes zeros there. tile_sum is the
    int32 sum of every byte of each tile."""
    n, k = shape
    rng = np.random.default_rng(n + k)
    q8 = rng.integers(-127, 128, size=shape).astype(np.int8)
    qj = jnp.asarray(q8)
    with pltpu.force_tpu_interpret_mode():
        want1 = np.asarray(probe1.dma_only(qj, jnp.int32(7), tile_n=tile_n))
        want2 = np.asarray(probe2.dma_only(qj, jnp.int32(7), tile_n=tile_n))
    qt = torch.from_numpy(q8)
    out1, sums1 = SP.stream_probe(qt, 7, tile_n=tile_n, out_cols=1)
    out2, sums2 = SP.stream_probe(qt, 7, tile_n=tile_n, out_cols=128)
    g = n // tile_n
    assert out1.shape == (g, 1) and out2.shape == (g, 128)
    np.testing.assert_array_equal(out1.numpy(), want1)
    np.testing.assert_array_equal(out2.numpy()[:, 0], want2[:, 0])
    assert not out2[:, 1:].any()
    tiles = q8.reshape(g, tile_n, k).astype(np.int64)
    for sums in (sums1, sums2):
        assert sums.dtype == torch.int32
        np.testing.assert_array_equal(sums.numpy(), tiles.sum(axis=(1, 2)))


def _gemv_args(n=64, k=128):
    return (torch.zeros(n, k, dtype=torch.int8), torch.ones(n),
            torch.zeros(k, dtype=torch.int8), torch.ones(1))


@pytest.mark.parametrize("case", [
    "k_not_multiple", "k_too_large", "w_float", "scales_shape", "xq_float",
    "x_scale_shape", "noncontiguous", "variant", "meta_device", "mixed_device"])
def test_gemv_wrapper_raises_on_bad_inputs(case):
    w, s, xq, xs = _gemv_args()
    variant = "mma"
    if case == "k_not_multiple":
        w, xq = torch.zeros(64, 96, dtype=torch.int8), torch.zeros(96, dtype=torch.int8)
    elif case == "k_too_large":
        w = torch.zeros(1, G.MAX_K + 64, dtype=torch.int8)
        s, xq = torch.ones(1), torch.zeros(G.MAX_K + 64, dtype=torch.int8)
    elif case == "w_float":
        w = w.float()
    elif case == "scales_shape":
        s = torch.ones(64, 1)
    elif case == "xq_float":
        xq = xq.float()
    elif case == "x_scale_shape":
        xs = torch.ones(())
    elif case == "noncontiguous":
        w = torch.zeros(128, 64, dtype=torch.int8).t()
    elif case == "variant":
        variant = "wgmma"
    elif case == "meta_device":
        w, s, xq, xs = (t.to("meta") for t in (w, s, xq, xs))
    elif case == "mixed_device":
        xs = xs.to("meta")
    before = dict(G.int8_gemv.launches)
    with pytest.raises(ValueError):
        G.int8_gemv(w, s, xq, xs, variant)
    assert G.int8_gemv.launches == before


@pytest.mark.parametrize("case", ["ragged_n", "small_tile", "narrow_k", "k_align",
                                  "float", "out_cols", "tile_too_big", "meta_device"])
def test_stream_probe_wrapper_raises_on_bad_inputs(case):
    w, tile_n, cols = torch.zeros(1024, 256, dtype=torch.int8), 512, 1
    if case == "ragged_n":
        w = torch.zeros(1000, 256, dtype=torch.int8)
    elif case == "small_tile":
        w, tile_n = torch.zeros(64, 256, dtype=torch.int8), 16
    elif case == "narrow_k":
        w = torch.zeros(1024, 64, dtype=torch.int8)
    elif case == "k_align":
        w = torch.zeros(1024, 136, dtype=torch.int8)
    elif case == "float":
        w = w.float()
    elif case == "out_cols":
        cols = 64
    elif case == "tile_too_big":
        w, tile_n = torch.zeros(4096, 8192, dtype=torch.int8), 4096
    elif case == "meta_device":
        w = w.to("meta")
    before = dict(SP.stream_probe.launches)
    with pytest.raises(ValueError):
        SP.stream_probe(w, 0, tile_n=tile_n, out_cols=cols)
    assert SP.stream_probe.launches == before


def test_ragged_rows_are_accepted():
    """Any N: the kernel masks the rows past the last block of 16."""
    _, q8, scales, x = _quantized(1000, 384, seed=2)
    y = G.int8_matvec(torch.from_numpy(q8), torch.from_numpy(scales),
                      torch.from_numpy(x), "dp4a")
    assert y.shape == (1000,) and torch.isfinite(y).all()


@pytest.mark.parametrize("module,tpu", [
    (G, ["benchmarks/pallas_int8.py::int8_matvec",
         "benchmarks/pallas_matvec_probe.py::matvec_row",
         "benchmarks/pallas_matvec_probe2.py::vpu_matvec"]),
    (SP, ["benchmarks/pallas_matvec_probe.py::dma_only",
          "benchmarks/pallas_matvec_probe2.py::dma_only"]),
    (C1, ["benchmarks/rn50_conv1x1_pallas_probe.py",
          "pallas_mm", "pallas_wgrad"]),
])
def test_kernel_sources_name_what_they_replace(module, tpu):
    from ursabench_tpu_torch.kernels import build

    src = module.SOURCE.read_text()
    for name in tpu:
        assert name in src
    assert f'extern "C" int {module.SOURCE.stem}(' in src
    assert "What bounds it" in src
    assert module.SOURCE.parent == build.CSRC
    assert build.library_path(module.SOURCE).parent == build.BUILD_DIR
    assert build.library_path(module.SOURCE).name.startswith(f"lib{module.SOURCE.stem}-")
