"""The 1x1-conv kernels of ursabench_tpu_torch (K3a ``conv1x1_mm``, K3b
``conv1x1_wgrad``) against the TPU kernels they replace, run on the CPU as
the JAX package's own tests run Pallas (``pltpu.force_tpu_interpret_mode``),
and against PyTorch's own 1x1 convolution and its weight gradient. On CPU
tensors the wrappers run their plain versions, so these tests pin the
arithmetic the CUDA kernels are held to on the card (``chip_smoke.py``
checks the kernels against the same plain versions and against cuDNN on
TVResNet-50's own layer).

Tolerance: one bf16 ulp of the expected value, plus the bound on a float32
sum's error that a different order of the same terms can bring. Every
product of two bf16 numbers is exact in float32, so two results differ only
by their float32 sums' order, at most L * 2**-24 * sum |terms| for L terms,
and then by the one rounding to bf16 (one ulp). The second term matters
only where the terms cancel to near zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from benchmarks import rn50_conv1x1_pallas_probe as probe
from ursabench_tpu_torch.kernels import conv1x1 as C

torch.set_num_threads(1)


def _bf16(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |t| (8 significant bits)."""
    a = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _within_one_ulp(got: torch.Tensor, want: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> None:
    """``got`` and ``want`` are bf16(a @ b) summed in two orders."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    order = a.shape[1] * 2.0 ** -24 * (a.float().abs() @ b.float().abs())
    bound = _ulp(want) + order
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.parametrize("k,n", [(256, 64), (64, 256)])
def test_plain_versions_match_pallas_in_interpret_mode(k, n):
    rng = np.random.default_rng(k + n)
    m, tm = 512, 128
    x, w, g = _bf16(rng, (m, k)), _bf16(rng, (k, n)), _bf16(rng, (m, n))
    with pltpu.force_tpu_interpret_mode():
        want_mm = np.asarray(probe.pallas_mm(_jax(x), _jax(w), tm=tm).astype(jnp.float32))
        want_wg = np.asarray(probe.pallas_wgrad(_jax(x), _jax(g), tm=tm).astype(jnp.float32))
    _within_one_ulp(C.conv1x1_mm(x, w), torch.from_numpy(want_mm.copy()).to(torch.bfloat16),
                    x, w)
    _within_one_ulp(C.conv1x1_wgrad(x, g), torch.from_numpy(want_wg.copy()).to(torch.bfloat16),
                    x.T, g)


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_versions_are_a_1x1_conv_and_its_weight_gradient(stride):
    """On NHWC activations flattened to rows (the stride-2 conv on the
    top-left tap), K3a is ``F.conv2d`` and K3b is
    ``torch.nn.grad.conv2d_weight``, both in float32 and rounded once."""
    rng = np.random.default_rng(stride)
    nb, h, cin, cout = 2, 8, 64, 32
    x = _bf16(rng, (nb, cin, h, h))
    w = _bf16(rng, (cout, cin, 1, 1))
    ho = h // stride
    g = _bf16(rng, (nb, cout, ho, ho))
    rows = x[:, :, ::stride, ::stride].permute(0, 2, 3, 1).reshape(-1, cin).contiguous()
    g_rows = g.permute(0, 2, 3, 1).reshape(-1, cout).contiguous()

    y = C.conv1x1_mm(rows, w.reshape(cout, cin).T.contiguous())
    want = F.conv2d(x.float(), w.float(), stride=stride).to(torch.bfloat16)
    w_kn = w.reshape(cout, cin).T
    _within_one_ulp(y, want.permute(0, 2, 3, 1).reshape(-1, cout), rows, w_kn)

    dw = C.conv1x1_wgrad(rows, g_rows)
    want_w = torch.nn.grad.conv2d_weight(x.float(), w.shape, g.float(), stride=stride)
    _within_one_ulp(dw, want_w.to(torch.bfloat16).reshape(cout, cin).T, rows.T, g_rows)


def test_ragged_rows_and_cpu_routing():
    """Any M: the CUDA kernels mask the last tile. CPU tensors take the
    plain versions and launch nothing."""
    rng = np.random.default_rng(0)
    x, w, g = _bf16(rng, (1000, 64)), _bf16(rng, (64, 48)), _bf16(rng, (1000, 48))
    before = (C.conv1x1_mm.launches, C.conv1x1_wgrad.launches)
    assert torch.equal(C.conv1x1_mm(x, w), C.conv1x1_mm_reference(x, w))
    assert torch.equal(C.conv1x1_wgrad(x, g), C.conv1x1_wgrad_reference(x, g))
    assert C.conv1x1_mm(x, w).shape == (1000, 48) and C.conv1x1_wgrad(x, g).shape == (64, 48)
    assert (C.conv1x1_mm.launches, C.conv1x1_wgrad.launches) == before


def _bad(case):
    """An operand pair that either wrapper must refuse."""
    x, w = torch.zeros(64, 32, dtype=torch.bfloat16), torch.zeros(32, 16, dtype=torch.bfloat16)
    if case == "float32":
        x = x.float()
    elif case == "float16":
        w = w.half()
    elif case == "k_not_16":
        x, w = torch.zeros(64, 24, dtype=torch.bfloat16), torch.zeros(24, 16, dtype=torch.bfloat16)
    elif case == "n_not_16":
        w = torch.zeros(32, 8, dtype=torch.bfloat16)
    elif case == "mismatch":
        w = torch.zeros(48, 16, dtype=torch.bfloat16)
    elif case == "three_d":
        x = x.reshape(2, 32, 32)
    elif case == "strided":
        x = torch.zeros(32, 64, dtype=torch.bfloat16).T
    elif case == "empty_m":
        x = torch.zeros(0, 32, dtype=torch.bfloat16)
    elif case == "meta_device":
        x, w = x.to("meta"), w.to("meta")
    return x, w


@pytest.mark.parametrize("case", ["float32", "float16", "k_not_16", "n_not_16", "mismatch",
                                  "three_d", "strided", "empty_m", "meta_device"])
def test_wrappers_reject_bad_arguments(case):
    x, w = _bad(case)
    before = (C.conv1x1_mm.launches, C.conv1x1_wgrad.launches)
    with pytest.raises(ValueError):
        C.conv1x1_mm(x, w)
    # the gradient pairs x (M, K) with g (M, N): the same faults, with g
    # sharing x's rows
    g = torch.zeros(x.shape[0] + (8 if case == "mismatch" else 0),
                    *w.shape[1:], dtype=w.dtype, device=w.device)
    if case == "three_d":
        g = torch.zeros(2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        C.conv1x1_wgrad(x, g)
    assert (C.conv1x1_mm.launches, C.conv1x1_wgrad.launches) == before


@pytest.mark.parametrize("m,k,n", [(401408, 256, 64), (1000, 256, 64), (6272, 512, 2048),
                                   (100352, 256, 512), (1, 16, 16), (33, 64, 64)])
def test_wgrad_splits_cover_m_without_empty_chunks(m, k, n):
    """The kernel cuts M into ``splits`` chunks of ``roundup32(ceil(m /
    splits))`` rows: every chunk is non-empty, together they cover M, and
    the tiles times the splits give about two blocks an SM on 132 SMs."""
    s = C.wgrad_splits(m, k, n, 132)
    chunk = -(-(-(-m // s)) // 32) * 32
    assert 1 <= s and (s - 1) * chunk < m <= s * chunk
    tiles = -(-k // 128) * -(-n // 64)
    assert s * tiles <= 2 * 132 + tiles or chunk == 32


def test_probe_gates_pass_on_the_plain_versions_and_catch_a_wrong_kernel(monkeypatch):
    """The conv1x1 probe's gates (the JAX probe's, :127-138) accept the
    plain versions on CPU tensors and refuse a kernel that is off. They are
    coarse (the weight gradient is compared after dividing by 4096, with an
    absolute 0.5): the tight checks are this file's and ``chip_smoke.py``'s."""
    from ursabench_tpu_torch.profiling import conv1x1_probe as P

    gen = torch.Generator().manual_seed(0)
    rows = 2 * P.TM
    big = torch.randn(rows, P.K, generator=gen).to(torch.bfloat16)
    small = torch.randn(rows, P.N, generator=gen).to(torch.bfloat16)
    w = torch.randn(P.K, P.N, generator=gen).to(torch.bfloat16)
    P.gates(big, small, w)
    with monkeypatch.context() as patch:
        patch.setattr(P, "conv1x1_mm", lambda x, w: C.conv1x1_mm(x, w) * 1.1)
        with pytest.raises(AssertionError):
            P.gates(big, small, w)
    monkeypatch.setattr(P, "conv1x1_wgrad", lambda x, g: C.conv1x1_wgrad(x, g) + P.TM)
    with pytest.raises(AssertionError):
        P.gates(big, small, w)
    with pytest.raises(ValueError, match="CUDA"):
        P.run("cpu")
