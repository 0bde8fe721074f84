"""The weight-space subspaces of ursabench_tpu_torch against the JAX
package's, fed the same deviation vectors: covariance (FIFO), PCA through
the Gram matrix, frequent directions (with its shrink), Minka's evidence
and the "mle" rank, and SubspaceModel. Principal directions agree up to
the sign of each component."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu.inference import subspaces as J
from ursabench_tpu_torch.inference import subspaces as T

P = 500


def _feed(kind, vectors, **kw):
    js = J.Subspace.create(kind, num_parameters=P, **kw)
    ts = T.Subspace.create(kind, num_parameters=P, **kw)
    for v in vectors:
        js.collect_vector(jnp.asarray(v))
        ts.collect_vector(torch.from_numpy(v))
    return js, ts


def _vectors(k, seed=0, scales=None):
    rng = np.random.default_rng(seed)
    scales = scales if scales is not None else np.linspace(3.0, 0.5, k)
    basis = rng.normal(size=(k, P))
    return [(rng.normal(size=k) * scales) @ basis + 0.01 * rng.normal(size=P)
            for _ in range(k + 2)]


def _same_up_to_sign(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    for i in range(got.shape[0]):
        sign = np.sign(got[i] @ want[i])
        np.testing.assert_allclose(got[i], sign * want[i], rtol=rtol,
                                   atol=rtol * np.abs(want[i]).max(), err_msg=str(i))


def test_covariance_space_is_fifo():
    vs = [v.astype(np.float32) for v in _vectors(4)]
    js, ts = _feed("covariance", vs, max_rank=4)
    assert ts.rank == js.rank == 4
    np.testing.assert_allclose(ts.cov_mat_sqrt.numpy(), np.asarray(js.cov_mat_sqrt), rtol=1e-6)
    np.testing.assert_allclose(ts.get_space().numpy(), np.asarray(js.get_space()), rtol=1e-6)
    np.testing.assert_allclose(ts.cov_mat_sqrt[0].numpy(), vs[2], rtol=1e-6)  # 2 dropped


@pytest.mark.parametrize("pca_rank", [1, 3])
def test_pca_space_matches_jax(pca_rank):
    vs = [v.astype(np.float32) for v in _vectors(5, seed=1)]
    js, ts = _feed("pca", vs, max_rank=5, pca_rank=pca_rank)
    _same_up_to_sign(ts.get_space().numpy(), js.get_space())
    # the right factor: rows s_i v_i^T of the deviation matrix's SVD
    a = np.stack(vs[-5:]).astype(np.float64) / 2.0
    _, s, vt = np.linalg.svd(a, full_matrices=False)
    _same_up_to_sign(ts.get_space().numpy(), s[:pca_rank, None] * vt[:pca_rank], rtol=1e-3)


def test_pca_mle_rank_and_evidence_match_jax():
    vs = [v.astype(np.float32) for v in _vectors(6, seed=2, scales=[5, 4, 3, 0.05, 0.04, 0.03])]
    js, ts = _feed("pca", vs, max_rank=6, pca_rank="mle")
    got, want = ts.get_space(), js.get_space()
    assert ts.pca_rank == js.pca_rank
    _same_up_to_sign(got.numpy(), want)
    # the evidence of the ranks past the gap rests on eigenvalues near
    # float32 noise, which the two eigensolvers give differently
    np.testing.assert_allclose(ts.corrected_ll[:3], js.corrected_ll[:3], rtol=1e-6)
    spectrum = np.array([4.0, 2.0, 1.0, 0.5, 0.25])
    for rank in range(5):
        assert T.minka_log_evidence(spectrum, rank, 5, 200) == pytest.approx(
            J.minka_log_evidence(spectrum, rank, 5, 200), rel=1e-12)


def test_freq_dir_space_matches_jax():
    vs = [v.astype(np.float32) for v in _vectors(4, seed=3)] * 2  # 12 > 2 * max_rank
    js, ts = _feed("freq_dir", vs, max_rank=3)
    assert ts.rank == js.rank and ts.num_models == js.num_models == 12
    assert ts.delta == pytest.approx(js.delta, rel=1e-4)
    _same_up_to_sign(ts.get_space().numpy(), js.get_space(), rtol=1e-3)


def test_random_space_and_subspace_model():
    rs = T.Subspace.create("random", num_parameters=P, rank=4, seed=1, device="cpu")
    rs.collect_vector(torch.ones(P))  # independent of the data
    assert rs.get_space().shape == (4, P)
    assert torch.equal(rs.get_space(), T.RandomSpace(P, rank=4, seed=1, device="cpu").get_space())
    with pytest.raises(ValueError):
        T.Subspace.create("nope", num_parameters=P)
    mean = np.random.default_rng(4).normal(size=P).astype(np.float32)
    factor = np.random.default_rng(5).normal(size=(4, P)).astype(np.float32)
    t = np.array([0.5, -1.0, 2.0, 0.1], np.float32)
    got = T.SubspaceModel(torch.from_numpy(mean), torch.from_numpy(factor))(torch.from_numpy(t))
    want = J.SubspaceModel(jnp.asarray(mean), jnp.asarray(factor))(jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_random_space_defaults_to_cuda():
    """RandomSpace is an entry point: without a device it takes CUDA, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.RandomSpace(P, rank=2)
