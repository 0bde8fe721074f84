"""Weight-space subspaces: random, covariance (FIFO deviations), PCA and
frequent directions, over flat parameter vectors on the device.

Counterpart of ``ursabench_tpu/inference/subspaces.py``. The PCA never
forms a P-sided SVD: for the (K, P) deviation matrix A with K <= max_rank,
the K x K Gram matrix A A^T is eigendecomposed and the right factor
recovered as U^T A (``_gram_svd``), equal to a truncated SVD up to the sign
of each component. ``minka_log_evidence`` (the ``"mle"`` rank) runs on the
host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..util import make_generator
from .base import resolve_device


class Subspace:
    subclasses: dict = {}

    @classmethod
    def register_subclass(cls, name):
        def deco(sub):
            cls.subclasses[name] = sub
            return sub

        return deco

    @classmethod
    def create(cls, subspace_type, **kwargs):
        if subspace_type not in cls.subclasses:
            raise ValueError(f"Bad subspaces type {subspace_type}")
        return cls.subclasses[subspace_type](**kwargs)

    def collect_vector(self, vector: torch.Tensor):
        raise NotImplementedError

    def get_space(self) -> torch.Tensor:
        raise NotImplementedError


@Subspace.register_subclass("random")
class RandomSpace(Subspace):
    """A dense Gaussian (rank, P) projection, independent of the data, on
    ``device`` (CUDA when None)."""

    def __init__(self, num_parameters, rank=20, method="dense", seed=0, device=None):
        if method != "dense":
            raise NotImplementedError("only the dense random subspace exists")
        device = resolve_device(device)
        self.num_parameters = num_parameters
        self.rank = rank
        self.subspace = torch.randn(rank, num_parameters, device=device,
                                    generator=make_generator(device, seed, "random_space"))

    def collect_vector(self, vector):
        pass

    def get_space(self):
        return self.subspace


@Subspace.register_subclass("covariance")
class CovarianceSpace(Subspace):
    """The last ``max_rank`` deviation vectors, first in first out."""

    def __init__(self, num_parameters, max_rank=20):
        self.num_parameters = num_parameters
        self.max_rank = max_rank
        self.rank = 0
        self.cov_mat_sqrt = None  # (rank, P) once a vector arrives

    def collect_vector(self, vector):
        row = vector.reshape(1, -1).to(torch.float32)
        if self.cov_mat_sqrt is None:
            self.cov_mat_sqrt = row.clone()
        else:
            kept = self.cov_mat_sqrt[1:] if self.rank + 1 > self.max_rank else self.cov_mat_sqrt
            self.cov_mat_sqrt = torch.cat([kept, row])
        self.rank = min(self.rank + 1, self.max_rank)

    def get_space(self):
        return self.cov_mat_sqrt / (self.cov_mat_sqrt.shape[0] - 1) ** 0.5


def _gram_svd(a: torch.Tensor, k: int):
    """Top-k singular values and right factor (rows s_i * v_i^T) of a (K, P)
    matrix through its K x K Gram matrix."""
    w, u = torch.linalg.eigh(a @ a.T)  # ascending
    w, u = w.flip(0), u.flip(1)
    s = torch.sqrt(torch.clamp(w, min=0.0))
    return s[:k], (u.T @ a)[:k]


def minka_log_evidence(spectrum, rank, n_features, n_samples):
    """Minka's PCA marginal log-evidence for a tested rank ("Automatic
    choice of dimensionality for PCA", NIPS 2000, eqs. 27-31) with the
    sklearn-0.20 ``_assess_dimension_`` conventions: residual variance v
    from the tail of the spectrum (v = 1, pv = 0 when rank == n_features),
    and pp with the (m + rank + 1)/2 factor of that version. Degenerate
    spectra give nan, which ``nanargmax`` skips. Host numpy, float64."""
    from scipy.special import gammaln

    spectrum = np.asarray(spectrum, np.float64)
    k = int(rank)
    n = float(n_samples)
    d = float(n_features)

    with np.errstate(divide="ignore", invalid="ignore"):
        i = np.arange(1, k + 1, dtype=np.float64)
        pu = -k * np.log(2.0) + np.sum(
            gammaln((d - i + 1.0) / 2.0) - np.log(np.pi) * (d - i + 1.0) / 2.0
        )
        pl = -n / 2.0 * np.sum(np.log(spectrum[:k]))
        if k == n_features:
            v, pv = 1.0, 0.0
        else:
            v = np.sum(spectrum[k:]) / (d - k)
            pv = -np.log(v) * n * (d - k) / 2.0
        m = d * k - k * (k + 1.0) / 2.0
        pp = np.log(2.0 * np.pi) * (m + k + 1.0) / 2.0

        spectrum_tail = spectrum.copy()
        spectrum_tail[k:n_features] = v
        pa = 0.0
        for a in range(k):
            for b in range(a + 1, len(spectrum)):
                pa += np.log(
                    (spectrum[a] - spectrum[b])
                    * (1.0 / spectrum_tail[b] - 1.0 / spectrum_tail[a])
                ) + np.log(n)

        return float(pu + pl + pv + pp - pa / 2.0 - k * np.log(n) / 2.0)


@Subspace.register_subclass("pca")
class PCASpace(CovarianceSpace):
    """The top ``pca_rank`` principal directions of the deviations, or the
    rank Minka's evidence picks with ``pca_rank="mle"``."""

    def __init__(self, num_parameters, pca_rank=20, max_rank=20):
        super().__init__(num_parameters, max_rank=max_rank)
        if pca_rank != "mle" and not (isinstance(pca_rank, int) and 1 <= pca_rank <= max_rank):
            raise ValueError(f"pca_rank must be 'mle' or in [1, {max_rank}], got {pca_rank}")
        self.pca_rank = pca_rank

    def get_space(self):
        a = self.cov_mat_sqrt / (max(1, self.rank - 1)) ** 0.5
        if self.pca_rank == "mle":
            s, sv = _gram_svd(a, self.rank)
            eigs = s.double().cpu().numpy() ** 2.0
            n_rows, n_cols = a.shape  # (K deviation vectors, P parameters)
            n_feat, n_samp = min(n_rows, n_cols), max(n_rows, n_cols)
            ll = np.array([minka_log_evidence(eigs, r, n_feat, n_samp)
                           for r in range(len(eigs))])
            ranks = np.arange(len(eigs), dtype=np.float64)
            correction = 0.5 * (n_cols * ranks - ranks * (ranks + 1.0) / 2.0) * np.log(n_rows)
            self.ll = ll
            self.corrected_ll = ll - correction
            # rank 0 would be an empty subspace: at least 1
            self.pca_rank = max(1, int(np.nanargmax(self.corrected_ll)))
            return sv[: self.pca_rank]
        _, sv = _gram_svd(a, max(1, min(self.pca_rank, self.rank)))
        return sv


@Subspace.register_subclass("freq_dir")
class FreqDirSpace(CovarianceSpace):
    """A frequent-directions sketch of at most 2 * max_rank rows."""

    def __init__(self, num_parameters, max_rank=20):
        super().__init__(num_parameters, max_rank=max_rank)
        self.num_models = 0
        self.delta = 0.0
        self.normalized = False

    def collect_vector(self, vector):
        sketch = self.cov_mat_sqrt
        if sketch is not None and sketch.shape[0] >= 2 * self.max_rank:
            s, sv = _gram_svd(sketch, min(sketch.shape))
            if s.shape[0] >= self.max_rank:
                current_delta = s[self.max_rank - 1] ** 2
                self.delta += float(current_delta)
                s_shrunk = torch.sqrt(torch.clamp(s[: self.max_rank - 1] ** 2 - current_delta,
                                                  min=0.0))
                v = sv[: self.max_rank - 1] / torch.clamp(s[: self.max_rank - 1, None],
                                                          min=1e-30)
                sketch = s_shrunk[:, None] * v
            else:
                sketch = sv
        row = vector.reshape(1, -1).to(torch.float32)
        self.cov_mat_sqrt = row.clone() if sketch is None else torch.cat([sketch, row])
        self.rank = self.cov_mat_sqrt.shape[0]
        self.num_models += 1
        self.normalized = False

    def get_space(self):
        if not self.normalized:
            _, self.cov_mat_sqrt = _gram_svd(self.cov_mat_sqrt, min(self.cov_mat_sqrt.shape))
            self.normalized = True
        curr = min(self.rank, self.max_rank)
        return self.cov_mat_sqrt[:curr] / max(1, self.num_models - 1) ** 0.5


class SubspaceModel:
    """theta (rank,) -> the full weight vector mean + cov_factor^T theta."""

    def __init__(self, mean: torch.Tensor, cov_factor: torch.Tensor):
        self.mean = mean
        self.cov_factor = cov_factor
        self.rank = cov_factor.shape[0]

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return self.mean + self.cov_factor.T @ t
