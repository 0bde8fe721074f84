"""Raw dataset readers and the deterministic synthetic fallback, in numpy.

Counterpart of ``ursabench_tpu/data/sources.py`` for the CIFAR and MNIST
families. The synthetic generator consumes its Philox streams in the same
order and with the same sha256-derived seeds, so it returns the same bytes
as the JAX package (tests/test_torch_data.py pins this). The JAX package's
on-disk synthetic cache is left out: data is generated in memory.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import pickle
import struct
from typing import Tuple

import numpy as np

# name -> (size, channels, num_classes, n_train, n_test)
DATASET_PROFILES = {
    "MNIST": (28, 1, 10, 60000, 10000),
    "FashionMNIST": (28, 1, 10, 60000, 10000),
    "KMNIST": (28, 1, 10, 60000, 10000),
    "CIFAR10": (32, 3, 10, 50000, 10000),
    "CIFAR100": (32, 3, 100, 50000, 10000),
    "SVHN": (32, 3, 10, 73257, 10000),
    "STL10": (32, 3, 10, 5000, 8000),
    "TIN": (64, 3, 200, 100000, 10000),
    "LSUN": (64, 3, 10, 10000, 1000),
    "CelebA": (64, 3, 10, 10000, 1000),
}

# datasets whose readers this package has; the others wait for the OOD and
# Decision tasks (ROADMAP.md open item 9)
SUPPORTED = ("MNIST", "FashionMNIST", "KMNIST", "CIFAR10", "CIFAR100")

# Canonical per-dataset pixel statistics in [0,1] units. The synthetic
# fallback remaps its images to these moments so the standard transforms
# standardize it as they would the real dataset.
_CANON_STATS = {
    "MNIST": ((0.1307,), (0.3081,)),
    "FashionMNIST": ((0.2860,), (0.3530,)),
    "KMNIST": ((0.1918,), (0.3483,)),
    "CIFAR10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
    "CIFAR100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
    "SVHN": ((0.4377, 0.4438, 0.4728), (0.1980, 0.2010, 0.1970)),
    "STL10": ((0.4467, 0.4398, 0.4066), (0.2242, 0.2215, 0.2239)),
    "TIN": ((0.4802, 0.4481, 0.3975), (0.2770, 0.2691, 0.2821)),
    "LSUN": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "CelebA": ((0.506, 0.426, 0.383), (0.265, 0.245, 0.241)),
}


# ---------------------------------------------------------------------------
# Binary format readers
# ---------------------------------------------------------------------------


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find(root: str, candidates) -> str | None:
    for c in candidates:
        for base in (root, os.path.join(root, "raw")):
            p = os.path.join(base, c)
            if os.path.exists(p) or os.path.exists(p + ".gz"):
                return p
    return None


def read_mnist_like(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray] | None:
    kind = "train" if train else "t10k"
    imgs = _find(root, [f"{kind}-images-idx3-ubyte", f"{kind}-images.idx3-ubyte"])
    lbls = _find(root, [f"{kind}-labels-idx1-ubyte", f"{kind}-labels.idx1-ubyte"])
    if imgs is None or lbls is None:
        return None
    x = _read_idx(imgs)[..., None]  # N,28,28,1
    y = _read_idx(lbls).astype(np.int64)
    return x, y


def read_cifar(root: str, train: bool, variant: int = 10) -> Tuple[np.ndarray, np.ndarray] | None:
    """Read the requested CIFAR variant only: a shared data directory often
    holds both cifar-10-batches-py and cifar-100-python."""
    c10 = os.path.join(root, "cifar-10-batches-py")
    c100 = os.path.join(root, "cifar-100-python")
    if variant == 100 and os.path.isdir(c100):
        files = ["train"] if train else ["test"]
        base, key = c100, b"fine_labels"
    elif variant == 10 and os.path.isdir(c10):
        files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        base, key = c10, b"labels"
    else:
        return None
    xs, ys = [], []
    for fn in files:
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[key], np.int64))
    return np.concatenate(xs), np.concatenate(ys)


# ---------------------------------------------------------------------------
# Deterministic synthetic fallback
# ---------------------------------------------------------------------------

# 'separation' is the pairwise Bayes z-score between class templates,
# 'noise' the per-pixel noise std, 'label_noise' the fraction of labels
# resampled uniformly, 'base_shift' each dataset's offset from the shared
# per-shape base image, 'field_overlap' the share of a per-shape class-field
# bank mixed into each dataset's class fields. The JAX package documents the
# calibration behind each value.
_SYNTH_DIFFICULTY_DEFAULT = {
    "separation": 3.0, "noise": 48.0, "label_noise": 0.02,
    "base_shift": 1.0, "field_overlap": 0.6,
}
_SYNTH_DIFFICULTY = {
    "MNIST": {"separation": 4.0},
    "FashionMNIST": {"separation": 4.0},
    "KMNIST": {"separation": 4.0},
    "CIFAR100": {"separation": 4.5, "label_noise": 0.04},
    "TIN": {"separation": 6.0},
    "LSUN": {"separation": 3.5},
    "CelebA": {"separation": 3.5},
}


def resolve_difficulty(name: str, difficulty: dict | None = None) -> dict:
    """Per-dataset synthetic difficulty: defaults, dataset overrides, then
    caller overrides. Unknown keys are an error."""
    d = dict(_SYNTH_DIFFICULTY_DEFAULT)
    d.update(_SYNTH_DIFFICULTY.get(name, {}))
    if difficulty:
        unknown = set(difficulty) - set(d)
        if unknown:
            raise ValueError(
                f"unknown difficulty keys {sorted(unknown)}; "
                f"valid: {sorted(d)}"
            )
        d.update(difficulty)
    return {k: float(v) for k, v in d.items()}


def _philox_from(text: str) -> np.random.Generator:
    digest = hashlib.sha256(text.encode()).digest()
    return np.random.Generator(
        np.random.Philox(int.from_bytes(digest[:4], "little") % (2 ** 31)))


def _bilinear_upsample(coarse: np.ndarray, size: int) -> np.ndarray:
    """(k, g, g, ch) -> (k, size, size, ch) separable bilinear interp."""
    g = coarse.shape[1]
    pos = np.linspace(0.0, g - 1.0, size)
    i0 = np.clip(pos.astype(np.int64), 0, g - 2)
    w = (pos - i0).astype(np.float32)
    rows = (coarse[:, i0] * (1.0 - w)[None, :, None, None]
            + coarse[:, i0 + 1] * w[None, :, None, None])
    out = (rows[:, :, i0] * (1.0 - w)[None, None, :, None]
           + rows[:, :, i0 + 1] * w[None, None, :, None])
    return out


def _smooth_symmetric_fields(rng, k: int, size: int, ch: int) -> np.ndarray:
    """Per-class unit-std smooth fields: coarse Gaussian grids (one cell per
    ~8 px) bilinearly upsampled, made symmetric along the width, then
    standardized per class."""
    g = max(4, size // 8)
    coarse = rng.normal(0.0, 1.0, size=(k, g, g, ch)).astype(np.float32)
    fields = _bilinear_upsample(coarse, size)
    fields = 0.5 * (fields + fields[:, :, ::-1, :])
    std = fields.reshape(k, -1).std(axis=1).reshape(k, 1, 1, 1)
    mean = fields.reshape(k, -1).mean(axis=1).reshape(k, 1, 1, 1)
    return (fields - mean) / np.maximum(std, 1e-6)


def _shared_class_fields(size: int, ch: int, k: int, seed: int) -> np.ndarray:
    """The per-shape class-field bank for 'field_overlap': deterministic in
    (shape, seed) only, so same-shape datasets share class j's entry."""
    r = _philox_from(f"{size}x{size}x{ch}/ursabench-synth-classbank/{seed}")
    return _smooth_symmetric_fields(r, k, size, ch)


def synthetic(
    name: str, train: bool, n: int | None = None, seed: int = 0,
    difficulty: dict | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional template + noise images, deterministic per
    (dataset, split, seed): a shared base image plus smooth per-class
    offsets sized by the 'separation' z-score, remapped to the dataset's
    canonical pixel moments, with a 'label_noise' fraction of labels
    resampled."""
    size, ch, k, n_train, n_test = DATASET_PROFILES[name]
    if n is None:
        n = n_train if train else n_test
    diff = resolve_difficulty(name, difficulty)
    digest = hashlib.sha256(f"{name}/ursabench-synth/{seed}".encode()).digest()
    root_seed = int.from_bytes(digest[:4], "little") % (2 ** 31)
    rng = np.random.Generator(np.random.Philox(root_seed))
    noise = diff["noise"]
    dim = size * size * ch
    sep_px = diff["separation"] * 2.0 * noise / np.sqrt(2.0 * dim)
    base_rng = _philox_from(f"{size}x{size}x{ch}/ursabench-synth-base/{seed}")
    base = base_rng.uniform(40, 215, size=(size, size, ch)).astype(np.float32)
    # the shift field is always drawn (base_shift only scales it), so the
    # class fields drawn next do not depend on base_shift
    shift_px = diff["base_shift"] * 2.0 * noise / np.sqrt(2.0 * dim)
    base = base + _smooth_symmetric_fields(rng, 1, size, ch)[0] * shift_px
    fields = _smooth_symmetric_fields(rng, k, size, ch)
    rho = diff["field_overlap"]
    if rho > 0:
        shared = _shared_class_fields(size, ch, k, seed)
        fields = np.sqrt(1.0 - rho * rho) * fields + rho * shared
        std = fields.reshape(k, -1).std(axis=1).reshape(k, 1, 1, 1)
        mean = fields.reshape(k, -1).mean(axis=1).reshape(k, 1, 1, 1)
        fields = (fields - mean) / np.maximum(std, 1e-6)
    templates = base[None] + fields * sep_px
    # affine remap to the canonical moments, corrected on a probe sample so
    # the moments after the [0, 255] clip hit the target
    canon = _CANON_STATS.get(name)
    noise_c = np.full((1, 1, 1, ch), noise, np.float32)
    if canon is not None:
        mean_t = 255.0 * np.asarray(canon[0], np.float32)
        std_t = 255.0 * np.asarray(canon[1], np.float32)
        mean_m = templates.mean(axis=(0, 1, 2))
        std_m = np.sqrt(templates.var(axis=(0, 1, 2)) + noise * noise)
        a = std_t / np.maximum(std_m, 1e-6)
        b = mean_t - a * mean_m
        probe_rng = np.random.Generator(np.random.Philox(root_seed + 7))
        yp = probe_rng.integers(0, k, size=512)
        xp = (templates[yp]
              + probe_rng.standard_normal(
                  (512, size, size, ch)).astype(np.float32) * noise)
        # joint rounds first, then mean-only rounds: the mean gets the last word
        for it in range(8):
            clipped = np.clip(a * xp + b, 0.0, 255.0)
            m_r = clipped.mean(axis=(0, 1, 2))
            s_r = clipped.std(axis=(0, 1, 2))
            if it < 4:
                a = a * std_t / np.maximum(s_r, 1e-6)
            b = b + (mean_t - m_r)
        a = a.astype(np.float32)
        b = b.astype(np.float32)
        templates = a * templates + b
        noise_c = noise_c * a
    split_rng = np.random.Generator(
        np.random.Philox(root_seed + (1 if train else 2))
    )
    y = split_rng.integers(0, k, size=n)
    # images come from the true class y; the returned labels resample a
    # 'label_noise' fraction uniformly
    y_out = y
    if diff["label_noise"] > 0:
        flip = split_rng.random(n) < diff["label_noise"]
        y_out = np.where(flip, split_rng.integers(0, k, size=n), y)
    # chunked generation into one uint8 output with a reused f32 workspace
    x = np.empty((n, size, size, ch), np.uint8)
    chunk = 2048
    work = np.empty((chunk, size, size, ch), np.float32)
    tbuf = np.empty((chunk, size, size, ch), np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        w, t = work[: hi - lo], tbuf[: hi - lo]
        split_rng.standard_normal(out=w, dtype=np.float32)
        np.take(templates, y[lo:hi], axis=0, out=t)
        w *= noise_c
        w += t
        np.clip(w, 0, 255, out=w)
        x[lo:hi] = w
    return x, y_out.astype(np.int64)


def load_raw(
    name: str, path: str | None, train: bool, allow_synthetic: bool = True,
    synthetic_n: int | None = None, difficulty: dict | None = None,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (images uint8 NHWC, labels int64, is_synthetic)."""
    if name not in DATASET_PROFILES:
        raise NotImplementedError(f"Unknown dataset {name}")
    if name not in SUPPORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md open item 9); "
            f"supported: {SUPPORTED}")
    out = None
    if path is not None:
        root = path
        if name in ("CIFAR10", "CIFAR100", "MNIST"):
            # the reference joins the lowercased name
            sub = os.path.join(path, name.lower())
            root = sub if os.path.isdir(sub) else path
        if name in ("MNIST", "FashionMNIST", "KMNIST"):
            out = read_mnist_like(root, train)
        else:
            out = read_cifar(root, train, variant=100 if name == "CIFAR100" else 10)
    if out is not None:
        x, y = out
        return x, y, False
    if not allow_synthetic:
        raise FileNotFoundError(f"No on-disk data for {name} under {path!r}")
    x, y = synthetic(name, train, n=synthetic_n, difficulty=difficulty)
    return x, y, True
