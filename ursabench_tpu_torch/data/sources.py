"""Raw dataset readers and the deterministic synthetic fallback, in numpy.

Counterpart of ``ursabench_tpu/data/sources.py``: the readers of the
on-disk formats (MNIST idx, CIFAR pickle batches, SVHN .mat, STL-10 bin and
ImageFolder trees for TIN, LSUN and CelebA), with the synthetic generator
standing in for what is not on disk. The generator consumes its Philox streams in the same
order and with the same sha256-derived seeds, so it returns the same bytes
as the JAX package (tests/test_torch_data.py pins this).

Generated sets are cached on disk as the JAX package caches them: under
``URSA_SYNTH_CACHE`` (default ``ursabench_synth_cache`` in the temporary
directory, ``tempfile.gettempdir()``: the JAX package's
``/tmp/ursabench_synth_cache`` where ``TMPDIR`` is unset; ``""`` or ``"0"``
turns the cache off), one ``<tag>.x.npy`` and ``<tag>.y.npy`` a set,
the tag naming the dataset, split, n, seed, difficulty and
``_SYNTH_GEN_VERSION``. The names, the ``.npy`` format and the version are
the JAX package's, so an entry written by either package is read by the
other. A hit is a read-only memmap of the images (a caller's write raises
and never reaches the file); a miss generates into a memmap at a
pid-suffixed tmp name, writes the labels, renames labels then images into
place and hands out a read-only reopen; an entry that fails to load is
generated again.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import pickle
import struct
import tempfile
import time
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

# STL-10 labels remapped to CIFAR class order
STL_CLS_MAPPING = np.array([0, 2, 1, 3, 4, 5, 7, 6, 8, 9])

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


def read_svhn(root: str, split: str) -> Tuple[np.ndarray, np.ndarray] | None:
    path = os.path.join(root, f"{split}_32x32.mat")
    if not os.path.exists(path):
        return None
    from scipy.io import loadmat

    d = loadmat(path)
    x = d["X"].transpose(3, 0, 1, 2).astype(np.uint8)  # N,32,32,3
    y = d["y"].reshape(-1).astype(np.int64) % 10  # '10' means digit 0
    return x, y


def read_image_folder(
    root: str, size: int, classes: list[str] | None = None
) -> Tuple[np.ndarray, np.ndarray] | None:
    """torchvision's ImageFolder: root/<class>/**/*.{jpeg,jpg,png}, classes
    sorted alphabetically -> label ids. ``classes`` pins the class -> id
    mapping; a class directory outside it is an error. Needs PIL; returns
    None without it, or when nothing is found."""
    if not os.path.isdir(root):
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    on_disk = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    if classes is None:
        classes = on_disk
    else:
        unknown = set(on_disk) - set(classes)
        if unknown:
            raise ValueError(
                f"{root}: class dirs {sorted(unknown)} not present in the "
                f"reference split's class list {classes}; the train/test "
                "trees must share one class set"
            )
    class_to_id = {c: i for i, c in enumerate(classes)}
    xs, ys = [], []
    for cls in on_disk:
        label = class_to_id[cls]
        for dirpath, _, files in os.walk(os.path.join(root, cls)):
            for fn in sorted(files):
                if not fn.lower().endswith((".jpeg", ".jpg", ".png")):
                    continue
                img = Image.open(os.path.join(dirpath, fn)).convert("RGB")
                if img.size != (size, size):
                    img = img.resize((size, size))
                xs.append(np.asarray(img, np.uint8))
                ys.append(label)
    if not xs:
        return None
    return np.stack(xs), np.asarray(ys, np.int64)


def read_split_image_folder(
    root: str, train: bool, size: int
) -> Tuple[np.ndarray, np.ndarray] | None:
    """<root>/{train,test}/<class>/... (TinyImageNet, and LSUN/CelebA
    exports). The train/ listing fixes the class ids of both splits."""
    train_root = os.path.join(root, "train")
    classes = None
    if os.path.isdir(train_root):
        classes = sorted(
            d for d in os.listdir(train_root)
            if os.path.isdir(os.path.join(train_root, d))
        ) or None
    return read_image_folder(
        os.path.join(root, "train" if train else "test"), size, classes=classes
    )


def read_tin(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray] | None:
    """TinyImageNet: <root>/{train,test}/<class>/..., 64x64."""
    return read_split_image_folder(root, train, 64)


def read_stl10(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray] | None:
    """stl10_binary/{train,test}_{X,y}.bin, 96x96 average-pooled 3x3 to 32x32;
    labels 0-based in STL order (``load_raw`` remaps them)."""
    base = os.path.join(root, "stl10_binary")
    kind = "train" if train else "test"
    xi = os.path.join(base, f"{kind}_X.bin")
    yi = os.path.join(base, f"{kind}_y.bin")
    if not (os.path.exists(xi) and os.path.exists(yi)):
        return None
    x = np.fromfile(xi, np.uint8).reshape(-1, 3, 96, 96).transpose(0, 3, 2, 1)
    y = np.fromfile(yi, np.uint8).astype(np.int64) - 1
    x = x.reshape(-1, 32, 3, 32, 3, 3).mean(axis=(2, 4)).astype(np.uint8)
    return x, y


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


_SYNTH_GEN_VERSION = "v6"  # the JAX package's tag: entries are shared between the packages


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


def _synth_cache_path(name: str, train: bool, n: int, seed: int,
                      diff: dict) -> str | None:
    """The cache entry's path without its ``.x.npy`` / ``.y.npy`` suffix, or
    None when ``URSA_SYNTH_CACHE`` turns the cache off."""
    root = os.environ.get("URSA_SYNTH_CACHE",
                          os.path.join(tempfile.gettempdir(), "ursabench_synth_cache"))
    if root in ("", "0"):
        return None
    dtag = (f"z{diff['separation']:g}-s{diff['noise']:g}"
            f"-ln{diff['label_noise']:g}-b{diff['base_shift']:g}"
            f"-fo{diff['field_overlap']:g}")
    tag = (f"{name}-{'train' if train else 'test'}-{n}-{seed}-{dtag}"
           f"-{_SYNTH_GEN_VERSION}")
    return os.path.join(root, tag)


def _synth_cache_load(name, train, n, seed, diff):
    """A cache hit: the images as a read-only memmap and the labels, or
    None (no entry, the cache off, or an entry that fails to load)."""
    base = _synth_cache_path(name, train, n, seed, diff)
    if base is None or not os.path.exists(base + ".x.npy"):
        return None
    try:
        x = np.load(base + ".x.npy", mmap_mode="r")
        y = np.load(base + ".y.npy")
        return x, y
    except (OSError, ValueError, EOFError):
        return None  # a corrupt or partial entry: generate again


def _sweep_stale_tmp(cache_dir: str, max_age_s: float = 3600.0) -> None:
    """Remove the tmp files of interrupted generations older than
    ``max_age_s`` (a live one of another process is younger)."""
    try:
        now = time.time()
        for fn in os.listdir(cache_dir):
            if ".tmp." not in fn:
                continue
            p = os.path.join(cache_dir, fn)
            try:
                if now - os.path.getmtime(p) > max_age_s:
                    os.remove(p)
            except OSError:
                pass
    except OSError:
        pass


def _synth_writable_output(name, train, n, seed, diff, shape):
    """The uint8 buffer to generate into and ``commit(y)``, which returns
    the images to hand out. With the cache on: a memmap at
    ``<tag>.tmp.<pid>.x.npy``, committed by writing y to its own tmp name,
    renaming it, then renaming x (a reader that finds x.npy finds y.npy)
    and reopening x read-only, so that a caller's write never reaches the
    cache. Ranks under ``torchrun`` share one cache directory: each
    generates into its own pid-suffixed tmp files and the renames are
    atomic, so a reader sees a whole entry or none. Without the cache (or
    when its directory cannot be written): memory."""
    base = _synth_cache_path(name, train, n, seed, diff)
    if base is not None:
        try:
            os.makedirs(os.path.dirname(base), exist_ok=True)
            _sweep_stale_tmp(os.path.dirname(base))
            tmp = f"{base}.tmp.{os.getpid()}"
            x = np.lib.format.open_memmap(f"{tmp}.x.npy", mode="w+", dtype=np.uint8,
                                          shape=shape)

            def commit(y):
                x.flush()
                np.save(f"{tmp}.y.npy", y)
                os.replace(f"{tmp}.y.npy", base + ".y.npy")
                os.replace(f"{tmp}.x.npy", base + ".x.npy")
                return np.load(base + ".x.npy", mmap_mode="r")

            return x, commit
        except OSError:
            pass  # the cache directory cannot be written: generate in memory
    x = np.empty(shape, np.uint8)
    return x, lambda y: x


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
    resampled. Served from and written to the on-disk cache (module
    docstring): a cached set's images are a read-only memmap."""
    size, ch, k, n_train, n_test = DATASET_PROFILES[name]
    if n is None:
        n = n_train if train else n_test
    diff = resolve_difficulty(name, difficulty)
    cached = _synth_cache_load(name, train, n, seed, diff)
    if cached is not None:
        return cached
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
    x, commit = _synth_writable_output(name, train, n, seed, diff, (n, size, size, ch))
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
    y_out = y_out.astype(np.int64)
    return commit(y_out), y_out


def load_raw(
    name: str, path: str | None, train: bool, allow_synthetic: bool = True,
    synthetic_n: int | None = None, difficulty: dict | None = None,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Returns (images uint8 NHWC, labels int64, is_synthetic). STL-10's
    labels, read or synthetic, are remapped to CIFAR's class order."""
    if name not in DATASET_PROFILES:
        raise NotImplementedError(f"Unknown dataset {name}")
    out = None
    if path is not None:
        root = path
        if name in ("CIFAR10", "CIFAR100", "MNIST"):
            # the reference joins the lowercased name
            sub = os.path.join(path, name.lower())
            root = sub if os.path.isdir(sub) else path
        if name in ("MNIST", "FashionMNIST", "KMNIST"):
            out = read_mnist_like(root, train)
        elif name in ("CIFAR10", "CIFAR100"):
            out = read_cifar(root, train, variant=100 if name == "CIFAR100" else 10)
        elif name == "SVHN":
            out = read_svhn(root, "train" if train else "test")
        elif name == "STL10":
            out = read_stl10(root, train)
        elif name == "TIN":
            out = read_tin(root, train)
        else:  # LSUN, CelebA
            out = read_split_image_folder(root, train, DATASET_PROFILES[name][0])
    synthetic_data = out is None
    if synthetic_data:
        if not allow_synthetic:
            raise FileNotFoundError(f"No on-disk data for {name} under {path!r}")
        out = synthetic(name, train, n=synthetic_n, difficulty=difficulty)
    x, y = out
    if name == "STL10":
        y = STL_CLS_MAPPING[y]
    return x, y, synthetic_data
