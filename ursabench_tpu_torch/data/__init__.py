"""Dataset loaders.

Counterpart of ``ursabench_tpu/data/__init__.py``: ``loaders`` and
``loaders_inc`` have the same signatures and return the same arrays, as
host-side ``DataSplit``s: the validation split is the same Philox
permutation (SVHN's the trailing slice), CIFAR-10's class splits come from
``c10_classes``, and the Decision task's imbalance keeps the first
``N - frac * N`` images of each of its classes.
"""

from __future__ import annotations

import numpy as np

from .arrays import DataSplit
from .sources import DATASET_PROFILES, load_raw, resolve_difficulty, synthetic
from .transforms import ImageSpec

c10_classes = np.array([[0, 1, 2, 8, 9], [3, 4, 5, 6, 7]], dtype=np.int32)

# the Decision task's imbalance: dataset -> (its costly labels, share removed)
_IMBALANCE = {
    "MNIST": ([3, 7], 0.99),
    "CIFAR10": ([0, 1, 8, 9], 0.9),
    "CIFAR100": ([58, 69, 85], 0.9),
}


def increase_data_imbalance(
    labels: np.ndarray, images: np.ndarray, label: int, remove_frac: float = 0.9
):
    """Keep only the first ``N - remove_frac * N`` images of ``label``."""
    mask = labels == label
    ind = np.where(mask)[0]
    n = len(ind)
    ind_keep = int(n - remove_frac * n)
    mask[ind[:ind_keep]] = False
    keep = ~mask
    return labels[keep], images[keep]


def _default_spec(x: np.ndarray) -> ImageSpec:
    ch = x.shape[3]
    return ImageSpec(x.shape[1], ch, (0.5,) * ch, (0.5,) * ch)


def _splits(dataset, x_tr, y_tr, x_te, y_te, batch_size, transform_train,
            transform_test, shuffle_train):
    spec_tr = transform_train or _default_spec(x_tr)
    spec_te = transform_test or spec_tr
    return {
        "train": DataSplit(x_tr, y_tr, batch_size, spec_tr,
                           shuffle=shuffle_train, dataset_name=dataset),
        "test": DataSplit(x_te, y_te, batch_size, spec_te,
                          shuffle=False, dataset_name=dataset),
    }


def loaders(
    dataset: str,
    path: str | None,
    batch_size: int,
    num_workers: int = 0,  # accepted for signature parity
    transform_train: ImageSpec | None = None,
    transform_test: ImageSpec | None = None,
    use_validation: bool = True,
    val_size: float = 0.2,
    split_classes: int | None = None,
    shuffle_train: bool = True,
    imbalance: bool = False,
    seed: int = 0,
    synthetic_n_train: int | None = None,
    synthetic_n_test: int | None = None,
    difficulty: dict | None = None,
):
    """Returns ``({"train": DataSplit, "test": DataSplit}, num_classes)``.
    With ``use_validation`` the test split is the last ``val_size`` share of
    a seeded permutation of the train set."""
    del num_workers
    if dataset == "SVHN":
        return _svhn_loaders(
            path, batch_size, transform_train, transform_test,
            use_validation, val_size, shuffle_train,
            synthetic_n_train, synthetic_n_test, difficulty,
        )
    x_tr, y_tr, is_synth = load_raw(
        dataset, path, train=True, synthetic_n=synthetic_n_train,
        difficulty=difficulty,
    )
    # LSUN and CelebA read any ImageFolder tree: real data sets its own
    # class count; elsewhere the profile's count holds (max(label) + 1 would
    # undercount a small synthetic subset)
    if dataset in ("LSUN", "CelebA") and not is_synth:
        num_classes = int(y_tr.max()) + 1
    else:
        num_classes = DATASET_PROFILES[dataset][2]

    if imbalance and dataset in _IMBALANCE:
        labels, frac = _IMBALANCE[dataset]
        for label in labels:
            y_tr, x_tr = increase_data_imbalance(y_tr, x_tr, label, remove_frac=frac)

    if use_validation:
        n_val = int(len(x_tr) * val_size)
        rng = np.random.Generator(np.random.Philox(seed))
        r_ind = rng.permutation(len(x_tr))
        x_te, y_te = x_tr[r_ind[-n_val:]], y_tr[r_ind[-n_val:]]
        x_tr, y_tr = x_tr[r_ind[:-n_val]], y_tr[r_ind[:-n_val]]
    else:
        x_te, y_te, te_synth = load_raw(
            dataset, path, train=False, synthetic_n=synthetic_n_test,
            difficulty=difficulty,
        )
        if dataset in ("LSUN", "CelebA") and te_synth != is_synth:
            # the class count comes from the data here: a k-class model
            # against 10-class synthetic labels would give wrong metrics
            raise ValueError(
                f"{dataset}: train split is "
                f"{'synthetic' if is_synth else 'on-disk'} but test split is "
                f"{'synthetic' if te_synth else 'on-disk'}; provide both "
                "splits on disk (or neither, for the synthetic fallback)"
            )
        if len(y_te) and int(y_te.max()) >= num_classes:
            raise ValueError(
                f"{dataset}: test labels reach {int(y_te.max())} but "
                f"num_classes={num_classes} from the train split"
            )

    if split_classes is not None:
        if dataset != "CIFAR10" or split_classes not in (0, 1):
            raise ValueError("split_classes is 0 or 1, and for CIFAR10 only")
        sel = c10_classes[split_classes]
        x_tr, y_tr = _remap_split(x_tr, y_tr, sel)
        x_te, y_te = _remap_split(x_te, y_te, sel)
        num_classes = len(sel)

    return (_splits(dataset, x_tr, y_tr, x_te, y_te, batch_size, transform_train,
                    transform_test, shuffle_train), num_classes)


def _remap_split(x, y, sel):
    """The images of the classes ``sel``, relabelled 0..len(sel)-1."""
    mask = np.isin(y, sel)
    x, y = x[mask], y[mask]
    y = np.where(y[:, None] == sel[None, :])[1]
    return x, y


def _svhn_loaders(
    path, batch_size, transform_train, transform_test,
    use_validation, val_size, shuffle_train,
    synthetic_n_train, synthetic_n_test, difficulty=None,
):
    """SVHN validates on the trailing slice of train (``val_size`` > 1 is a
    count), not on a permutation; its test set is cut to 10,000 images."""
    x_tr, y_tr, _ = load_raw("SVHN", path, train=True,
                             synthetic_n=synthetic_n_train, difficulty=difficulty)
    if use_validation:
        v = int(val_size if val_size > 1 else len(x_tr) * val_size)
        x_te, y_te = x_tr[-v:], y_tr[-v:]
        x_tr, y_tr = x_tr[:-v], y_tr[:-v]
    else:
        x_te, y_te, _ = load_raw("SVHN", path, train=False,
                                 synthetic_n=synthetic_n_test, difficulty=difficulty)
        x_te, y_te = x_te[:10000], y_te[:10000]
    spec = ImageSpec(32, 3, (0.5,) * 3, (0.5,) * 3)
    return (_splits("SVHN", x_tr, y_tr, x_te, y_te, batch_size,
                    transform_train or spec, transform_test, shuffle_train), 10)


def loaders_inc(
    dataset: str,
    path: str | None,
    num_chunks: int,
    batch_size: int,
    num_workers: int = 0,
    transform_train: ImageSpec | None = None,
    transform_test: ImageSpec | None = None,
    use_validation: bool = True,
    val_size: int = 5000,
    shuffle_train: bool = True,
    seed: int = 1,
    synthetic_n_train: int | None = None,
    synthetic_n_test: int | None = None,
    difficulty: dict | None = None,
):
    """Incremental loaders: one ``RandomState(seed)`` permutation of train,
    its first ``N - val_size`` (or all N) indices cut into ``num_chunks``
    ceil-divided chunks, validation from the permutation's tail. Returns
    ``({"train": [DataSplit, ...], "test": DataSplit}, num_classes)``."""
    if dataset not in ("MNIST", "CIFAR10", "CIFAR100"):
        raise ValueError(f"loaders_inc takes MNIST, CIFAR10 or CIFAR100, not {dataset}")
    del num_workers
    x_tr, y_tr, _ = load_raw(dataset, path, train=True,
                             synthetic_n=synthetic_n_train, difficulty=difficulty)
    num_classes = DATASET_PROFILES[dataset][2]
    total = len(x_tr)
    num_samples = (total - val_size) if use_validation else total
    order = np.random.RandomState(seed).permutation(total)
    spec_tr = transform_train or _default_spec(x_tr)
    spec_te = transform_test or spec_tr

    chunks = []
    offset = 0
    remaining = num_samples
    for i in range(num_chunks, 0, -1):
        chunk_size = (remaining + i - 1) // i
        sel = order[offset: offset + chunk_size]
        chunks.append(DataSplit(x_tr[sel], y_tr[sel], batch_size, spec_tr,
                                shuffle=shuffle_train, dataset_name=dataset))
        offset += chunk_size
        remaining -= chunk_size

    if use_validation:
        sel = order[-val_size:]
        x_te, y_te = x_tr[sel], y_tr[sel]
    else:
        x_te, y_te, _ = load_raw(dataset, path, train=False,
                                 synthetic_n=synthetic_n_test, difficulty=difficulty)
    test = DataSplit(x_te, y_te, batch_size, spec_te, dataset_name=dataset)
    return {"train": chunks, "test": test}, num_classes


__all__ = [
    "loaders", "loaders_inc", "DataSplit", "ImageSpec", "c10_classes",
    "increase_data_imbalance", "DATASET_PROFILES", "synthetic",
    "resolve_difficulty",
]
