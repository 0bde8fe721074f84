"""Dataset loaders.

Counterpart of ``ursabench_tpu/data/__init__.py``: ``loaders`` has the same
signature and returns the same arrays (the validation split is the same
Philox permutation), as host-side ``DataSplit``s. SVHN, CIFAR-10 class
splits and the Decision task's imbalance wait for the tasks that use them
(ROADMAP.md open item 9).
"""

from __future__ import annotations

import numpy as np

from .arrays import DataSplit
from .sources import DATASET_PROFILES, load_raw, resolve_difficulty, synthetic
from .transforms import ImageSpec


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
    if dataset == "SVHN" or split_classes is not None or imbalance:
        raise NotImplementedError(
            "SVHN, split_classes and imbalance are not ported yet "
            "(ROADMAP.md open item 9)")
    x_tr, y_tr, _ = load_raw(
        dataset, path, train=True, synthetic_n=synthetic_n_train,
        difficulty=difficulty,
    )
    num_classes = DATASET_PROFILES[dataset][2]
    if use_validation:
        n_val = int(len(x_tr) * val_size)
        rng = np.random.Generator(np.random.Philox(seed))
        r_ind = rng.permutation(len(x_tr))
        x_te, y_te = x_tr[r_ind[-n_val:]], y_tr[r_ind[-n_val:]]
        x_tr, y_tr = x_tr[r_ind[:-n_val]], y_tr[r_ind[:-n_val]]
    else:
        x_te, y_te, _ = load_raw(
            dataset, path, train=False, synthetic_n=synthetic_n_test,
            difficulty=difficulty,
        )
        if len(y_te) and int(y_te.max()) >= num_classes:
            raise ValueError(
                f"{dataset}: test labels reach {int(y_te.max())} but "
                f"num_classes={num_classes}"
            )
    spec_tr = transform_train or ImageSpec(
        x_tr.shape[1], x_tr.shape[3], (0.5,) * x_tr.shape[3], (0.5,) * x_tr.shape[3]
    )
    spec_te = transform_test or spec_tr
    return (
        {
            "train": DataSplit(x_tr, y_tr, batch_size, spec_tr,
                               shuffle=shuffle_train, dataset_name=dataset),
            "test": DataSplit(x_te, y_te, batch_size, spec_te,
                              shuffle=False, dataset_name=dataset),
        },
        num_classes,
    )


__all__ = [
    "loaders", "DataSplit", "ImageSpec", "DATASET_PROFILES", "synthetic",
    "resolve_difficulty",
]
