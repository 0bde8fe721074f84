"""ursabench_tpu_torch.data against ursabench_tpu.data: the same bytes from
the synthetic generator, the readers (on tiny files written here) and the
loaders with every option, and the same batches from normalize + crop +
flip given the random choices the JAX package drew."""

import os
import pickle
import tempfile
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu.data import sources as jsources
from ursabench_tpu.data import transforms as jtransforms
from ursabench_tpu_torch import data as tdata
from ursabench_tpu_torch.data import arrays as tarrays
from ursabench_tpu_torch.data import sources as tsources
from ursabench_tpu_torch.data import transforms as ttransforms

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_synth_cache(monkeypatch):
    # the JAX generator would otherwise write a cache under /tmp
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")


@pytest.mark.parametrize("name", ["CIFAR10", "MNIST", "CIFAR100"])
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_bytes_identical(name, train):
    xj, yj = jsources.synthetic(name, train, n=300)
    xt, yt = tsources.synthetic(name, train, n=300)
    assert xt.dtype == np.uint8 and yt.dtype == np.int64
    np.testing.assert_array_equal(np.asarray(xj), xt)
    np.testing.assert_array_equal(np.asarray(yj), yt)


def test_synthetic_difficulty_override_identical():
    diff = {"separation": 2.0, "label_noise": 0.1, "field_overlap": 0.0}
    xj, yj = jsources.synthetic("CIFAR10", True, n=64, seed=3, difficulty=diff)
    xt, yt = tsources.synthetic("CIFAR10", True, n=64, seed=3, difficulty=diff)
    np.testing.assert_array_equal(np.asarray(xj), xt)
    np.testing.assert_array_equal(np.asarray(yj), yt)
    assert tsources.resolve_difficulty("CIFAR100", diff) == \
        jsources.resolve_difficulty("CIFAR100", diff)
    with pytest.raises(ValueError):
        tsources.resolve_difficulty("CIFAR10", {"nope": 1.0})


@pytest.mark.parametrize("name", ["CIFAR10", "MNIST"])
@pytest.mark.parametrize("use_validation", [False, True])
def test_loaders_identical(name, use_validation):
    kw = dict(batch_size=32, use_validation=use_validation, seed=4,
              synthetic_n_train=250, synthetic_n_test=90)
    sj, cj = jdata.loaders(name, None, **kw)
    st, ct = tdata.loaders(name, None, **kw)
    assert cj == ct
    for part in ("train", "test"):
        np.testing.assert_array_equal(np.asarray(sj[part].images), st[part].images)
        np.testing.assert_array_equal(np.asarray(sj[part].labels), st[part].labels)
        assert sj[part].batch_size == st[part].batch_size
        assert sj[part].spec.mean == st[part].spec.mean
        assert sj[part].spec.std == st[part].spec.std
        assert sj[part].shuffle == st[part].shuffle


def test_read_cifar_from_disk_identical(tmp_path):
    rng = np.random.default_rng(0)
    base = tmp_path / "cifar10" / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for fn in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (7, 3072), dtype=np.uint8),
                 b"labels": rng.integers(0, 10, 7).tolist()}
        with open(base / fn, "wb") as f:
            pickle.dump(batch, f)
    for train in (True, False):
        xj, yj, sj = jsources.load_raw("CIFAR10", str(tmp_path), train)
        xt, yt, st = tsources.load_raw("CIFAR10", str(tmp_path), train)
        assert not sj and not st
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(yj, yt)


def test_unported_datasets_raise():
    """Every dataset of the JAX package loads; one it does not know raises
    as it does there."""
    for loader in (jsources.load_raw, tsources.load_raw):
        with pytest.raises(NotImplementedError, match="Unknown dataset"):
            loader("ImageNet21k", None, True)
    with pytest.raises(ValueError):
        tdata.loaders("CIFAR100", None, 32, split_classes=0)
    with pytest.raises(ValueError):
        tdata.loaders_inc("SVHN", None, 2, 32)


def test_split_device_tensors_and_batches():
    splits, _ = tdata.loaders("MNIST", None, batch_size=32, use_validation=False,
                              synthetic_n_train=70, synthetic_n_test=10)
    split = splits["train"]
    images, labels = split.device_tensors("cpu")
    assert images.dtype == torch.uint8 and tuple(images.shape) == (70, 28, 28, 1)
    assert labels.dtype == torch.int64
    sizes = [x.shape[0] for x, _ in split.batches("cpu")]
    assert sizes == [32, 32, 6] and split.num_batches == 3
    with pytest.raises(TypeError):  # the device is the caller's to name
        next(split.batches())
    with pytest.raises(ValueError):
        tdata.DataSplit(np.zeros((2, 3, 3), np.uint8), np.zeros(2), 1,
                        ttransforms.MNIST_TRAIN)


def _jax_choices(key, n, spec):
    """The crop offsets and flips ursabench_tpu.data.transforms.augment
    draws from ``key`` (transforms.py:70-78)."""
    flip = ox = oy = None
    if spec.random_flip:
        flip = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (n,)))
    if spec.random_crop_pad > 0:
        p = spec.random_crop_pad
        kx, ky = jax.random.split(key)
        ox = np.asarray(jax.random.randint(kx, (n,), 0, 2 * p + 1))
        oy = np.asarray(jax.random.randint(ky, (n,), 0, 2 * p + 1))
    return ox, oy, flip


@pytest.mark.parametrize("spec_name", ["crop_flip", "crop", "flip", "none"])
def test_normalize_augment_matches_jax(spec_name):
    base = jtransforms.CIFAR_TRAIN
    pad = 0 if spec_name in ("flip", "none") else base.random_crop_pad
    flip = spec_name in ("crop_flip", "flip")
    jspec = jtransforms.ImageSpec(32, 3, base.mean, base.std, pad, flip)
    tspec = ttransforms.ImageSpec(32, 3, base.mean, base.std, pad, flip)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    xj = jtransforms.normalize(jnp.asarray(imgs), jspec)
    if jspec.random_crop_pad or jspec.random_flip:
        xj = jtransforms.augment_normalized(key, xj, jspec)
    ox, oy, fl = _jax_choices(key, 16, jspec)
    as_t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    xt = ttransforms.normalize(torch.from_numpy(imgs), tspec)
    xt = ttransforms.augment_normalized(xt, tspec, as_t(ox), as_t(oy), as_t(fl))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)


def test_draw_augment_ranges():
    gen = torch.Generator().manual_seed(0)
    ox, oy, flip = ttransforms.draw_augment(gen, (50, 8), ttransforms.CIFAR_TRAIN)
    for o in (ox, oy):
        assert o.shape == (50, 8) and int(o.min()) == 0 and int(o.max()) == 8
    assert flip.dtype == torch.bool and 0.3 < flip.float().mean() < 0.7
    assert ttransforms.draw_augment(gen, (4,), ttransforms.CIFAR_TEST) == (None, None, None)


def test_synth_imagenet_bytes_identical(tmp_path, monkeypatch):
    """``profiling.imagenet_train.synth_imagenet`` draws the same images and
    labels as the JAX ImageNet bench's generator, across a 128-image chunk
    boundary, without its file cache."""
    from benchmarks.imagenet_train_bench import _synth_imagenet
    from ursabench_tpu_torch.profiling.imagenet_train import synth_imagenet

    monkeypatch.setenv("URSA_SYNTH_CACHE", str(tmp_path))
    xj, yj = _synth_imagenet(130, seed=3)
    xt, yt = synth_imagenet(130, seed=3)
    assert xt.shape == (130, 224, 224, 3) and xt.dtype == np.uint8 and yt.dtype == np.int64
    np.testing.assert_array_equal(np.asarray(xj), xt)
    np.testing.assert_array_equal(yj, yt)
    assert yt.min() >= 0 and yt.max() < 1000


NEW_DATASETS = ["SVHN", "STL10", "TIN", "LSUN", "CelebA"]


@pytest.mark.parametrize("name", NEW_DATASETS)
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_ood_datasets_identical(name, train):
    """load_raw's synthetic fallback, STL-10's label remap included."""
    xj, yj, sj = jsources.load_raw(name, None, train, synthetic_n=40)
    xt, yt, st = tsources.load_raw(name, None, train, synthetic_n=40)
    assert sj and st and xt.dtype == np.uint8 and yt.dtype == np.int64
    np.testing.assert_array_equal(np.asarray(xj), xt)
    np.testing.assert_array_equal(np.asarray(yj), yt)
    np.testing.assert_array_equal(tsources.STL_CLS_MAPPING, jsources.STL_CLS_MAPPING)


def test_read_svhn_from_disk_identical(tmp_path):
    from scipy.io import savemat

    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        savemat(tmp_path / f"{split}_32x32.mat",
                {"X": rng.integers(0, 256, (32, 32, 3, 9), dtype=np.uint8),
                 "y": rng.integers(1, 11, (9, 1)).astype(np.uint8)})
    for train in (True, False):
        xj, yj, sj = jsources.load_raw("SVHN", str(tmp_path), train)
        xt, yt, st = tsources.load_raw("SVHN", str(tmp_path), train)
        assert not sj and not st and xt.shape == (9, 32, 32, 3)
        assert 0 <= yt.min() and yt.max() <= 9  # '10' is digit 0
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(yj, yt)


def test_read_stl10_from_disk_identical(tmp_path):
    rng = np.random.default_rng(2)
    base = tmp_path / "stl10_binary"
    base.mkdir()
    for kind in ("train", "test"):
        rng.integers(0, 256, 5 * 3 * 96 * 96, dtype=np.uint8).tofile(base / f"{kind}_X.bin")
        np.array([1, 2, 3, 7, 10], np.uint8).tofile(base / f"{kind}_y.bin")
    for train in (True, False):
        xj, yj, _ = jsources.load_raw("STL10", str(tmp_path), train)
        xt, yt, st = tsources.load_raw("STL10", str(tmp_path), train)
        assert not st and xt.shape == (5, 32, 32, 3)
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(yj, yt)
        np.testing.assert_array_equal(yt, [0, 2, 1, 7, 9])  # remapped to CIFAR order


def _png_tree(root, classes, size, rng, per_class=2):
    from PIL import Image

    for split in ("train", "test"):
        for cls in classes:
            d = root / split / cls / "images"
            d.mkdir(parents=True)
            for i in range(per_class):
                img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                Image.fromarray(img).save(d / f"{i}.png")


@pytest.mark.parametrize("name", ["TIN", "LSUN", "CelebA"])
def test_read_image_folders_identical(tmp_path, name):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(3)
    _png_tree(tmp_path, ["b_cls", "a_cls", "c_cls"], 48, rng)  # resized to 64
    os.rename(tmp_path / "test" / "c_cls", tmp_path / "test_c")  # test lacks a class
    for train in (True, False):
        xj, yj, _ = jsources.load_raw(name, str(tmp_path), train)
        xt, yt, st = tsources.load_raw(name, str(tmp_path), train)
        assert not st and xt.shape[1:] == (64, 64, 3)
        np.testing.assert_array_equal(xj, xt)
        np.testing.assert_array_equal(yj, yt)
    # the train/ listing fixes the ids of both splits
    assert sorted(set(tsources.load_raw(name, str(tmp_path), False)[1])) == [0, 1]
    if name != "TIN":
        sj, cj = jdata.loaders(name, str(tmp_path), 4, use_validation=False)
        st, ct = tdata.loaders(name, str(tmp_path), 4, use_validation=False)
        assert cj == ct == 3
        np.testing.assert_array_equal(np.asarray(sj["test"].labels), st["test"].labels)


def test_image_folder_half_on_disk_raises(tmp_path):
    pytest.importorskip("PIL")
    _png_tree(tmp_path, ["x", "y"], 64, np.random.default_rng(4))
    import shutil

    shutil.rmtree(tmp_path / "test")
    for loaders in (jdata.loaders, tdata.loaders):
        with pytest.raises(ValueError, match="synthetic"):
            loaders("LSUN", str(tmp_path), 4, use_validation=False, synthetic_n_test=8)
    with pytest.raises(ValueError, match="class dirs"):
        tsources.read_image_folder(str(tmp_path / "train"), 64, classes=["x"])


def _assert_splits_equal(sj, st):
    for part in ("train", "test"):
        np.testing.assert_array_equal(np.asarray(sj[part].images), st[part].images)
        np.testing.assert_array_equal(np.asarray(sj[part].labels), st[part].labels)
        assert (sj[part].spec.mean, sj[part].spec.std) == (st[part].spec.mean, st[part].spec.std)
        assert sj[part].dataset_name == st[part].dataset_name


LOADER_OPTIONS = [
    dict(dataset="CIFAR10", split_classes=0),
    dict(dataset="CIFAR10", split_classes=1, use_validation=True),
    dict(dataset="MNIST", imbalance=True),
    dict(dataset="CIFAR10", imbalance=True),
    dict(dataset="CIFAR100", imbalance=True, use_validation=True),
    dict(dataset="SVHN", use_validation=True),
    dict(dataset="SVHN", use_validation=True, val_size=30),
    dict(dataset="SVHN", use_validation=False),
    dict(dataset="STL10", use_validation=False),
]


def _option_id(kw) -> str:
    return "-".join(f"{k}={v}" for k, v in kw.items())


@pytest.mark.parametrize("kw", LOADER_OPTIONS, ids=_option_id)
def test_loader_options_identical(kw):
    kw = {"use_validation": False, "batch_size": 32, "seed": 2, "synthetic_n_train": 400,
          "synthetic_n_test": 60, **kw}
    dataset = kw.pop("dataset")
    sj, cj = jdata.loaders(dataset, None, **kw)
    st, ct = tdata.loaders(dataset, None, **kw)
    assert cj == ct
    _assert_splits_equal(sj, st)
    if kw.get("imbalance"):
        costly, frac = tdata._IMBALANCE[dataset]
        full, _ = tdata.loaders(dataset, None, **{**kw, "imbalance": False})
        if not kw["use_validation"]:
            for label in costly:
                n = int((full["train"].labels == label).sum())
                assert int((st["train"].labels == label).sum()) == int(n - frac * n)


def test_svhn_test_set_cut_to_10000():
    kw = dict(batch_size=128, use_validation=False, synthetic_n_train=8,
              synthetic_n_test=10_010)
    sj, _ = jdata.loaders("SVHN", None, **kw)
    st, _ = tdata.loaders("SVHN", None, **kw)
    assert st["test"].n == 10_000
    np.testing.assert_array_equal(np.asarray(sj["test"].images), st["test"].images)


@pytest.mark.parametrize("use_validation", [True, False])
def test_loaders_inc_identical(use_validation):
    kw = dict(use_validation=use_validation, val_size=50, seed=3, synthetic_n_train=230,
              synthetic_n_test=40)
    sj, cj = jdata.loaders_inc("CIFAR10", None, 3, 32, **kw)
    st, ct = tdata.loaders_inc("CIFAR10", None, 3, 32, **kw)
    assert cj == ct == 10 and len(st["train"]) == len(sj["train"]) == 3
    for a, b in zip(sj["train"], st["train"]):
        np.testing.assert_array_equal(np.asarray(a.images), b.images)
        np.testing.assert_array_equal(np.asarray(a.labels), b.labels)
    assert [b.n for b in st["train"]] == ([60, 60, 60] if use_validation else [77, 77, 76])
    np.testing.assert_array_equal(np.asarray(sj["test"].labels), st["test"].labels)
    np.testing.assert_array_equal(np.asarray(sj["test"].images), st["test"].images)


# -- the on-disk synthetic cache --------------------------------------------------------------

CACHED = [("MNIST", True, 70, 0, None), ("CIFAR10", False, 40, 3, {"separation": 2.0})]


def _generated(name, train, n, seed, diff, monkeypatch):
    """The set generated with the cache off."""
    monkeypatch.setenv("URSA_SYNTH_CACHE", "0")
    return tsources.synthetic(name, train, n=n, seed=seed, difficulty=diff)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_synthetic_cache_entries_cross_between_the_packages(tmp_path, monkeypatch, writer):
    """An entry the JAX package wrote is a hit for the port, and the other
    way round: the same paths (under the default root too), the reader
    generates nothing, and the bytes equal a generation without the
    cache."""
    for name, train, n, seed, diff in CACHED:
        d = tsources.resolve_difficulty(name, diff)
        for root in (None, str(tmp_path)):
            if root is None:  # the default root, with no TMPDIR: the JAX package's /tmp one
                monkeypatch.delenv("URSA_SYNTH_CACHE", raising=False)
                for var in ("TMPDIR", "TEMP", "TMP"):
                    monkeypatch.delenv(var, raising=False)
                monkeypatch.setattr(tempfile, "tempdir", None)
            else:
                monkeypatch.setenv("URSA_SYNTH_CACHE", root)
            want = jsources._synth_cache_path(name, train, n, seed, d)
            assert tsources._synth_cache_path(name, train, n, seed, d) == want
            assert want.startswith((root or "/tmp/ursabench_synth_cache") + os.sep)
    want = [_generated(*case, monkeypatch) for case in CACHED]
    monkeypatch.setenv("URSA_SYNTH_CACHE", str(tmp_path))
    write, read = (jsources, tsources) if writer == "jax" else (tsources, jsources)
    for name, train, n, seed, diff in CACHED:
        write.synthetic(name, train, n=n, seed=seed, difficulty=diff)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 * len(CACHED) and not any(".tmp." in f for f in files)
    monkeypatch.setattr(read, "_synth_writable_output",
                        lambda *a: pytest.fail("a cache hit generated the set again"))
    for (name, train, n, seed, diff), (x0, y0) in zip(CACHED, want):
        x, y = read.synthetic(name, train, n=n, seed=seed, difficulty=diff)
        assert isinstance(x, np.memmap) and not x.flags.writeable
        assert x.dtype == x0.dtype and x.shape == x0.shape and y.dtype == y0.dtype
        np.testing.assert_array_equal(x, x0)
        np.testing.assert_array_equal(y, y0)
    assert sorted(os.listdir(tmp_path)) == files


def test_synthetic_cache_default_root_follows_tmpdir(tmp_path, monkeypatch):
    """With ``URSA_SYNTH_CACHE`` unset the cache lies in the temporary
    directory, so a run with a ``TMPDIR`` of its own reads and writes
    there and nowhere else."""
    monkeypatch.delenv("URSA_SYNTH_CACHE", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    root = tmp_path / "ursabench_synth_cache"
    d = tsources.resolve_difficulty("MNIST")
    assert tsources._synth_cache_path("MNIST", True, 20, 0, d).startswith(str(root) + os.sep)
    x, _ = tsources.synthetic("MNIST", True, n=20)
    assert isinstance(x, np.memmap) and os.path.dirname(x.filename) == str(root)
    assert sorted(os.listdir(root)) == sorted(
        os.path.basename(tsources._synth_cache_path("MNIST", True, 20, 0, d)) + suffix
        for suffix in (".x.npy", ".y.npy"))


@pytest.mark.parametrize("value", ["0", ""])
def test_synthetic_cache_turns_off(tmp_path, monkeypatch, value):
    """``URSA_SYNTH_CACHE`` "0" or "": no path, nothing written (not even
    relative to the working directory), a plain writable array."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("URSA_SYNTH_CACHE", value)
    d = tsources.resolve_difficulty("MNIST")
    assert tsources._synth_cache_path("MNIST", True, 20, 0, d) is None
    x, _ = tsources.synthetic("MNIST", True, n=20)
    assert type(x) is np.ndarray and x.flags.writeable and os.listdir(tmp_path) == []


def test_synthetic_cache_not_aliased(tmp_path, monkeypatch):
    """A write into the images synthetic() returned, a miss's or a hit's,
    raises and never reaches the cache; a split's tensors are copies of
    them, made without torch's warning about read-only arrays, so writing
    into those leaves the cache whole too."""
    monkeypatch.setenv("URSA_SYNTH_CACHE", str(tmp_path))
    miss, _ = tsources.synthetic("MNIST", True, n=64)
    want = np.array(miss)
    hit, _ = tsources.synthetic("MNIST", True, n=64)
    for x in (miss, hit):
        assert not x.flags.writeable
        with pytest.raises(ValueError, match="read-only"):
            x[0] = 0
        with pytest.raises(ValueError, match="read-only"):
            np.asarray(x)[0] = 0
    splits, _ = tdata.loaders("MNIST", None, batch_size=16, use_validation=False,
                              synthetic_n_train=64, synthetic_n_test=16)
    assert not splits["train"].images.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        images, labels = splits["train"].device_tensors("cpu")
        batch, _ = next(splits["train"].batches("cpu", normalized=False))
        # another device: the host-to-device copy alone, without a host copy's warning
        meta = tarrays.device_tensor(hit, "meta")
    assert meta.is_meta and tuple(meta.shape) == hit.shape and meta.dtype == torch.uint8
    images.zero_()
    labels.zero_()
    batch.zero_()
    again, _ = tsources.synthetic("MNIST", True, n=64)
    np.testing.assert_array_equal(again, want)
    assert int(want.max()) > 0


def test_truncated_cache_entry_regenerates(tmp_path, monkeypatch):
    """An entry cut short fails to load and is generated again, whole; a
    miss sweeps tmp files older than an hour and leaves a younger one (a
    live generation of another process) alone."""
    monkeypatch.setenv("URSA_SYNTH_CACHE", str(tmp_path))
    d = tsources.resolve_difficulty("CIFAR10")
    base = tsources._synth_cache_path("CIFAR10", True, 30, 0, d)
    x0, y0 = _generated("CIFAR10", True, 30, 0, None, monkeypatch)
    monkeypatch.setenv("URSA_SYNTH_CACHE", str(tmp_path))
    tsources.synthetic("CIFAR10", True, n=30)
    with open(base + ".x.npy", "r+b") as f:
        f.truncate(200)
    assert tsources._synth_cache_load("CIFAR10", True, 30, 0, d) is None
    stale, live = base + ".tmp.1.x.npy", base + ".tmp.2.x.npy"
    for path in (stale, live):
        open(path, "wb").close()
    old = time.time() - 7200
    os.utime(stale, (old, old))
    x, y = tsources.synthetic("CIFAR10", True, n=30)
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(y, y0)
    hit = tsources._synth_cache_load("CIFAR10", True, 30, 0, d)
    np.testing.assert_array_equal(hit[0], x0)
    assert not os.path.exists(stale) and os.path.exists(live)


@pytest.mark.parametrize("kw", LOADER_OPTIONS, ids=_option_id)
def test_loaders_equal_with_the_cache_on_and_off(tmp_path, monkeypatch, kw):
    """Every loader option gives the same bytes without the cache, from a
    miss and from a hit: no loader writes into the arrays synthetic()
    returns (imbalance, the class split, the validation permutation,
    SVHN's slices, STL-10's remap)."""
    kw = {"use_validation": False, "batch_size": 32, "seed": 2, "synthetic_n_train": 400,
          "synthetic_n_test": 60, **kw}
    dataset = kw.pop("dataset")
    want, c = tdata.loaders(dataset, None, **kw)
    monkeypatch.setenv("URSA_SYNTH_CACHE", str(tmp_path))
    for _ in ("miss", "hit"):
        got, c2 = tdata.loaders(dataset, None, **kw)
        assert c2 == c
        for part in ("train", "test"):
            np.testing.assert_array_equal(got[part].images, want[part].images)
            np.testing.assert_array_equal(got[part].labels, want[part].labels)
    assert os.listdir(tmp_path)


def test_loaders_inc_equal_with_the_cache_on_and_off(tmp_path, monkeypatch):
    kw = dict(use_validation=True, val_size=50, seed=3, synthetic_n_train=230,
              synthetic_n_test=40)
    want, _ = tdata.loaders_inc("CIFAR10", None, 3, 32, **kw)
    monkeypatch.setenv("URSA_SYNTH_CACHE", str(tmp_path))
    for _ in ("miss", "hit"):
        got, _ = tdata.loaders_inc("CIFAR10", None, 3, 32, **kw)
        for a, b in zip(got["train"] + [got["test"]], want["train"] + [want["test"]]):
            np.testing.assert_array_equal(a.images, b.images)
            np.testing.assert_array_equal(a.labels, b.labels)
