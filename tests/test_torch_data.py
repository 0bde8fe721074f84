"""ursabench_tpu_torch.data against ursabench_tpu.data: the same bytes from
the synthetic generator, the readers and the loaders, and the same batches
from normalize + crop + flip given the random choices the JAX package drew."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursabench_tpu import data as jdata
from ursabench_tpu.data import sources as jsources
from ursabench_tpu.data import transforms as jtransforms
from ursabench_tpu_torch import data as tdata
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsources.load_raw("SVHN", None, True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdata.loaders("CIFAR10", None, 32, imbalance=True)


def test_split_device_tensors_and_batches():
    splits, _ = tdata.loaders("MNIST", None, batch_size=32, use_validation=False,
                              synthetic_n_train=70, synthetic_n_test=10)
    split = splits["train"]
    images, labels = split.device_tensors("cpu")
    assert images.dtype == torch.uint8 and tuple(images.shape) == (70, 28, 28, 1)
    assert labels.dtype == torch.int64
    sizes = [x.shape[0] for x, _ in split.batches()]
    assert sizes == [32, 32, 6] and split.num_batches == 3
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
