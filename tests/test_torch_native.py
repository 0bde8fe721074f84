"""The host data pipeline of ursabench_tpu_torch (``data/native.py`` over its
own copy of ``dataio.cc``) against the JAX package's
(``ursabench_tpu/data/native.py`` over ``native/dataio.cc``): the
permutation and both gathers byte for byte, and ``HostStreamingSplit``'s
batches over three epochs in both transfer modes, per batch and in chunks,
from memory and from a memmap. The pinned ring and the copy stream run only
on a GPU, where ``chip_smoke.py`` checks every batch of a streamed epoch."""

import pathlib

import numpy as np
import pytest
import torch

from ursabench_tpu.data import native as jnative
from ursabench_tpu.data.transforms import ImageSpec as JSpec
from ursabench_tpu_torch.data import native
from ursabench_tpu_torch.data.transforms import ImageSpec
from ursabench_tpu_torch.kernels import build

ROOT = pathlib.Path(__file__).resolve().parent.parent
MEAN, STD = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)


def _data(n=130, h=8, w=8, c=3, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.int64)
    return images, labels


def _code(path):
    """The lines of a C++ source that are not ``//`` comments."""
    return [line for line in path.read_text().splitlines()
            if not line.lstrip().startswith("//")]


def test_library_builds_from_the_ports_own_copy_of_dataio():
    """``csrc/dataio.cc`` is ``native/dataio.cc``'s code, line for line (one
    comment differs: it names the reference file without a checkout path)."""
    assert _code(native.SOURCE) == _code(ROOT / "native" / "dataio.cc")
    lib = native.load_library()
    assert lib.ursa_dataio_version() == native.DATAIO_VERSION == 4
    path = build.library_path(native.SOURCE)
    assert path.exists() and path.parent == build.BUILD_DIR
    assert path.name.startswith("libdataio-")


def test_failed_host_build_raises(tmp_path):
    bad = tmp_path / "broken_dataio.cc"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="failed on broken_dataio.cc"):
        build.build([bad])
    assert not build.library_path(bad).exists()


@pytest.mark.parametrize("n,seed", [(1, 0), (1000, 42), (50_000, 7), (37, 2 ** 63 + 5)])
def test_permutation_matches_jax(n, seed):
    got = native.permutation(n, seed)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jnative.permutation(n, seed))
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("c", [1, 3, 20])
def test_gathers_match_jax(c):
    """``gather_u8`` and ``gather_normalize`` byte for byte, the latter
    through dataio.cc up to 16 channels and through numpy beyond."""
    images, labels = _data(c=c)
    idx = np.random.default_rng(1).permutation(130)[:17].astype(np.int64)
    mean = np.linspace(0.3, 0.6, c).astype(np.float32)
    std = np.linspace(0.2, 0.3, c).astype(np.float32)
    x, y = native.gather_u8(images, labels, idx)
    jx, jy = jnative.gather_u8(images, labels, idx)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.dtype == np.uint8 and y.dtype == np.int32
    x, y = native.gather_normalize(images, labels, idx, mean, std)
    jx, jy = jnative.gather_normalize(images, labels, idx, mean, std)
    assert x.dtype == np.float32 and x.tobytes() == np.asarray(jx, np.float32).tobytes()
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(x, (images[idx] / 255.0 - mean) / std, rtol=1e-5, atol=1e-5)


def _pair(images, labels, **kw):
    c = images.shape[3]
    mean, std = (MEAN + (0.5,) * c)[:c], (STD + (0.25,) * c)[:c]
    return (native.HostStreamingSplit(images, labels, spec=ImageSpec(8, c, mean, std), **kw),
            jnative.HostStreamingSplit(images, labels, spec=JSpec(8, c, mean, std), **kw))


@pytest.mark.parametrize("memmap", [False, True], ids=["memory", "memmap"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("transfer_dtype", ["uint8", "float32"])
def test_stream_matches_jax_over_three_epochs(tmp_path, transfer_dtype, chunk, memmap):
    """The same seed gives the same batches, epoch after epoch (the C++
    stream rewound, the ring lapped), byte for byte: raw rows in uint8 mode,
    dataio.cc's normalization in float32 mode."""
    images, labels = _data(n=150)
    if memmap:
        np.save(tmp_path / "images.npy", images)
        images = np.load(tmp_path / "images.npy", mmap_mode="r")
        assert not images.flags.writeable
    t, j = _pair(images, labels, batch_size=16, seed=11, transfer_dtype=transfer_dtype,
                 chunk_batches=chunk)
    assert (t.n, t.num_chunks, t.num_batches) == (j.n, j.num_chunks, j.num_batches)
    assert t.num_batches == (150 // (16 * chunk)) * chunk
    handle = None
    for epoch in range(3):
        got = list(t.epoch("cpu"))
        want = [(np.asarray(x), np.asarray(y)) for x, y in j.epoch()]
        assert len(got) == len(want) == t.num_chunks
        for (x, y), (jx, jy) in zip(got, want):
            assert x.dtype == (torch.uint8 if transfer_dtype == "uint8" else torch.float32)
            assert y.dtype == torch.int64
            assert tuple(x.shape) == jx.shape and tuple(y.shape) == jy.shape
            assert x.numpy().tobytes() == jx.tobytes()
            np.testing.assert_array_equal(y.numpy(), jy)
        if epoch == 0:
            handle = t._handle
        assert t._handle == handle  # one C++ stream, rewound
    assert t.epochs_started == 3


def test_stream_order_is_the_seeded_permutation():
    images, labels = _data(n=100)
    split = native.HostStreamingSplit(images, np.arange(100), 16, ImageSpec(8, 3, MEAN, STD),
                                      seed=5)
    for epoch in range(2):
        ys = torch.cat([y for _, y in split.epoch("cpu")]).numpy()
        np.testing.assert_array_equal(ys, native.permutation(100, 5 + epoch)[:96])
    split = native.HostStreamingSplit(images, labels, 16, ImageSpec(8, 3, MEAN, STD),
                                      shuffle=False)
    x0, y0 = next(iter(split.epoch("cpu")))
    np.testing.assert_array_equal(x0.numpy(), images[:16])
    np.testing.assert_array_equal(y0.numpy(), labels[:16])


def test_float32_beyond_16_channels_matches_jax():
    """Outside dataio.cc's contract (float32 with more than 16 channels) both
    packages gather and normalize with numpy, in the permutation's order."""
    images, labels = _data(n=70, c=20)
    t, j = _pair(images, labels, batch_size=16, seed=3, transfer_dtype="float32")
    assert not t._native()
    for _ in range(2):
        got = list(t.epoch("cpu"))
        want = [(np.asarray(x), np.asarray(y)) for x, y in j.epoch()]
        assert len(got) == len(want) == 4
        for (x, y), (jx, jy) in zip(got, want):
            assert x.numpy().tobytes() == jx.tobytes()
            np.testing.assert_array_equal(y.numpy(), jy)
    assert t._handle is None


def test_stats_count_transfers_and_bytes():
    images, labels = _data(n=100)
    split = native.HostStreamingSplit(images, labels, 16, ImageSpec(8, 3, MEAN, STD),
                                      chunk_batches=2)
    batches = list(split.epoch("cpu"))
    assert len(batches) == split.num_chunks == 3 and split.num_batches == 6
    assert batches[0][0].shape == (2, 16, 8, 8, 3) and batches[0][1].shape == (2, 16)
    assert split.stats["transfers"] == 3
    assert split.stats["bytes"] == 3 * 32 * (8 * 8 * 3 + 4)
    assert 0 < split.stats["wait_s"] <= split.stats["host_s"]
    assert split.stats["copy_s"] == 0.0


def test_yielded_batches_do_not_alias_the_ring():
    """More batches than ring slots, all kept: each is its own copy."""
    images, labels = _data(n=128)
    split = native.HostStreamingSplit(images, np.arange(128), 16, ImageSpec(8, 3, MEAN, STD),
                                      stage_depth=2)
    batches = list(split.epoch("cpu"))
    for x, y in batches:
        np.testing.assert_array_equal(x.numpy(), images[y.numpy()])


def test_epoch_on_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    images, labels = _data()
    split = native.HostStreamingSplit(images, labels, 16, ImageSpec(8, 3, MEAN, STD))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter(split.epoch("cuda")))


@pytest.mark.parametrize("kw", [{"transfer_dtype": "float16"}, {"chunk_batches": 0},
                                {"stage_depth": 0}, {"batch_size": 0}])
def test_bad_arguments_raise(kw):
    images, labels = _data()
    args = {"batch_size": 16, **kw}
    with pytest.raises(ValueError):
        native.HostStreamingSplit(images, labels, spec=ImageSpec(8, 3, MEAN, STD), **args)
    with pytest.raises(ValueError, match="uint8 NHWC"):
        native.HostStreamingSplit(images.astype(np.float32), labels, 16,
                                  ImageSpec(8, 3, MEAN, STD))
