"""The host data pipeline: ctypes bindings of ``csrc/dataio.cc`` and
``HostStreamingSplit``, the train split for datasets too large for the card.

Counterpart of ``ursabench_tpu/data/native.py``. ``csrc/dataio.cc`` is the
JAX package's ``native/dataio.cc`` plus a data rank's row window
(``ursa_stream_window``, version 5): a seeded Fisher-Yates permutation
(mt19937_64), the batch gathers, and a prefetch stream whose C++ worker
thread gathers batch i+1 while Python dispatches batch i. The
library is built with the host's C++ compiler at first use
(``kernels/build.py``); a failed build raises, and nothing falls back to
numpy when the library is missing.

``HostStreamingSplit.epoch(device)`` yields one shuffled epoch of batches on
``device``. On a GPU they pass through a ring of ``stage_depth`` pinned host
slots: ``ursa_stream_next`` (called through ``ctypes.CDLL``, which releases
the GIL while it waits) fills a slot, the slot is copied to the device on a
copy stream of its own, and the consumer's stream waits for that copy's
event. Before the C++ side writes a slot again, the host waits for the
slot's previous copy. Each device batch is allocated on the copy stream and
marked with ``record_stream`` as used by the consumer's stream, so the
allocator does not hand its memory to a later copy while the consumer's
work on it is still queued. On the CPU each batch is a fresh copy of its
slot.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..kernels.build import CSRC, load

SOURCE = CSRC / "dataio.cc"
DATAIO_VERSION = 5  # ursa_dataio_version() of csrc/dataio.cc
_STAGE_DEPTH = 2
_MAX_AFFINE_CHANNELS = 16  # dataio.cc's per-channel tables in float32 mode

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64, _u64, _i32 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32

_SIGNATURES = {
    "ursa_permutation": ([_i64, _u64, _i64p], None),
    "ursa_gather_normalize": ([_u8p, _i64p, _i64, _i64, _i64p, _i64, _f32p, _f32p,
                               _f32p, _i32p], None),
    "ursa_gather_u8": ([_u8p, _i64p, _i64, _i64p, _i64, _u8p, _i32p], None),
    "ursa_stream_create": ([_u8p, _i64p, _i64, _i64, _i64, _i64, _f32p, _f32p, _u64,
                            _i32, _i32], ctypes.c_void_p),
    "ursa_stream_create_u8": ([_u8p, _i64p, _i64, _i64, _i64, _u64, _i32, _i32],
                              ctypes.c_void_p),
    "ursa_stream_next": ([ctypes.c_void_p, _f32p, _i32p], _i64),
    "ursa_stream_next_u8": ([ctypes.c_void_p, _u8p, _i32p], _i64),
    "ursa_stream_num_batches": ([ctypes.c_void_p], _i64),
    "ursa_stream_reset": ([ctypes.c_void_p, _u64, _i32], None),
    "ursa_stream_window": ([ctypes.c_void_p, _i64, _i64, _i64, _u64, _i32], _i32),
    "ursa_stream_destroy": ([ctypes.c_void_p], None),
    "ursa_dataio_version": ([], _i32),
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/dataio.cc``. Raises if the build
    fails or the library is not version ``DATAIO_VERSION``."""
    lib = load(SOURCE).lib
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    version = lib.ursa_dataio_version()
    if version != DATAIO_VERSION:
        raise RuntimeError(f"{SOURCE.name} is version {version}, expected {DATAIO_VERSION}")
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def permutation(n: int, seed: int) -> np.ndarray:
    """A permutation of ``range(n)`` (int64), the stream's epoch order for
    ``seed``."""
    out = np.empty(n, np.int64)
    load_library().ursa_permutation(n, seed & (2 ** 64 - 1), _ptr(out, ctypes.c_int64))
    return out


def gather_normalize(images: np.ndarray, labels: np.ndarray, indices: np.ndarray,
                     mean, std, out_x: Optional[np.ndarray] = None,
                     out_y: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """``images[indices]`` as normalized float32 ``(x/255 - mean)/std``
    (NHWC) and ``labels[indices]`` as int32, into ``out_x`` / ``out_y`` if
    given. ``dataio.cc`` computes ``x * (1/(255 std)) - mean/std``; beyond
    its 16 channels numpy computes the first form."""
    b = indices.shape[0]
    h, w, c = images.shape[1:]
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if out_x is None:
        out_x = np.empty((b, h, w, c), np.float32)
    if out_y is None:
        out_y = np.empty(b, np.int32)
    if c > _MAX_AFFINE_CHANNELS:
        np.subtract(images[indices], 0, out=out_x, casting="unsafe")
        out_x /= 255.0
        out_x -= mean
        out_x /= std
        out_y[:] = labels[indices]
        return out_x, out_y
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.ascontiguousarray(labels, np.int64)
    idx = np.ascontiguousarray(indices, np.int64)
    load_library().ursa_gather_normalize(
        _ptr(images, ctypes.c_uint8), _ptr(labels, ctypes.c_int64), h * w, c,
        _ptr(idx, ctypes.c_int64), b, _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
        _ptr(out_x, ctypes.c_float), _ptr(out_y, ctypes.c_int32))
    return out_x, out_y


def gather_u8(images: np.ndarray, labels: np.ndarray, indices: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """``images[indices]`` (uint8) and ``labels[indices]`` (int32)."""
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.ascontiguousarray(labels, np.int64)
    idx = np.ascontiguousarray(indices, np.int64)
    b = idx.shape[0]
    out_x = np.empty((b,) + images.shape[1:], np.uint8)
    out_y = np.empty(b, np.int32)
    load_library().ursa_gather_u8(
        _ptr(images, ctypes.c_uint8), _ptr(labels, ctypes.c_int64),
        int(np.prod(images.shape[1:])), _ptr(idx, ctypes.c_int64), b,
        _ptr(out_x, ctypes.c_uint8), _ptr(out_y, ctypes.c_int32))
    return out_x, out_y


class HostStreamingSplit:
    """A shuffled train split that stays on the host and streams to the
    device a batch (or a chunk of ``chunk_batches`` batches) at a time.

    ``images`` is uint8 NHWC, and may be a read-only ``np.load(...,
    mmap_mode="r")`` memmap: the C++ gather reads the mapped pages. An
    epoch yields ``n // (batch_size * chunk_batches)`` transfers and drops
    the tail. Epoch e (counting from 0 for this split) is ordered by
    ``permutation(n, seed + e)``. ``transfer_dtype="uint8"`` (the default)
    moves raw pixels and the training step normalizes them on the device;
    ``"float32"`` moves batches that ``dataio.cc`` normalized on the host.
    With ``chunk_batches=M > 1`` a transfer is (M, batch, H, W, C) and (M,
    batch). One C++ stream serves every epoch of the split, rewound with
    ``ursa_stream_reset``.

    ``stats`` counts, over the split's life, the transfers, their bytes
    (images and labels), the host's seconds inside ``ursa_stream_next``
    (``wait_s``), all the host's seconds in ``epoch``'s iterator (``host_s``:
    the wait, the slot's release, the copies' launch) and, on a GPU, the
    copy stream's seconds (``copy_s``, from CUDA events around each
    transfer's two copies, their launch included; read at the end of each
    epoch).

    On a data mesh (``mesh``, a ``parallel.Mesh`` with a chain axis of 1,
    or ``data=(data_idx, data)``) the split streams one data rank's share:
    its ``mesh.data_rows(batch_size)`` rows of every global batch of the
    same permutation, gathered and copied by ``dataio.cc`` (its row
    window), so a transfer moves 1/data of a batch (of each of a chunk's M
    batches). ``batch_size`` and ``num_batches`` stay the global batch's;
    ``local_batch`` is the rows a rank receives. A chain axis above 1, or a
    batch the data axis does not divide, raises ValueError (the JAX
    package's conditions)."""

    _handle = None  # the C++ stream, made at the first epoch

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int, spec,
                 shuffle: bool = True, seed: int = 0, transfer_dtype: str = "uint8",
                 chunk_batches: int = 1, stage_depth: int = _STAGE_DEPTH, mesh=None,
                 data: Optional[Tuple[int, int]] = None):
        if transfer_dtype not in ("uint8", "float32"):
            raise ValueError(f"transfer_dtype must be 'uint8' or 'float32', got {transfer_dtype!r}")
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"images must be uint8 NHWC, got {images.dtype} {images.shape}")
        if batch_size < 1 or chunk_batches < 1 or stage_depth < 1:
            raise ValueError("batch_size, chunk_batches and stage_depth must be >= 1")
        self.images = images
        self.labels = np.asarray(labels, np.int64)
        self.batch_size = batch_size
        self.spec = spec
        self.shuffle = shuffle
        self.seed = seed
        self.transfer_dtype = transfer_dtype
        self.chunk_batches = chunk_batches
        self.stage_depth = stage_depth
        if mesh is not None:
            if data is not None:
                raise ValueError("pass a mesh or data=(data_idx, data), not both")
            if mesh.shape["chain"] != 1:
                raise ValueError("streamed epochs shard over 'data' only: the mesh's chain "
                                 f"axis must be 1, got {mesh.shape}")
            data = (mesh.data_idx, mesh.shape["data"])
        data_idx, shards = (0, 1) if data is None else (int(data[0]), int(data[1]))
        if not 0 <= data_idx < shards:
            raise ValueError(f"data rank {data_idx} of {shards}")
        if batch_size % shards:
            raise ValueError(f"a batch of {batch_size} does not split over {shards} data ranks")
        self.data_layout = (data_idx, shards)
        self.local_batch = batch_size // shards
        self.epochs_started = 0
        self.stats = {"transfers": 0, "bytes": 0, "wait_s": 0.0, "host_s": 0.0, "copy_s": 0.0}
        self._handle_refs = None  # the library and the arrays the C++ stream reads
        self._slots = None  # (device, [(x, y)]): the staging ring
        self._copy_stream = None

    @property
    def n(self) -> int:
        return self.images.shape[0]

    @property
    def num_chunks(self) -> int:
        return self.n // (self.batch_size * self.chunk_batches)

    @property
    def num_batches(self) -> int:
        return self.num_chunks * self.chunk_batches

    def __del__(self):
        handle, self._handle = self._handle, None
        if handle is not None:
            self._handle_refs[0].ursa_stream_destroy(handle)

    def _rows(self) -> int:
        """The global rows a transfer covers."""
        return self.batch_size * self.chunk_batches

    def _local_rows(self) -> int:
        """The rows a transfer moves to this rank."""
        return self.local_batch * self.chunk_batches

    def _window(self, rows: np.ndarray) -> np.ndarray:
        """This rank's rows of a transfer's global ``rows`` of the order."""
        d, _ = self.data_layout
        lo = d * self.local_batch
        return rows.reshape(-1, self.batch_size)[:, lo:lo + self.local_batch].reshape(-1)

    def _yield_shapes(self):
        item = tuple(self.images.shape[1:])
        if self.chunk_batches > 1:
            return ((self.chunk_batches, self.local_batch) + item,
                    (self.chunk_batches, self.local_batch))
        return (self.local_batch,) + item, (self.local_batch,)

    def _native(self) -> bool:
        """Whether ``dataio.cc``'s stream takes this split: any uint8
        transfer, float32 up to 16 channels."""
        return self.transfer_dtype == "uint8" or self.images.shape[3] <= _MAX_AFFINE_CHANNELS

    def _ring(self, device: torch.device):
        """``stage_depth`` (x, y) host slots, pinned for a GPU; made once."""
        if self._slots is None or self._slots[0] != device:
            rows, item = self._local_rows(), int(np.prod(self.images.shape[1:]))
            dtype = torch.uint8 if self.transfer_dtype == "uint8" else torch.float32
            pin = device.type == "cuda"
            self._slots = (device, [(torch.empty((rows, item), dtype=dtype, pin_memory=pin),
                                     torch.empty(rows, dtype=torch.int32, pin_memory=pin))
                                    for _ in range(self.stage_depth)])
            self._copy_stream = torch.cuda.Stream(device) if pin else None
        return self._slots[1]

    def _ensure_stream(self, lib, epoch_seed: int):
        """The C++ prefetch stream, made once and rewound for later epochs."""
        seed, shuf = epoch_seed & (2 ** 64 - 1), int(self.shuffle)
        if self._handle is not None:
            lib.ursa_stream_reset(self._handle, seed, shuf)
            return self._handle
        images = np.ascontiguousarray(self.images, np.uint8)
        labels = np.ascontiguousarray(self.labels, np.int64)
        mean = np.ascontiguousarray(self.spec.mean, np.float32)
        std = np.ascontiguousarray(self.spec.std, np.float32)
        n, h, w, c = images.shape
        if self.transfer_dtype == "uint8":
            handle = lib.ursa_stream_create_u8(
                _ptr(images, ctypes.c_uint8), _ptr(labels, ctypes.c_int64), n, h * w * c,
                self._rows(), seed, shuf, 2)
        else:
            handle = lib.ursa_stream_create(
                _ptr(images, ctypes.c_uint8), _ptr(labels, ctypes.c_int64), n, h * w, c,
                self._rows(), _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
                seed, shuf, 2)
        if not handle:
            raise RuntimeError("ursa_stream_create refused the split")
        self._handle = handle
        self._handle_refs = (lib, images, labels, mean, std)
        d, shards = self.data_layout
        if shards > 1 and lib.ursa_stream_window(handle, self.batch_size, d * self.local_batch,
                                                 self.local_batch, seed, shuf) != 0:
            raise RuntimeError("ursa_stream_window refused the split's data rank")
        return handle

    def _fill(self, epoch_seed: int, ring, free) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Fill ring slot ``t % stage_depth`` with transfer t and yield it,
        for every transfer of the epoch; ``free(i)`` is called before slot i
        is written. The host's wait goes to ``stats["wait_s"]``."""
        nt, rows = self.n // self._rows(), self._rows()
        local = self._local_rows()
        if self._native():
            lib = load_library()
            handle = self._ensure_stream(lib, epoch_seed)
            u8 = self.transfer_dtype == "uint8"
            nxt = lib.ursa_stream_next_u8 if u8 else lib.ursa_stream_next
            ptr = ctypes.POINTER(ctypes.c_uint8 if u8 else ctypes.c_float)

            def write(t, x, y):
                got = nxt(handle, ctypes.cast(x.data_ptr(), ptr), ctypes.cast(y.data_ptr(), _i32p))
                if got != t:
                    raise RuntimeError(f"ursa_stream_next returned batch {got}, expected {t}")
        else:  # float32 beyond dataio.cc's 16 channels: numpy, on this thread
            order = (permutation(self.n, epoch_seed) if self.shuffle
                     else np.arange(self.n, dtype=np.int64))

            def write(t, x, y):
                gather_normalize(self.images, self.labels,
                                 self._window(order[t * rows:(t + 1) * rows]),
                                 self.spec.mean, self.spec.std,
                                 out_x=x.numpy().reshape((local,) + self.images.shape[1:]),
                                 out_y=y.numpy())
        for t in range(nt):
            i = t % len(ring)
            free(i)
            t0 = time.perf_counter()
            write(t, *ring[i])
            self.stats["wait_s"] += time.perf_counter() - t0
            self.stats["transfers"] += 1
            self.stats["bytes"] += ring[i][0].nbytes + ring[i][1].nbytes
            yield ring[i]

    def epoch(self, device) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """One shuffled epoch of ``(x, y)`` on ``device``: x uint8 (or
        normalized float32) NHWC, y int64; with ``chunk_batches=M > 1``,
        shaped (M, batch, ...) and (M, batch). On a GPU each batch is ready
        for the stream that is current when it is yielded."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HostStreamingSplit.epoch: CUDA device requested but "
                               "torch.cuda.is_available() is False")
        epoch_seed = self.seed + self.epochs_started
        self.epochs_started += 1
        ring = self._ring(device)
        xs, ys = self._yield_shapes()
        host_s = 0.0
        t0 = time.perf_counter()
        if device.type != "cuda":
            for x, y in self._fill(epoch_seed, ring, lambda i: None):
                out = x.reshape(xs).clone(), y.reshape(ys).to(torch.int64)
                host_s += time.perf_counter() - t0
                yield out
                t0 = time.perf_counter()
            self.stats["host_s"] += host_s
            return
        copied = [None] * len(ring)  # each slot's last copy, as its end event
        timers = []

        def free(i):  # the slot's last copy has read it
            if copied[i] is not None:
                copied[i].synchronize()

        for t, (x, y) in enumerate(self._fill(epoch_seed, ring, free)):
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            with torch.cuda.stream(self._copy_stream):
                xd = torch.empty(x.shape, dtype=x.dtype, device=device)
                yd = torch.empty(y.shape, dtype=y.dtype, device=device)
                start.record()
                xd.copy_(x, non_blocking=True)
                yd.copy_(y, non_blocking=True)
                stop.record()
            copied[t % len(ring)] = stop
            timers.append((start, stop))
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(stop)
            xd.record_stream(consumer)
            yd.record_stream(consumer)
            out = xd.view(xs), yd.view(ys).to(torch.int64)
            host_s += time.perf_counter() - t0
            yield out
            t0 = time.perf_counter()
        self.stats["host_s"] += host_s
        if timers:
            timers[-1][1].synchronize()
            self.stats["copy_s"] += sum(a.elapsed_time(b) for a, b in timers) / 1e3
