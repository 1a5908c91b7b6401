"""Host-side batches: streams, chunked shuffle, the shuffle window and the
prefetch thread (counterpart of `convnet_tpu/data/datahandler.py`).

The JAX module cannot be imported without JAX (it imports
`convnet_tpu.data.jitter`), so the port has its own, with all six stream
types: DUMMY, with the same seeded draws, so that its batches are
array-equal to the JAX handler's; HDF5, read (as the mean files are) by
the port's own HDF5 module (`convnet_tpu_torch/hdf5.py`, no h5py);
RAW_CACHE, gathered by the port's g++-built C++ core
(`data/native.py`); and IMAGE_RAW, SLIDING_WINDOW and TXT
(`data/image_iterators.py`). A stream whose reader can take one of two
backends names it in `backend`. All streams advance in lockstep over one
shared index sequence, so image and label rows stay aligned.
"""

from __future__ import annotations

import abc
import queue
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from convnet_tpu_torch import hdf5
from convnet_tpu_torch import proto as pb
from convnet_tpu_torch.data.jitter import JitterSpec

DT = pb.DataStreamConfig.DataType


def _load_mean_std(path: str):
    with hdf5.File(path, "r") as f:
        mean = f["mean"][...] if "mean" in f else None
        std = f["std"][...] if "std" in f else None
    return mean, std


class Stream(abc.ABC):
    """One named data source. Subclasses define row count and reads;
    `backend` names the reader where a stream type has more than one, and
    `backend_reason` why a stream did not take its first choice."""

    backend: Optional[str] = None
    backend_reason: Optional[str] = None

    def __init__(self, cfg: pb.DataStreamConfig):
        self.cfg = cfg

    @property
    @abc.abstractmethod
    def num_rows(self) -> int:
        """Rows in the stream."""

    @abc.abstractmethod
    def read_rows(self, indices: np.ndarray) -> np.ndarray:
        """The rows at `indices`, stacked on a leading axis."""

    def close(self):
        """Release file handles (optional per subclass)."""

    def _maybe_reshape_images(self, arr: np.ndarray) -> np.ndarray:
        """Flat (N, H*W*C) rows -> (N, H, W, C) when the config gives a
        spatial size."""
        size = self.cfg.raw_image_size or self.cfg.image_size
        if arr.ndim == 2 and size and arr.shape[1] == size * size * self.cfg.num_colors:
            return arr.reshape(-1, size, size, self.cfg.num_colors)
        return arr


class HDF5Stream(Stream):
    """Rows of an HDF5 dataset: a contiguous one through a memory map of
    the file, a chunked one chunk by chunk (`hdf5.py`)."""

    def __init__(self, cfg: pb.DataStreamConfig):
        super().__init__(cfg)
        if not cfg.file_pattern:
            raise ValueError(f"stream {cfg.layer_name}: HDF5 needs file_pattern")
        self._file = hdf5.File(cfg.file_pattern, "r")
        key = cfg.dataset_name or cfg.layer_name
        if key not in self._file:
            raise KeyError(
                f"dataset {key!r} not in {cfg.file_pattern} (has {list(self._file.keys())})"
            )
        self._ds = self._file[key]

    @property
    def num_rows(self) -> int:
        return self._ds.shape[0]

    def read_rows(self, indices: np.ndarray) -> np.ndarray:
        return self._maybe_reshape_images(self._ds[indices])

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


class DummyStream(Stream):
    """Synthetic data, drawn as the JAX package's DummyStream draws it."""

    def __init__(self, cfg: pb.DataStreamConfig):
        super().__init__(cfg)
        self._n = cfg.dummy_size
        # crc32, not hash(): the same rows in every process
        rng = np.random.RandomState(zlib.crc32(cfg.layer_name.encode()) % (2**31))
        size = cfg.raw_image_size or cfg.image_size
        if size:
            shape = (self._n, size, size, cfg.num_colors)
            self._data = rng.randint(0, 256, shape, dtype=np.uint8)
        else:
            self._data = rng.randint(0, max(2, cfg.dummy_num_classes), (self._n,), dtype=np.int32)

    @property
    def num_rows(self) -> int:
        return self._n

    def read_rows(self, indices: np.ndarray) -> np.ndarray:
        return self._data[indices]


class RawCacheStream(Stream):
    """Rows of a raw cache (`data/native.py`), gathered by the port's C++
    core; `write_raw_cache` makes one."""

    backend = "native"

    def __init__(self, cfg: pb.DataStreamConfig):
        super().__init__(cfg)
        from convnet_tpu_torch.data.native import RawCacheReader

        if not cfg.file_pattern:
            raise ValueError(f"stream {cfg.layer_name}: RAW_CACHE needs file_pattern")
        self._reader = RawCacheReader(cfg.file_pattern)

    @property
    def num_rows(self) -> int:
        return self._reader.num_rows

    def read_rows(self, indices: np.ndarray) -> np.ndarray:
        return self._maybe_reshape_images(self._reader.gather(indices))

    def close(self):
        self._reader.close()


def make_stream(cfg: pb.DataStreamConfig) -> Stream:
    if cfg.data_type == DT.HDF5:
        return HDF5Stream(cfg)
    if cfg.data_type == DT.RAW_CACHE:
        return RawCacheStream(cfg)
    if cfg.data_type == DT.DUMMY:
        return DummyStream(cfg)
    if cfg.data_type in (DT.IMAGE_RAW, DT.SLIDING_WINDOW, DT.TXT):
        from convnet_tpu_torch.data import image_iterators as it

        kind = {DT.IMAGE_RAW: it.RawImageStream, DT.SLIDING_WINDOW: it.SlidingWindowStream,
                DT.TXT: it.TxtStream}[cfg.data_type]
        return kind(cfg)
    raise ValueError(f"unknown data_type {cfg.data_type}")


class DataHandler:
    """Batches over a DatasetConfig: {layer_name: numpy rows}.

    randomize=None takes the config's randomize_cpu; pass False for a
    deterministic order. The same config and seed give the same batches
    as the JAX package's DataHandler."""

    def __init__(
        self,
        cfg: pb.DatasetConfig,
        batch_size: Optional[int] = None,
        randomize: Optional[bool] = None,
        seed: int = 0,
    ):
        if not cfg.data_config:
            raise ValueError("DatasetConfig has no data_config streams")
        self.cfg = cfg
        self.batch_size = batch_size or cfg.batch_size
        self.randomize = cfg.randomize_cpu if randomize is None else randomize
        self.streams: Dict[str, Stream] = {c.layer_name: make_stream(c) for c in cfg.data_config}
        sizes = {n: s.num_rows for n, s in self.streams.items()}
        self.num_rows = min(sizes.values())
        if cfg.max_dataset_size > 0:
            self.num_rows = min(self.num_rows, cfg.max_dataset_size)
        if len(set(sizes.values())) > 1:
            print(f"DataHandler: stream sizes differ {sizes}; using {self.num_rows}")
        self._rng = np.random.RandomState(seed)
        self._chunk = max(1, cfg.random_access_chunk_size)
        self._order = self._make_order()
        self._pos = 0
        # randomize_gpu: random picks from a window of chunk_size rows (auto:
        # 4x batch) staged on the host and refilled in stream order
        self._window = 0
        if cfg.randomize_gpu:
            w = cfg.chunk_size if cfg.chunk_size > 0 else 4 * self.batch_size
            self._window = int(min(max(w, self.batch_size), max(self.batch_size, self.num_rows)))
        self._wbuf: Optional[Dict[str, np.ndarray]] = None
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._closed = False
        if cfg.pipeline_loads:
            self._start_prefetch(max(1, cfg.prefetch_depth))

    # -- ordering -----------------------------------------------------------

    def _make_order(self) -> np.ndarray:
        idx = np.arange(self.num_rows)
        if self.randomize:
            # shuffle at random_access_chunk granularity: contiguous runs
            starts = np.arange(0, self.num_rows, self._chunk)
            self._rng.shuffle(starts)
            idx = np.concatenate(
                [np.arange(s, min(s + self._chunk, self.num_rows)) for s in starts]
            )
        return idx

    @property
    def num_batches(self) -> int:
        return self.num_rows // self.batch_size

    # -- batch production ---------------------------------------------------

    def _next_indices(self) -> np.ndarray:
        if self._pos + self.batch_size > self.num_rows:
            self._order = self._make_order()
            self._pos = 0
        idx = self._order[self._pos : self._pos + self.batch_size]
        self._pos += self.batch_size
        return idx

    def _read(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {name: s.read_rows(idx) for name, s in self.streams.items()}

    def _produce(self) -> Dict[str, np.ndarray]:
        if self._window:
            return self._produce_windowed()
        return self._read(self._next_indices())

    def _produce_windowed(self) -> Dict[str, np.ndarray]:
        """Emit batch_size random rows of the window; refill their slots
        with the next rows in stream order."""
        bs = self.batch_size
        if self._wbuf is None:
            fills = [self._next_indices() for _ in range(-(-self._window // bs))]
            self._wbuf = self._read(np.concatenate(fills))
        n = next(iter(self._wbuf.values())).shape[0]
        pos = self._rng.choice(n, bs, replace=False)
        out = {k: v[pos].copy() for k, v in self._wbuf.items()}
        refill = self._read(self._next_indices())
        for k, v in self._wbuf.items():
            v[pos] = refill[k]
        return out

    def _start_prefetch(self, depth: int):
        self._queue = queue.Queue(maxsize=depth)

        def worker():
            try:
                while not self._stop.is_set():
                    batch = self._produce()
                    while not self._stop.is_set():
                        try:
                            self._queue.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # handed to get_batch, which re-raises
                self._error = e
                self._stop.set()

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def get_batch(self) -> Dict[str, np.ndarray]:
        """Next {layer_name: rows} batch (blocks on the prefetch queue).
        Re-raises a prefetch error; raises RuntimeError if the handler was
        closed while waiting."""
        if self._queue is not None:
            while True:
                try:
                    return self._queue.get(timeout=0.2)
                except queue.Empty:
                    if self._error is not None:
                        raise RuntimeError("DataHandler prefetch failed") from self._error
                    if self._stop.is_set():
                        raise RuntimeError("DataHandler closed while waiting for batch")
        return self._produce()

    def iter_epoch(self, include_partial: bool = True):
        """One sequential pass, yielding (batch, valid_rows); the last
        partial batch is padded by repeating its last row. Bypasses the
        shuffle order and the prefetch queue."""
        bs = self.batch_size
        for start in range(0, self.num_rows, bs):
            idx = np.arange(start, min(start + bs, self.num_rows))
            valid = len(idx)
            if valid < bs:
                if not include_partial:
                    return
                idx = np.concatenate([idx, np.full(bs - valid, idx[-1])])
            yield self._read(idx), valid

    def reset(self):
        """Restart from the beginning; the streams stay open."""
        if self._closed:
            raise RuntimeError("DataHandler is closed; create a new one")
        self._stop_prefetch()
        self._error = None
        self._pos = 0
        self._wbuf = None
        self._order = self._make_order()
        self._stop = threading.Event()
        if self.cfg.pipeline_loads:
            self._start_prefetch(max(1, self.cfg.prefetch_depth))

    def _stop_prefetch(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._queue = None

    def close(self):
        """Stop prefetch and release the streams. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop_prefetch()
        for s in self.streams.values():
            s.close()

    # -- metadata for the trainer ------------------------------------------

    def backends(self) -> Dict[str, str]:
        """{layer_name: reader} for the streams whose type has more than
        one reader ("native" or "pil" for IMAGE_RAW, "native" for RAW_CACHE)."""
        return {n: s.backend for n, s in self.streams.items() if s.backend is not None}

    def backend_log(self) -> List[str]:
        """One line a stream of `backends()`: its reader and, where it did
        not take its first choice, why."""
        return [
            f"stream {n} is read by the {s.backend} reader"
            + (f" ({s.backend_reason})" if s.backend_reason else "")
            for n, s in self.streams.items() if s.backend is not None
        ]

    def input_image_sizes(self) -> Dict[str, int]:
        """{layer_name: final (cropped) image size} for image streams."""
        return {c.layer_name: c.image_size for c in self.cfg.data_config if c.image_size}

    def jitter_specs(
        self,
    ) -> Dict[str, Tuple[JitterSpec, Optional[np.ndarray], Optional[np.ndarray]]]:
        """{layer_name: (JitterSpec, mean, std)} for image streams."""
        out = {}
        for c in self.cfg.data_config:
            if not c.image_size:
                continue
            mean = std = None
            if c.mean_file:
                mean, std = _load_mean_std(c.mean_file)
                if not c.normalize:
                    std = None
            spec = JitterSpec(
                image_size=c.image_size,
                can_translate=c.can_translate,
                can_flip=c.can_flip,
                scale=c.scale,
                normalize=c.normalize,
            )
            out[c.layer_name] = (spec, mean, std)
        return out
