"""Streaming HDF5 activation writer (counterpart of
`convnet_tpu/data/datawriter.py`): the extract CLI appends the chosen
layers' activations batch by batch, one f32 dataset of (rows, dims) per
layer, chunked and resized as it grows, as the JAX package writes them.

h5py is imported when a file is opened, never when this module is
imported: the package imports and runs on machines without it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class DataWriter:
    """Appends (batch, dims) rows per named dataset, resizing as it goes."""

    def __init__(self, path: str, layer_dims: Dict[str, int]):
        import h5py

        self._file = h5py.File(path, "w")
        self._dsets = {}
        self._rows = {}
        for name, dims in layer_dims.items():
            self._dsets[name] = self._file.create_dataset(
                name,
                shape=(0, dims),
                maxshape=(None, dims),
                chunks=(max(1, 4096 // max(1, dims // 256)), dims),
                dtype=np.float32,
            )
            self._rows[name] = 0

    def append(self, batches: Dict[str, np.ndarray]):
        for name, arr in batches.items():
            arr = np.asarray(arr, np.float32).reshape(arr.shape[0], -1)
            ds = self._dsets[name]
            n = self._rows[name]
            ds.resize(n + arr.shape[0], axis=0)
            ds[n : n + arr.shape[0]] = arr
            self._rows[name] = n + arr.shape[0]

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
