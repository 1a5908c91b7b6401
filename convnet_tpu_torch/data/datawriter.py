"""Streaming HDF5 activation writer (counterpart of
`convnet_tpu/data/datawriter.py`): the extract CLI appends the chosen
layers' activations batch by batch, one f32 dataset of (rows, dims) per
layer, chunked and resizable, with the JAX writer's chunk shape. The port's
own HDF5 module (`convnet_tpu_torch/hdf5.py`) writes it: each chunk goes to
the file when its rows are in, so at most one chunk a layer is held, and
the chunk indexes are written at close.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from convnet_tpu_torch import hdf5


class DataWriter:
    """Appends (batch, dims) rows per named dataset."""

    def __init__(self, path: str, layer_dims: Dict[str, int]):
        self._file = hdf5.File(path, "w")
        self._dsets = {
            name: self._file.create_appendable(
                name, (dims,), np.float32, chunk_rows=max(1, 4096 // max(1, dims // 256)))
            for name, dims in layer_dims.items()
        }

    def append(self, batches: Dict[str, np.ndarray]):
        for name, arr in batches.items():
            self._dsets[name].append(np.asarray(arr, np.float32).reshape(arr.shape[0], -1))

    def close(self):
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
