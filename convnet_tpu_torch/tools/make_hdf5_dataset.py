"""Shard an image list into the HDF5 layout the data layer reads
(counterpart of `tools/make_hdf5_dataset.py`).

Usage:
    python -m convnet_tpu_torch.tools.make_hdf5_dataset LIST.txt OUT.h5 \
        --size 32 [--labels LABELS.txt] [--colors 3]

LIST.txt: one image path per line (relative paths resolve against the
list file's directory). LABELS.txt: one integer per line, aligned.
Output: datasets "data" (N, size, size, colors) uint8, chunked by 128 rows
and written a chunk at a time, and "labels" (N,) int32.
"""

from __future__ import annotations

import argparse

import numpy as np

from convnet_tpu_torch import hdf5
from convnet_tpu_torch.data.image_iterators import _read_file_list, decode_and_resize


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("list_file")
    p.add_argument("output")
    p.add_argument("--size", type=int, required=True, help="stored square size")
    p.add_argument("--labels", default=None)
    p.add_argument("--colors", type=int, default=3)
    args = p.parse_args(argv)

    paths = _read_file_list(args.list_file)
    labels = None
    if args.labels:
        labels = np.loadtxt(args.labels, dtype=np.int32)
        assert len(labels) == len(paths), "labels/list length mismatch"

    with hdf5.File(args.output, "w") as f:
        ds = f.create_appendable("data", (args.size, args.size, args.colors), np.uint8,
                                 chunk_rows=max(1, min(128, len(paths))))
        for i, path in enumerate(paths):
            ds.append(decode_and_resize(path, args.size, args.colors)[None])
            if (i + 1) % 1000 == 0:
                print(f"{i + 1}/{len(paths)}")
        if labels is not None:
            f.create_dataset("labels", data=labels)
    print(f"wrote {args.output}: {len(paths)} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
