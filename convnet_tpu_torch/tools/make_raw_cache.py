"""Convert an HDF5 dataset to the memory-mapped raw cache format
(DataStreamConfig.data_type: RAW_CACHE) that the C++ gather reads
(counterpart of `tools/make_raw_cache.py`; the same bytes). The rows are
read `--chunk` at a time, so a dataset larger than memory converts.

Usage:
    python -m convnet_tpu_torch.tools.make_raw_cache IN.h5 DATASET OUT.cache
"""

from __future__ import annotations

import argparse

from convnet_tpu_torch import hdf5
from convnet_tpu_torch.data.native import write_raw_cache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input")
    p.add_argument("dataset")
    p.add_argument("output")
    p.add_argument("--chunk", type=int, default=4096)
    args = p.parse_args(argv)

    with hdf5.File(args.input, "r") as f:
        ds = f[args.dataset]
        write_raw_cache(args.output, ds, chunk_rows=args.chunk)
        n = ds.shape[0]
    print(f"wrote {args.output}: {n} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
