"""Compute the mean/std statistics file that DataStreamConfig.mean_file
names (counterpart of `tools/compute_mean.py`; the same values). Streams
over an HDF5 image dataset and writes "mean" and "std" datasets, either
full-pixel (size, size, colors) or per-channel (--per-channel).

Usage:
    python -m convnet_tpu_torch.tools.compute_mean DATA.h5 MEAN.h5 \
        [--dataset data] [--per-channel]
"""

from __future__ import annotations

import argparse

import numpy as np

from convnet_tpu_torch import hdf5


def mean_std(ds, per_channel: bool, chunk: int):
    """(mean, std) in float64 of the rows of `ds`, read `chunk` rows at a
    time: over rows, or over rows and pixels with `per_channel`."""
    acc = acc2 = None
    total = 0
    for start in range(0, ds.shape[0], chunk):
        block = ds[start : start + chunk].astype(np.float64)
        if per_channel:
            block = block.reshape(-1, block.shape[-1])
        s, s2 = block.sum(0), (block**2).sum(0)
        if acc is None:
            acc, acc2 = s, s2
        else:
            acc += s
            acc2 += s2
        total += block.shape[0]
    mean = acc / total
    return mean, np.sqrt(np.maximum(acc2 / total - mean**2, 1e-12))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--dataset", default="data")
    p.add_argument("--per-channel", action="store_true")
    p.add_argument("--chunk", type=int, default=1024)
    args = p.parse_args(argv)

    with hdf5.File(args.input, "r") as f:
        mean, std = mean_std(f[args.dataset], args.per_channel, args.chunk)
    with hdf5.File(args.output, "w") as f:
        f.create_dataset("mean", data=mean.astype(np.float32))
        f.create_dataset("std", data=std.astype(np.float32))
    print(f"wrote {args.output}: mean shape {mean.shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
