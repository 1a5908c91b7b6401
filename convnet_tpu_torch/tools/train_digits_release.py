"""Train the released digits network with the port (counterpart of
`tools/train_digits_release.py`): `examples/digits/digits.pbtxt` on
sklearn's 8x8 handwritten digits, its only data, split 1500/297 at seed 0
into HDF5 files written by the port's own HDF5 module; the final
checkpoint is copied to --output.

    python -m convnet_tpu_torch.tools.train_digits_release --output PATH.h5 \
        [--device cuda|cpu]

The tool never writes into `examples/`. Where sklearn does not import it
exits naming sklearn: there is no stand-in data. About a minute on a CPU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

from convnet_tpu_torch import checkpoint, config, hdf5
from convnet_tpu_torch.cli import add_device_argument, resolve_device
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.trainer import Trainer

DIGITS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "examples", "digits", "digits.pbtxt")
DATA_TPL = """name: "%s"
batch_size: 64
randomize_cpu: %s
pipeline_loads: true
data_config { layer_name: "input" data_type: HDF5
              file_pattern: "%s"
              dataset_name: "data" image_size: 8
              num_colors: 1 scale: 0.00392156862 }
data_config { layer_name: "labels" data_type: HDF5
              file_pattern: "%s"
              dataset_name: "labels" }
"""


def load_digits():
    """sklearn's digits dataset; SystemExit naming sklearn where it does not
    import."""
    try:
        from sklearn.datasets import load_digits as load
    except ImportError as e:
        raise SystemExit(f"train_digits_release needs sklearn's digits, its only data: {e}")
    return load()


def write_shards(outdir: str):
    """Deterministic 1500/297 split of the sklearn digits (seed 0), as
    {"train": path, "val": path}."""
    d = load_digits()
    images = (d.images * (255.0 / 16.0)).astype(np.uint8)[..., None]
    labels = d.target.astype(np.int64)
    order = np.random.RandomState(0).permutation(len(images))
    paths = {}
    for name, idx in [("train", order[:1500]), ("val", order[1500:])]:
        p = os.path.join(outdir, f"{name}.h5")
        with hdf5.File(p, "w") as f:
            f.create_dataset("data", data=images[idx])
            f.create_dataset("labels", data=labels[idx])
        paths[name] = p
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--output", required=True, help="where the trained checkpoint goes")
    add_device_argument(p)
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_shards(tmp)
        train = DataHandler(config.parse_dataset_config(
            DATA_TPL % ("train", "true", paths["train"], paths["train"])), seed=0)
        val = DataHandler(config.parse_dataset_config(
            DATA_TPL % ("val", "false", paths["val"], paths["val"])), randomize=False)
        try:
            graph = build_graph(config.read_model(DIGITS), train.input_image_sizes())
            out = os.path.join(tmp, "out")
            tr = Trainer(graph, train, val, checkpoint_dir=out, log_fn=print, device=dev)
            tr.train()
            err, loss = tr.validate()
            print(f"final val err {err:.4f} loss {loss:.4f}")
            shutil.copy(checkpoint.latest(out, graph.name), a.output)
        finally:
            train.close()
            val.close()
    print("wrote", a.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
