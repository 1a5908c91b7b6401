"""convnet_tpu_torch — the PyTorch/CUDA port of convnet_tpu for an NVIDIA H100.

The JAX package `convnet_tpu` stays the reference; this package runs the
same `.pbtxt` models through PyTorch. Two slices are ported: serving,
`Predictor` (predictor.py) over the eval forward, and training, `Trainer`
(trainer.py) over a `DataHandler` (data/datahandler.py) with the
reference's per-edge SGD (optim.py); every edge type of the JAX package,
so every example model; and the three CLIs (`cli/`: train, extract,
grad_check) and the model zoo (`models/`); and a model's `parallel {}`
mesh over ranks of a `torch.distributed` process group (`parallel/`: the
data axis as a gradient all-reduce, the model axis as the JAX package's
channel and column split); and its own HDF5 reader and writer
(`hdf5.py`), for checkpoints, HDF5 streams, mean files, the extract CLI's
output and the data tools (`tools/`), so it needs no h5py; and the
measurement scripts (`bench.py`, the headline AlexNet train img/s;
`tools/bench_pipeline.py`, `profile_alexnet.py`, `sweep.py`). Convolutions,
pooling and GEMMs and
their gradients go to cuDNN, cuBLAS and ATen through `torch.nn.functional`
and autograd, as the JAX package left them to XLA; the Pallas kernels of
those paths are hand-written CUDA kernels here (`csrc/`, bound in
`ops/_build.py`):

- `ops/lrn.py`: response norm forward with the conv bias and ReLU fused,
  and its backward with the bias gradient;
- `ops/dropout.py`: inverted dropout with a Philox mask redrawn in the
  backward;
- `ops/s2d_relayout.py`: the uint8 -> space-to-depth input prologue,
  with per-image crops and flips;
- `ops/pool.py`: the max pool forward, which where a gradient is wanted
  also writes each window's argmax as one byte, and the backward from it;
- `ops/fused_pool_lrn.py`: response norm then max pool, forward and
  backward (the reference's all-ties pool gradient), for the LRN -> pool
  chains of a train step under CONVNET_POOL_LRN_FUSED=1.

Each kernel has a plain PyTorch version beside it, which its wrapper
takes for CPU tensors. The package imports nothing of JAX and nothing of
the JAX package `convnet_tpu`: it has its own copy of the `.pbtxt` schema
(`proto/`), of the config reader (`config.py`) and of the graph IR
(`graph.py`).

Layouts at public functions are the JAX package's: NHWC activations,
HWIO conv weights, FC weights (H*W*C, units). An NHWC-contiguous tensor's
NCHW view is a channels_last tensor, which is what cuDNN is handed.
"""

__version__ = "0.1.0"
