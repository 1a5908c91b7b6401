"""Parallelism over a mesh of ranks (counterpart of `convnet_tpu/parallel`).

The reference split a model over GPUs by pinning layers to gpu_ids
(src/multigpu_convnet.cc [U]); the JAX package declares a (data, model)
device mesh and lets XLA insert the collectives. The port runs one process
a rank in a `torch.distributed` process group and writes each collective
out: the gradient all-reduce over the data axis, and the gathers and
all-reduces around each model-sharded edge (`mesh.py`).
"""

from convnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_rows,
    make_mesh,
    mesh_for_graph,
    param_shardings,
    state_shardings,
)
