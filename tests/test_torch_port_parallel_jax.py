"""The port's sharded train steps against the JAX package's on a mesh of
the same shape (tests/test_parallel.py's 8 virtual CPU devices, 4 of them),
from the same params, on the jobs of tests/test_torch_port_parallel.py
without crops and dropout (the packages draw them from other generators),
in a world of 4 ranks of their own. f32 at rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)
from test_torch_port_parallel import JOBS, MESHES, SEED, _assert_trees_close, _graph, spawn_jobs

from convnet_tpu import config as jax_config
from convnet_tpu import trainer as jax_trainer
from convnet_tpu.graph import build_graph as jax_build_graph
from convnet_tpu.parallel import mesh as jax_mesh
from convnet_tpu_torch import model as pt_model

RTOL = 1e-4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_jobs(["train_net_plain", "towers_plain"], tmp_path_factory.mktemp("world"))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("job", ["train_net_plain", "towers_plain"])
def test_sharded_steps_equal_jax_mesh(world, job, mesh):
    """Two steps against the JAX package's make_train_step on a mesh of
    the same shape over 4 of its virtual devices, from the same params.
    alexnet_2tower on 1x4 takes JAX's single-device step instead: XLA's
    SPMD partitioner aborts the process on a conv of 2 groups over 4 model
    shards (convolution_handler.cc: "Check failed: new_input_batch_size %
    new_output_batch_size == 0"), and JAX's sharded step is its
    single-device step on every mesh it partitions (tests/test_parallel.py)."""
    spec = JOBS[job]
    jg = jax_build_graph(jax_config.parse_model(spec["model_text"]), spec["sizes"])
    params = {n: {k: v.numpy() for k, v in p.items()}
              for n, p in pt_model.init_params(_graph(job), SEED).items()}
    jmesh = None
    if (job, mesh) != ("towers_plain", (1, 4)):
        jmesh = jax_mesh.make_mesh(*mesh, devices=jax.devices()[:4])
    state = jax_trainer.init_state(jg)
    state["params"] = jax.tree.map(jnp.asarray, params)
    state["moms"] = jax.tree.map(jnp.zeros_like, state["params"])
    step = jax_trainer.make_train_step(jg, mesh=jmesh)
    losses = []
    for batch in spec["batches"]:
        if jmesh is not None:
            batch = {k: jax.device_put(v, jax_mesh.batch_sharding(jmesh)) for k, v in batch.items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    got = world[0][job][mesh]
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], losses, rtol=RTOL)
    _assert_trees_close(got["params"], jax.device_get(state["params"]), f"{job} {mesh} params")
    _assert_trees_close(got["moms"], jax.device_get(state["moms"]), f"{job} {mesh} moms")
