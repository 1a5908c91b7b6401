"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_port_*.py
that hold the port against the JAX package): not a test file itself.

Two things, both about comparing f32 results at rtol 1e-5.

`warm_torch_cpu_math`, run once when this module is imported (pytest imports
every test file before it runs a test, in every xdist worker, so that is
before any comparison). In this PyTorch build `torch.sqrt` on the CPU goes to
MKL's vector math library in chunks of at least 2048 elements, one chunk an
OpenMP thread. When the first `torch.sqrt` of a process is such a parallel
call, now and then some threads return their chunk with only about 11 good
bits (3e-4 relative); every later call is exact. That was the intermittent
failure of the f32 LRN comparisons: always the first test of the first port
file a worker ran, one eighth of the batch off, and the port's side, not
JAX's (against float64 the port was 3.1e-4 off, JAX 2.4e-7). In 120 fresh
processes each way, 5 first parallel calls were off and none that followed a
one-thread call, so the warm-up makes that one-thread call, for sqrt and for
the other functions the plain versions take from the same library.
`python tests/torch_port_parity.py 120` repeats that count.

`jax_reference_numerics`, an autouse fixture in every module that imports it.
For the length of each test the JAX reference runs

- at matmul precision "highest": the reference LRN sums its channel window
  with a band matmul;
- without JAX's persistent compilation cache: tests/test_cli.py runs the CLIs
  in-process, which turn the cache on (`enable_compilation_cache`) for the
  rest of that pytest worker, so a later test could run an executable that
  another process compiled. Clearing the directory setting alone is not
  enough once the cache has been opened, so the cache is reset as well.

Neither caused the failure above (it came back with both pinned); they stay
because a parity test should not depend on what an earlier test left behind.
Both are restored afterwards: tests that follow on the worker see the cache
setting the CLIs left. The precision is part of JAX's trace context, so a
function jitted by an earlier test is traced and compiled afresh under it.
"""

import subprocess
import sys

import pytest
import torch

import jax
from jax.experimental.compilation_cache import compilation_cache


def warm_torch_cpu_math() -> None:
    """First use of the CPU's vector math functions on one thread: a tensor
    far below the 2048 elements at which a unary op is split over threads."""
    one = torch.ones(8, dtype=torch.float32)
    for fn in (torch.sqrt, torch.exp, torch.log, torch.tanh):
        assert torch.isfinite(fn(one)).all()


warm_torch_cpu_math()


@pytest.fixture(autouse=True)
def jax_reference_numerics():
    saved_dir = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        jax.config.update("jax_compilation_cache_dir", saved_dir)
        compilation_cache.reset_cache()


# One fresh process of the count above: some JAX work on 8 virtual CPU
# devices, one computation still in flight (as in a parity test), then the
# process's first parallel torch.sqrt, after a one-thread call or not.
_PROBE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, torch
rng = np.random.default_rng(0)
for k in (64, 256, 512):
    a = jnp.asarray(rng.standard_normal((k, k)).astype(np.float32))
    (a @ a).block_until_ready()
pending = jax.jit(lambda v: jnp.tanh(v) * 2)(jnp.asarray(rng.standard_normal((128, 144)).astype(np.float32)))
v = torch.from_numpy(rng.uniform(0.1, 1.0, (1152, 16)).astype(np.float32))
if sys.argv[1] == "warm":
    torch.sqrt(torch.ones(8))
want = np.sqrt(v.numpy().astype(np.float64))
print(float((np.abs(torch.sqrt(v).numpy() - want) / want).max()))
"""


def _probe(runs: int, at_once: int = 8) -> None:
    """Prints, for `runs` fresh processes each way, how many first parallel
    torch.sqrt calls were more than 1e-6 off float64 (8 processes at a time:
    the failure wants a loaded machine)."""
    for mode in ("cold", "warm"):
        errs = []
        for start in range(0, runs, at_once):
            procs = [
                subprocess.Popen([sys.executable, "-c", _PROBE, mode], stdout=subprocess.PIPE,
                                 stderr=subprocess.DEVNULL, text=True)
                for _ in range(min(at_once, runs - start))
            ]
            errs += [float(p.communicate()[0]) for p in procs]
        off = [e for e in errs if e > 1e-6]
        print(f"{mode}: {len(off)} of {runs} first parallel torch.sqrt calls off"
              + (f", worst {max(off):.3g}" if off else ""))


if __name__ == "__main__":
    _probe(int(sys.argv[1]) if len(sys.argv) > 1 else 120)
