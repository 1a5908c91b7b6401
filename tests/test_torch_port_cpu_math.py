"""The port guards itself against a fault of some PyTorch CPU builds: the
first `torch.sqrt` of a process, when it is split over OpenMP threads, now
and then returns some threads' chunks with about 11 good bits (3e-4
relative), which put the plain LRN chain 3e-4 off a 1e-4 bar. Importing
`convnet_tpu_torch.ops` (which every module that computes imports) first
calls sqrt, exp, log and tanh once on one thread (`warm_cpu_math`).

These tests run fresh processes that import only the port, never JAX, the
JAX package or tests/torch_port_parity.py (whose own warm-up would hide a
missing one)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(REPO))

# Records every call of the four functions made while the port is imported.
_SEEN = """
import torch
calls = []
for name in ("sqrt", "exp", "log", "tanh"):
    def wrap(x, *a, _f=getattr(torch, name), _n=name, **k):
        calls.append((_n, x.numel(), torch.get_num_threads()))
        return _f(x, *a, **k)
    setattr(torch, name, wrap)
import {module}
print(sorted({{n for n, size, _ in calls if size < 2048}}))
"""

# One fresh process of the count: the port imported, then the process's
# first parallel torch.sqrt, held to float64.
_PROBE = """
import numpy as np, torch
import convnet_tpu_torch.model, convnet_tpu_torch.predictor
v = torch.from_numpy(np.random.default_rng(0).uniform(0.1, 1.0, (1152, 16)).astype(np.float32))
want = np.sqrt(v.numpy().astype(np.float64))
print(float((np.abs(torch.sqrt(v).numpy() - want) / want).max()))
"""


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_port_import_warms_each_vector_math_function():
    """The entry points' imports make a small call to each of the four
    functions before any plain-version math can run."""
    for module in ("convnet_tpu_torch.model", "convnet_tpu_torch.optim",
                   "convnet_tpu_torch.ops.lrn"):
        assert _run(_SEEN.format(module=module)) == "['exp', 'log', 'sqrt', 'tanh']", module


def test_first_parallel_sqrt_after_the_port_is_exact():
    """In 48 fresh processes that import the port (8 at a time: the fault
    wants a loaded machine), the first parallel torch.sqrt is within 1e-6
    of float64 every time."""
    errs = []
    for _ in range(6):
        procs = [subprocess.Popen([sys.executable, "-c", _PROBE], cwd=REPO, env=ENV,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for _ in range(8)]
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
            errs.append(float(out))
    off = [e for e in errs if e > 1e-6]
    assert not off, f"{len(off)} of {len(errs)} first parallel sqrt calls off, worst {max(off)}"
