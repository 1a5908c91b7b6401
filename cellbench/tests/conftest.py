"""Fixtures of the benchmark's CPU tests: a tiny root (tests/tiny.py) and
few CPU threads."""

import time

import pytest
import torch

from cellbench import harness
from cellbench.tests.tiny import make_root


@pytest.fixture(scope="session", autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.fixture
def run_cell(root):
    """run_cell(cell, seed, trace=False, seconds=0.2, root=root) -> the result line, on the CPU."""

    def run(cell, seed, trace=False, seconds=0.2, at=None, **kw):
        return harness.run(at or root, cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), **kw)

    return run
