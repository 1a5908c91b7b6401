"""On the card: every cell of BENCHMARK.json runs a short window at its
own size and comes out correct, traced and not. Skips without a card:
`python3 -m pytest cellbench/tests/test_cellbench_card.py` on the H100."""

import json
import time

import pytest
import torch

from cellbench import harness
from cellbench.tests.tiny import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own sizes on the H100")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(card, cell, trace):
    line = harness.run(REPO, cell, 5_000_000_000 + len(cell), 2.0, trace, card,
                       time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    names = {m["name"] for m in harness.Cell(REPO, cell).per_layer} if trace else {
        m["name"] for m in harness.Cell(REPO, cell).end_to_end}
    assert set(line["metrics"]) == names
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if m["unit"] == "%":
                assert 0 <= m["value"] <= 100, (name, m)
