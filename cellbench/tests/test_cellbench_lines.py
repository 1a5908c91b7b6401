"""Each cell's path at a tiny size on the CPU gives a result line of the
contract's shape, and the command refuses to run without a card."""

import json
import subprocess
import sys

import pytest

from cellbench import harness
from cellbench.tests.tiny import REPO


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_line_shape(root, run_cell, cell, trace):
    line = run_cell(cell, 2**31 + 97, trace=trace)
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": None}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]
    if trace:
        # no device time, and no share of a card's peak, from a CPU run
        host = {m["name"] for m in harness.Cell(root, cell).per_layer
                if m["source"] == "host_clock" and m["unit"] != "%"}
        assert set(line["metrics"]) <= host and "breakdown" not in line
    else:
        kind = cell.split(".")[1]
        want = {"setup_s", f"{kind}_images_per_s"}
        assert set(line["metrics"]) == want
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_command_needs_a_card():
    got = subprocess.run([sys.executable, "-m", "cellbench.run", "--workload",
                          "alexnet.train.b1024", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert got.returncode != 0 and got.stdout == ""
    assert "CUDA card" in got.stderr
