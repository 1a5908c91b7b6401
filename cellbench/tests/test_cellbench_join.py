"""A configuration names its own plain reference: the tiny root's
"tinyjoin", whose layer join2 sums two convolutions of pool1, names
"join" (`join.py`), runs through the harness with it and comes out
correct; the shared `net` refuses the same model, with an error that names
the configuration and the module, and a reference with no file is an
error."""

import json

import pytest

from cellbench import harness
from cellbench.tests import tiny


@pytest.mark.parametrize("cell,trace", [("tinyjoin.train", False), ("tinyjoin.train", True),
                                        ("tinyjoin.serve", False)])
def test_join_runs_correct_with_its_own_reference(root, run_cell, cell, trace):
    c = harness.Cell(root, cell)
    assert c.reference.__file__ == str(root / "cellbench" / "reference" / "join.py")
    assert [e.name for e in c.net.edges if e.dest == "join2"] == ["conv2a", "conv2b"]
    line = run_cell(cell, 2**31 + 211, trace=trace)
    assert line["correct"] is True and line["attempted"] > 0, line["checks"]
    assert set(line["checks"]) == set(c.limits)


def _config(root, **kw):
    path = root / "cellbench" / "configs" / "tinyjoin.json"
    cfg = dict(tiny.JOIN_CONFIG, **kw)
    if cfg["reference"] is None:
        del cfg["reference"]
    path.write_text(json.dumps(cfg))


def test_the_shared_net_refuses_a_join(tmp_path):
    root = tiny.make_root(tmp_path)
    _config(root, reference=None)
    with pytest.raises(ValueError, match="configuration tinyjoin: reference net refuses the "
                                         "model: edge conv2b .*joins a second input"):
        harness.Cell(root, "tinyjoin.train")


def test_a_reference_with_no_file_raises(tmp_path):
    root = tiny.make_root(tmp_path)
    _config(root, reference="nosuch")
    with pytest.raises(FileNotFoundError, match="reference/nosuch.py"):
        harness.Cell(root, "tinyjoin.train")
