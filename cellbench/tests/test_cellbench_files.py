"""A configuration, a traffic mix, a cell and a per-layer metric are found
by name in files of their own: the tiny root adds all four with files and
entries alone, the repo's harness untouched."""

import json

import pytest

from cellbench import harness
from cellbench.tests.tiny import REPO, make_root

EXTRA = '''
def read(ctx):
    return None if ctx.kind != "train" else float(ctx.window["calls"])
'''


def test_added_files_are_found(tmp_path, run_cell):
    root = make_root(tmp_path, {"tiny.steps": EXTRA})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "tiny.steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "trainer",
                               "moves": "train_images_per_s", "workloads": ["tiny.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.Cell(root, "tiny.train")
    assert cell.config["name"] == "tiny" and cell.traffic["batch"] == 4
    assert "tiny.steps" in [m["name"] for m in cell.per_layer]
    line = run_cell("tiny.train", 5, trace=True, at=root)
    assert line["metrics"]["tiny.steps"]["value"] == line["attempted"]


def test_metrics_follow_their_cells():
    for name in ("alexnet.train.b1024", "alexnet_local.train.b1024"):
        cell = harness.Cell(REPO, name)
        assert [m["name"] for m in cell.end_to_end] == ["setup_s", "train_images_per_s"]
        assert all(m["moves"] == "train_images_per_s" for m in cell.per_layer)


def test_every_named_piece_has_its_file():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    data = REPO / "cellbench"
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()
        ref = json.loads((REPO / c["file"]).read_text()).get("reference",
                                                             harness.DEFAULT_REFERENCE)
        assert (data / "reference" / f"{ref}.py").exists(), (c["name"], ref)
    for w in bench["workloads"]:
        assert (data / "traffic" / f"{w['traffic']}.json").exists()
        assert (data / "limits" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (data / "metrics" / f"{m['name']}.py").exists()


def test_missing_reader_raises(root):
    with pytest.raises(FileNotFoundError):
        harness.Cell(root, "tiny.train").reader("no.such.metric")


def test_an_end_to_end_metric_is_a_quantity_of_the_kind(tmp_path, run_cell):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "train_images_per_s.other", "unit": "images/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(KeyError):
        run_cell("tiny.train", 3, at=root)
