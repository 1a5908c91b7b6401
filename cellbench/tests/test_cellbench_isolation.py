"""Nothing under cellbench/ imports JAX or the JAX package, compared by
whole top-level name (so convnet_tpu_torch is not taken for convnet_tpu),
and the reference imports nothing of the port."""

import ast
import sys

from cellbench import harness
from cellbench.tests.tiny import REPO

ROOT = REPO / "cellbench"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules():
    return sorted(ROOT.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert len(_modules()) > 20
    for path in _modules():
        banned = set(_imports(path)) & {"jax", "jaxlib", "flax", "convnet_tpu"}
        assert not banned, f"{path} imports {banned}"


def test_the_reference_imports_nothing_of_the_port():
    ref = list((ROOT / "reference").rglob("*.py")) + [ROOT / "tests" / "join.py"]
    assert len(ref) > 4
    for path in ref:
        assert "convnet_tpu_torch" not in set(_imports(path)), path


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "convnet_tpu_torch_probe", sys)
    assert harness.banned_modules() == sorted(m for m in sys.modules
                                              if m.split(".")[0] in harness.BANNED)
    assert "convnet_tpu_torch_probe" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "convnet_tpu.trainer", sys)
    assert "convnet_tpu.trainer" in harness.banned_modules()
