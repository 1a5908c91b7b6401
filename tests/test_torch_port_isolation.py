"""The port stands alone: no module of convnet_tpu_torch, and not
chip_smoke.py, imports the JAX package `convnet_tpu` or JAX, and the two
packages' protobuf schemas load side by side in one process."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "convnet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("convnet_tpu", "jax")


def _imported_modules(path: Path):
    """Every module an import statement in the file names, at any depth."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_walk_sees_the_whole_port():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for want in ("convnet_tpu_torch/config.py", "convnet_tpu_torch/graph.py",
                 "convnet_tpu_torch/proto/__init__.py", "convnet_tpu_torch/ops/fused_pool_lrn.py",
                 "convnet_tpu_torch/cli/grad_check.py", "convnet_tpu_torch/models/zoo.py",
                 "convnet_tpu_torch/data/native.py", "convnet_tpu_torch/data/image_iterators.py",
                 "convnet_tpu_torch/utils/timers.py", "chip_smoke.py"):
        assert want in names
    assert _forbidden("convnet_tpu.graph") and _forbidden("jax.numpy")
    assert not _forbidden("convnet_tpu_torch.graph")


def test_entry_points_load_no_jax_and_no_jax_package():
    """The entry points, the CLIs and the zoo import neither JAX nor the
    JAX package, and none imports h5py when it is imported (the card's
    machine has none: checkpoints and the extract CLI's writer import it
    when they open a file)."""
    code = (
        "import sys\n"
        "import convnet_tpu_torch.trainer, convnet_tpu_torch.predictor\n"
        "import convnet_tpu_torch.data.datahandler, convnet_tpu_torch.config\n"
        "import convnet_tpu_torch.cli.train, convnet_tpu_torch.cli.extract\n"
        "import convnet_tpu_torch.cli.grad_check, convnet_tpu_torch.models.zoo\n"
        "import convnet_tpu_torch.data.native, convnet_tpu_torch.data.image_iterators\n"
        "import convnet_tpu_torch.utils.timers\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'convnet_tpu' or m.startswith('convnet_tpu.')\n"
        "             or m == 'h5py' or m.startswith('h5py.')\n"
        "             or m == 'PIL' or m.startswith('PIL.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_both_schemas_load_in_one_process():
    """The port's schema sits in a private descriptor pool: importing it
    beside the JAX package's (which registers convnet_config.proto in the
    default pool) raises no duplicate-file error, and each package's reader
    parses the same model alike, into its own message classes."""
    from convnet_tpu import config as jax_config
    from convnet_tpu.proto import convnet_config_pb2 as jax_pb
    from convnet_tpu_torch import config as pt_config
    from convnet_tpu_torch import proto as pt_pb

    assert pt_pb.SERIALIZED == jax_pb.DESCRIPTOR.serialized_pb
    path = str(REPO / "examples" / "imagenet" / "alexnet.pbtxt")
    jm, pm = jax_config.read_model(path), pt_config.read_model(path)
    assert (len(pm.layer), len(pm.edge)) == (len(jm.layer), len(jm.edge)) == (14, 13)
    assert type(pm) is pt_pb.Model and type(pm) is not type(jm)
    assert pt_config.model_to_text(pm) == jax_config.model_to_text(jm)
    assert pt_pb.Edge.EdgeType.Name(pm.edge[0].edge_type) == "CONV"
    for enum in ("Activation", "LossFunction"):
        assert dict(getattr(pt_pb.Layer, enum).items()) == dict(getattr(jax_pb.Layer, enum).items())


def test_readers_are_lenient_unless_strict(tmp_path, capsys):
    """The port's reader, as the JAX package's (tests/test_config.py):
    unknown fields warn and parse by default, and fail under strict mode
    (CONVNET_STRICT_PBTXT=1 or set_strict)."""
    from google.protobuf import text_format

    from convnet_tpu_torch import config as pt_config

    bad = tmp_path / "bad.pbtxt"
    bad.write_text('name: "m"\nfuture_field_xyz: 3\n'
                   'layer { name: "input" is_input: true num_channels: 1 image_size: 4 }\n')
    assert pt_config.read_model(str(bad)).name == "m"
    assert "unknown to this schema" in capsys.readouterr().err
    pt_config.set_strict(True)
    try:
        with pytest.raises(text_format.ParseError):
            pt_config.read_model(str(bad))
    finally:
        pt_config.set_strict(False)
    with pytest.raises(FileNotFoundError):
        pt_config.read_model(str(tmp_path / "missing.pbtxt"))
