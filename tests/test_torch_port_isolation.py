"""The port stands alone: no module of convnet_tpu_torch, and not
chip_smoke.py, imports the JAX package `convnet_tpu`, JAX, the repo's JAX
scripts under `tools/` or h5py (the port reads and writes HDF5 itself), its
HDF5 paths run with h5py blocked,
and the two packages' protobuf schemas load side by side in one process."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "convnet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("convnet_tpu", "jax", "tools")


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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_h5py(path):
    """The port's HDF5 goes through convnet_tpu_torch/hdf5.py, even where
    h5py is installed."""
    bad = [m for m in _imported_modules(path) if m == "h5py" or m.startswith("h5py.")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
    assert "import h5py" not in path.read_text()


def test_walk_sees_the_whole_port():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for want in ("convnet_tpu_torch/config.py", "convnet_tpu_torch/graph.py",
                 "convnet_tpu_torch/proto/__init__.py", "convnet_tpu_torch/ops/fused_pool_lrn.py",
                 "convnet_tpu_torch/cli/grad_check.py", "convnet_tpu_torch/models/zoo.py",
                 "convnet_tpu_torch/data/native.py", "convnet_tpu_torch/data/image_iterators.py",
                 "convnet_tpu_torch/utils/timers.py", "convnet_tpu_torch/hdf5.py",
                 "convnet_tpu_torch/tools/make_raw_cache.py",
                 "convnet_tpu_torch/tools/compute_mean.py",
                 "convnet_tpu_torch/tools/make_hdf5_dataset.py",
                 "convnet_tpu_torch/tools/dump_activations.py", "chip_smoke.py",
                 "convnet_tpu_torch/bench.py", "convnet_tpu_torch/utils/card.py",
                 "convnet_tpu_torch/tools/bench_pipeline.py",
                 "convnet_tpu_torch/tools/profile_alexnet.py",
                 "convnet_tpu_torch/tools/sweep.py",
                 "convnet_tpu_torch/tools/make_synth_dataset.py",
                 "convnet_tpu_torch/tools/train_digits_release.py",
                 "convnet_tpu_torch/tools/copy_probe.py",
                 "convnet_tpu_torch/tools/serving_probe.py"):
        assert want in names
    assert _forbidden("convnet_tpu.graph") and _forbidden("jax.numpy")
    assert _forbidden("tools.make_synth_dataset")
    assert not _forbidden("convnet_tpu_torch.graph")
    assert not _forbidden("convnet_tpu_torch.tools.sweep")


def test_entry_points_load_no_jax_and_no_jax_package():
    """The entry points, the CLIs, the tools and the zoo import neither JAX
    nor the JAX package, nor h5py, nor PIL."""
    code = (
        "import sys\n"
        "import convnet_tpu_torch.trainer, convnet_tpu_torch.predictor\n"
        "import convnet_tpu_torch.data.datahandler, convnet_tpu_torch.config\n"
        "import convnet_tpu_torch.cli.train, convnet_tpu_torch.cli.extract\n"
        "import convnet_tpu_torch.cli.grad_check, convnet_tpu_torch.models.zoo\n"
        "import convnet_tpu_torch.data.native, convnet_tpu_torch.data.image_iterators\n"
        "import convnet_tpu_torch.utils.timers, convnet_tpu_torch.hdf5\n"
        "import convnet_tpu_torch.tools.make_raw_cache, convnet_tpu_torch.tools.compute_mean\n"
        "import convnet_tpu_torch.tools.make_hdf5_dataset\n"
        "import convnet_tpu_torch.tools.dump_activations\n"
        "import convnet_tpu_torch.bench, convnet_tpu_torch.utils.card\n"
        "import convnet_tpu_torch.tools.bench_pipeline, convnet_tpu_torch.tools.sweep\n"
        "import convnet_tpu_torch.tools.profile_alexnet\n"
        "import convnet_tpu_torch.tools.make_synth_dataset\n"
        "import convnet_tpu_torch.tools.train_digits_release\n"
        "import convnet_tpu_torch.tools.copy_probe, convnet_tpu_torch.tools.serving_probe\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'convnet_tpu' or m.startswith('convnet_tpu.')\n"
        "             or m == 'h5py' or m.startswith('h5py.')\n"
        "             or m == 'tools' or m.startswith('tools.')\n"
        "             or m == 'PIL' or m.startswith('PIL.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# the repo's top-level entries that hold the JAX side's sources
JAX_SOURCE_ROOTS = ("convnet_tpu", "native", "tools")
_OUT_OF_PORT = re.compile(r"\.parent\s*/\s*[\"'](%s)[\"']" % "|".join(JAX_SOURCE_ROOTS))
_C_SUFFIXES = (".cc", ".cpp", ".c", ".h", ".cu", ".cuh")


def _holds_c_sources(path: Path) -> bool:
    if path.is_dir():
        return any(p.suffix in _C_SUFFIXES for p in path.rglob("*"))
    return path.suffix in _C_SUFFIXES


def test_the_port_builds_only_its_own_sources():
    """No file of the port names a source path outside convnet_tpu_torch/:
    no path is built by stepping out of the package into the JAX side's
    directories (`_PKG.parent / "native"`), and every path a port module
    holds that leads to C, C++ or CUDA sources lies inside the port."""
    for path in PORT_FILES:
        hits = _OUT_OF_PORT.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} names {hits} outside convnet_tpu_torch/"
    import importlib
    import pkgutil

    import convnet_tpu_torch

    port = (REPO / "convnet_tpu_torch").resolve()
    seen = 0
    for info in pkgutil.walk_packages(convnet_tpu_torch.__path__, "convnet_tpu_torch."):
        module = importlib.import_module(info.name)
        for name, value in vars(module).items():
            if not isinstance(value, Path):
                continue
            target = value.resolve()
            if target.exists() and _holds_c_sources(target):
                seen += 1
                assert target.is_relative_to(port), (
                    f"{info.name}.{name} = {target} lies outside convnet_tpu_torch/")
    assert seen >= 3  # csrc/, the raw-cache gather and the JPEG loader
    from convnet_tpu_torch.data import native
    from convnet_tpu_torch.ops import _build

    assert native.LOADER_SOURCE == port / "native" / "dataloader.cc"
    assert native.RAW_CACHE_SOURCE.parent == port / "native"
    assert all(src.is_relative_to(port / "csrc") for src in _build._sources())


def _c_abi(path: Path):
    """The extern "C" functions the file defines, as normalized signatures."""
    code = re.sub(r"\s+", " ", re.sub(r"//[^\n]*", "", path.read_text()))
    return sorted(re.findall(r"(?:void\*|int|void) loader_\w+\([^)]*\)(?= \{)", code))


def test_the_ports_jpeg_loader_keeps_the_c_abi():
    """The port's copy of the libjpeg loader defines the JAX package's
    loader_create / loader_load / loader_destroy with the same signatures
    (data/native.py binds them as the JAX module does), and no raw-cache
    half (raw_cache.cc has that)."""
    port_src = REPO / "convnet_tpu_torch" / "native" / "dataloader.cc"
    ours, theirs = _c_abi(port_src), _c_abi(REPO / "native" / "dataloader.cc")
    assert ours == theirs and len(ours) == 3
    assert sorted(s.split("(")[0].split()[-1] for s in ours) == [
        "loader_create", "loader_destroy", "loader_load"]
    assert "cache_gather" not in port_src.read_text()


PORT_NATIVE_SOURCES = sorted(
    p for ext in ("*.cc", "*.h", "*.cu", "*.cuh") for p in (REPO / "convnet_tpu_torch").rglob(ext))


@pytest.mark.parametrize("path", PORT_NATIVE_SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_source_includes_libjpeg(path):
    """The port decodes JPEG itself (native/jpeg_decode.h): no C++ or CUDA
    source of it includes jpeglib.h."""
    assert not re.search(r"#\s*include\s*[<\"]jpeglib\.h[>\"]", path.read_text())


def test_the_jpeg_loader_links_no_libjpeg():
    """The loader builds with g++ and data/native.py's flags alone: no
    -ljpeg among them, and the build it loads is keyed by those flags and by
    the decoder's header as well as dataloader.cc."""
    from convnet_tpu_torch.data import native

    assert native.LOADER_LIBS == ()
    assert not any("jpeg" in flag for flag in native.CXX_FLAGS + native.LOADER_LIBS)
    assert '#include "jpeg_decode.h"' in native.LOADER_SOURCE.read_text()
    assert PORT_NATIVE_SOURCES.count(native.LOADER_SOURCE.parent / "jpeg_decode.h") == 1
    lib = native._loader_lib()
    assert lib._name == str(native._library_path(native.LOADER_SOURCE, native.LOADER_LIBS))
    assert lib.jpeg_decode_file is not None


# With h5py blocked: a checkpoint saved and loaded, an HDF5 stream (its
# data written chunked by the port's writer) read with a mean file from
# the port's compute_mean tool, and the extract CLI on the CPU.
_NO_H5PY = '''
import sys
sys.modules["h5py"] = None
import numpy as np
from convnet_tpu_torch import checkpoint, config, hdf5
from convnet_tpu_torch import model as model_lib
from convnet_tpu_torch.cli import extract
from convnet_tpu_torch.data.datahandler import DataHandler
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.tools import compute_mean

d = sys.argv[1]
net = """
name: "n"
layer { name: "input" is_input: true num_channels: 3 image_size: 6 }
layer { name: "fc1" num_channels: 4 activation: TANH }
layer { name: "output" is_output: true num_channels: 3 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "fc1" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1 }
edge { source: "fc1" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN init_wt: 0.1 }
"""
open(f"{d}/n.pbtxt", "w").write(net)
g = build_graph(config.parse_model(net))
params = {k: {n: t.numpy() for n, t in p.items()} for k, p in model_lib.init_params(g).items()}
path = checkpoint.save(d, "n", params, params, step=5)
got, moms, step = checkpoint.load(path)
assert step == 5 and all(np.array_equal(got[k]["w"], params[k]["w"]) for k in params)
assert all(np.array_equal(moms[k]["b"], params[k]["b"]) for k in params)

rng = np.random.default_rng(0)
images = rng.integers(0, 256, (21, 8, 8, 3), dtype=np.uint8)
with hdf5.File(f"{d}/data.h5", "w") as f:
    f.create_appendable("data", (8, 8, 3), np.uint8, chunk_rows=4).append(images)
    f.create_dataset("labels", data=np.arange(21, dtype=np.int32) % 3)
assert compute_mean.main([f"{d}/data.h5", f"{d}/mean.h5"]) == 0
open(f"{d}/data.pbtxt", "w").write(f"""
name: "h" batch_size: 8 randomize_cpu: false pipeline_loads: false
data_config {{ layer_name: "input" data_type: HDF5 file_pattern: "{d}/data.h5"
              dataset_name: "data" image_size: 6 raw_image_size: 8 num_colors: 3
              mean_file: "{d}/mean.h5" }}
data_config {{ layer_name: "labels" data_type: HDF5 file_pattern: "{d}/data.h5"
              dataset_name: "labels" }}
""")
h = DataHandler(config.read_dataset_config(f"{d}/data.pbtxt"))
batch = h.get_batch()
assert np.array_equal(batch["input"], images[:8])
assert list(batch["labels"]) == [0, 1, 2, 0, 1, 2, 0, 1]
(_, mean, _), = h.jitter_specs().values()
assert np.array_equal(mean, images.astype(np.float64).mean(0).astype(np.float32))
h.close()
assert extract.main([f"{d}/n.pbtxt", f"{d}/data.pbtxt", "--checkpoint", path, "--output",
                     f"{d}/feats.h5", "--layers", "fc1", "--device", "cpu"]) == 0
with hdf5.File(f"{d}/feats.h5") as f:
    assert f["fc1"].shape == (21, 4) and np.isfinite(f["fc1"][...]).all()
print(sys.modules["h5py"] is None)
'''


def test_hdf5_paths_run_with_h5py_blocked(tmp_path):
    proc = subprocess.run([sys.executable, "-c", _NO_H5PY, str(tmp_path)], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "True"


def test_both_schemas_load_in_one_process():
    """The port's schema sits in a private descriptor pool: importing it
    beside the JAX package's (which registers convnet_config.proto in the
    default pool) raises no duplicate-file error, and each package's reader
    parses the same model alike, into its own message classes. The port's
    schema is the JAX package's bytes plus exactly the edge types CONCAT
    and AVGPOOL and the field Layer.loss_weight: every other message,
    field and enum value is the JAX package's."""
    from google.protobuf import descriptor_pb2

    from convnet_tpu import config as jax_config
    from convnet_tpu.proto import convnet_config_pb2 as jax_pb
    from convnet_tpu_torch import config as pt_config
    from convnet_tpu_torch import proto as pt_pb

    assert pt_pb.SERIALIZED == jax_pb.DESCRIPTOR.serialized_pb
    port = descriptor_pb2.FileDescriptorProto()
    pt_pb.DESCRIPTOR.CopyToProto(port)
    jax = descriptor_pb2.FileDescriptorProto.FromString(jax_pb.DESCRIPTOR.serialized_pb)
    msgs = {m.name: m for m in port.message_type}
    (edge_type,) = [e for e in msgs["Edge"].enum_type if e.name == "EdgeType"]
    added = [(v.name, v.number) for v in edge_type.value][-2:]
    assert added == [("CONCAT", 200), ("AVGPOOL", 201)]
    del edge_type.value[-2:]
    field = msgs["Layer"].field[-1]
    assert (field.name, field.number, field.type, field.default_value) == (
        "loss_weight", 200, descriptor_pb2.FieldDescriptorProto.TYPE_FLOAT, "1")
    del msgs["Layer"].field[-1]
    assert port == jax
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
