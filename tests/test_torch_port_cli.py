"""The port's CLIs (convnet_tpu_torch.cli.{train,extract,grad_check}) and
model zoo on the CPU (`--device cpu`), mirroring tests/test_cli.py, and
held against the JAX package's: a checkpoint the port's train CLI writes
loads in the JAX package, and the features the two extract CLIs write from
it agree within 1e-4 of the largest |feature| (f32 model); grad_check's
pass or fail under --x64 is the JAX CLI's on the same models; the zoo's
constructors give the JAX zoo's layer shapes."""

import glob
import os

import h5py
import numpy as np
import pytest
import torch

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu import checkpoint as jax_ckpt
from convnet_tpu import config as jax_config
from convnet_tpu import model as jax_model
from convnet_tpu import models as jax_models
from convnet_tpu.cli import extract as jax_extract
from convnet_tpu.cli import grad_check as jax_grad_check
from convnet_tpu.graph import build_graph
from convnet_tpu_torch import checkpoint as ckpt
from convnet_tpu_torch import models
from convnet_tpu_torch.cli import extract, grad_check, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST = os.path.join(REPO, "examples/mnist/mnist_lenet.pbtxt")
DTRAIN = os.path.join(REPO, "examples/mnist/mnist_dummy_train.pbtxt")
DVAL = os.path.join(REPO, "examples/mnist/mnist_dummy_val.pbtxt")
AUTOENCODER = os.path.join(REPO, "examples/autoencoder/conv_autoencoder.pbtxt")
CPU = ["--device", "cpu"]

TINY = """
name: "t"
layer { name: "input" is_input: true num_channels: 4 image_size: 6 }
layer { name: "h" num_channels: 8 activation: TANH }
layer { name: "output" is_output: true num_channels: 3 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "h" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.2 }
edge { source: "h" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0 }
"""

# conv (ReLU, bias taken by the LRN) -> LRN -> max pool -> LOCAL ->
# CONV_ONETOONE -> FC: the model chip_smoke.py's phase 7c checks on the card
LRN_LOCAL = """
name: "lrn_local_check"
seed: 7
layer { name: "input" is_input: true num_channels: 3 image_size: 6 }
layer { name: "conv1" num_channels: 16 activation: RECTIFIED_LINEAR }
layer { name: "rnorm1" num_channels: 16 }
layer { name: "pool1" num_channels: 16 }
layer { name: "local2" num_channels: 8 activation: TANH }
layer { name: "mix3" num_channels: 8 activation: TANH }
layer { name: "output" is_output: true num_channels: 5 activation: SOFTMAX data_field: "labels" }
edge { source: "input" dest: "conv1" edge_type: CONV kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.3 init_bias: 1.0 }
edge { source: "conv1" dest: "rnorm1" edge_type: RESPONSE_NORM
       add_scale: 0.01 pow_scale: 0.75 frac_of_filters_response_norm: 0.3 }
edge { source: "rnorm1" dest: "pool1" edge_type: MAXPOOL kernel_size: 2 stride: 2 }
edge { source: "pool1" dest: "local2" edge_type: LOCAL kernel_size: 3 stride: 1 padding: 1
       initialization: DENSE_GAUSSIAN init_wt: 0.2 init_bias: 0.05 }
edge { source: "local2" dest: "mix3" edge_type: CONV_ONETOONE initialization: DENSE_GAUSSIAN init_wt: 0.3 }
edge { source: "mix3" dest: "output" edge_type: FC initialization: DENSE_GAUSSIAN_SQRT_FAN_IN init_wt: 1.0 }
"""


def _train(out, max_iter, *extra, model=MNIST):
    return train.main([model, DTRAIN, *extra, "--output-dir", out, "--max-iter", str(max_iter),
                       "--batch-size", "16", *CPU])


def test_train_then_extract_roundtrip_and_jax_reads_the_checkpoint(tmp_path):
    out = str(tmp_path / "run")
    assert train.main([MNIST, DTRAIN, DVAL, "--output-dir", out, "--max-iter", "4",
                       "--batch-size", "16", *CPU]) == 0
    ckpts = glob.glob(os.path.join(out, "*.h5"))
    assert len(ckpts) == 1
    assert os.path.exists(os.path.join(out, "mnist_lenet_train_log.txt"))
    assert os.path.exists(os.path.join(out, "mnist_lenet.pbtxt"))

    feats = str(tmp_path / "feats.h5")
    assert extract.main([MNIST, DVAL, "--checkpoint", ckpts[0], "--output", feats,
                         "--layers", "fc1", "--batch-size", "64", *CPU]) == 0
    with h5py.File(feats) as f:
        got = f["fc1"][...]
    assert got.shape == (1024, 128) and np.isfinite(got).all()

    # the JAX package loads the port's checkpoint and extracts the same rows
    g = build_graph(jax_config.read_model(MNIST), {"input": 28})
    params, moms, step = jax_ckpt.load(ckpts[0], expected_shapes=jax_model.param_shapes(g))
    assert step == 4 and moms is not None and set(params) == {e.name for e in g.weighted_edges}
    jfeats = str(tmp_path / "jax_feats.h5")
    assert jax_extract.main([MNIST, DVAL, "--checkpoint", ckpts[0], "--output", jfeats,
                             "--layers", "fc1", "--batch-size", "64"]) == 0
    with h5py.File(jfeats) as f:
        want = f["fc1"][...]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_train_resumes_from_checkpoint(tmp_path):
    out = str(tmp_path / "run")
    _train(out, 3)
    assert glob.glob(os.path.join(out, "*.h5"))
    assert _train(out, 6) == 0
    with h5py.File(sorted(glob.glob(os.path.join(out, "*.h5")))[-1]) as f:
        assert f.attrs["step"] == 6
    log = open(os.path.join(out, "mnist_lenet_train_log.txt")).read()
    assert "resumed from" in log and "at step 3" in log


def test_train_cli_clamps_a_mesh_and_refuses_several_steps_per_launch(tmp_path):
    out = str(tmp_path / "dp")
    with pytest.warns(UserWarning, match="4x1 mesh"):
        assert _train(out, 4, "--data-parallel", "4") == 0
    with h5py.File(glob.glob(os.path.join(out, "*.h5"))[0]) as f:
        assert f.attrs["step"] == 4
    # --steps-per-launch, once refused, now runs; its parameters are k = 1's
    params = []
    for k in ("1", "2"):
        out = str(tmp_path / f"spl{k}")
        assert _train(out, 4, "--steps-per-launch", k) == 0
        with h5py.File(glob.glob(os.path.join(out, "*.h5"))[0]) as f:
            assert f.attrs["step"] == 4
        params.append(ckpt.load(glob.glob(os.path.join(out, "*.h5"))[0])[0])
    for name, p in params[0].items():
        for key, v in p.items():
            np.testing.assert_array_equal(v, params[1][name][key])


@pytest.mark.parametrize("cli", ["train", "extract", "grad_check"])
def test_cli_without_a_card_fails_unless_asked_for_the_cpu(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "train": [MNIST, DTRAIN, "--output-dir", str(tmp_path)],
        "extract": [MNIST, DVAL, "--checkpoint", "x.h5", "--output", "y.h5", "--layers", "fc1"],
        "grad_check": [MNIST],
    }[cli]
    main = {"train": train.main, "extract": extract.main, "grad_check": grad_check.main}[cli]
    with pytest.raises(SystemExit, match="--device cpu"):
        main(argv)
    assert not os.listdir(tmp_path)


def test_grad_check_cli_passes_on_tiny_model(tmp_path):
    model = tmp_path / "tiny.pbtxt"
    model.write_text(TINY)
    assert grad_check.main([str(model), "--samples", "5", "--batch-size", "4", *CPU]) == 0


# pass (TINY), pass with the autoencoder's aliased target, and fail on the
# two conv1 leaves behind the LRN, whose math is f32 in both packages
@pytest.mark.parametrize("name,argv,rc", [
    ("tiny", [], 0),
    ("autoencoder", ["--image-size", "16"], 0),
    ("lrn_local", [], 1),
])
def test_grad_check_x64_gives_jax_pass_or_fail(name, argv, rc, tmp_path, capsys):
    path = {"autoencoder": AUTOENCODER}.get(name, str(tmp_path / f"{name}.pbtxt"))
    if name != "autoencoder":
        (tmp_path / f"{name}.pbtxt").write_text({"tiny": TINY, "lrn_local": LRN_LOCAL}[name])
    common = [path, "--x64", "--samples", "5", "--batch-size", "2", *argv]
    assert jax_grad_check.main(common) == rc
    jax_lines = capsys.readouterr().out.splitlines()
    # --x64 runs on the CPU whatever --device says
    assert grad_check.main(common + ["--device", "cuda"]) == rc
    lines = capsys.readouterr().out.splitlines()
    fails = sorted(l.split()[1] for l in lines if l.startswith("FAIL"))
    assert fails == sorted(l.split()[1] for l in jax_lines if l.startswith("FAIL"))
    assert len(fails) == (2 if rc else 0)


def test_grad_check_samples_in_jax_order():
    """With shared params the port's check draws JAX's samples: the same
    elements are perturbed and the errors agree in size."""
    from convnet_tpu import config as jc
    from convnet_tpu_torch import config as pc
    from convnet_tpu_torch import model as pt_model
    from convnet_tpu_torch.graph import build_graph as pt_build_graph

    jg, pg = build_graph(jc.parse_model(TINY)), pt_build_graph(pc.parse_model(TINY))
    jparams = {n: {k: np.asarray(v) for k, v in p.items()}
               for n, p in jax_model.init_params(jg, seed=0).items()}
    orig = pt_model.init_params
    pt_model.init_params = lambda graph, seed=None, device="cpu", dtype=torch.float32: \
        pt_model.params_from_numpy(jparams, device, dtype)
    try:
        jlog, plog = [], []
        jax_grad_check.check_graph(jg, 4, 5, log=jlog.append, use_x64=True, eps=1e-7)
        grad_check.check_graph(pg, 4, 5, log=plog.append, use_x64=True, eps=1e-7)
    finally:
        pt_model.init_params = orig
    assert [l.split()[1] for l in plog] == [l.split()[1] for l in jlog]
    for pl, jl in zip(plog, jlog):
        assert float(pl.split()[-1]) < 1e-6 and float(jl.split()[-1]) < 1e-6


def test_extract_rejects_unknown_layer(tmp_path):
    out = str(tmp_path / "run")
    _train(out, 1)
    ckpt = glob.glob(os.path.join(out, "*.h5"))[0]
    with pytest.raises(KeyError):
        extract.main([MNIST, DVAL, "--checkpoint", ckpt, "--output", str(tmp_path / "x.h5"),
                      "--layers", "nope", *CPU])


def test_extract_with_feature_extractor_config(tmp_path):
    out = str(tmp_path / "run")
    _train(out, 2)
    ckpt = glob.glob(os.path.join(out, "*.h5"))[0]
    feats = str(tmp_path / "fe.h5")
    fecfg = tmp_path / "fe.pbtxt"
    fecfg.write_text(f'output_file: "{feats}"\nlayer: "fc1"\nbatch_size: 100\n')
    assert extract.main([MNIST, DVAL, "--checkpoint", ckpt, "--config", str(fecfg), "--timing",
                         *CPU]) == 0
    with h5py.File(feats) as f:
        # 1024 rows at batch 100: the last batch of 24 is padded, then trimmed
        assert f["fc1"].shape == (1024, 128)


def test_profile_dir_writes_a_trace_and_warns_before_the_window(tmp_path):
    prof = tmp_path / "prof"
    assert _train(str(tmp_path / "run"), 16, "--profile-dir", str(prof)) == 0
    log = open(tmp_path / "run" / "mnist_lenet_train_log.txt").read()
    assert f"profile trace -> {prof}\n" in log
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    short = tmp_path / "short"
    assert _train(str(tmp_path / "run2"), 3, "--profile-dir", str(short)) == 0
    log = open(tmp_path / "run2" / "mnist_lenet_train_log.txt").read()
    assert "WARNING: profile_dir given but the run ended at step 3" in log
    assert not short.exists()


@pytest.mark.parametrize("name", ["mnist_lenet", "cifar10", "cifar10_local", "alexnet",
                                  "alexnet_local", "alexnet_2tower"])
def test_zoo_constructors_give_jax_shapes(name):
    g, want = getattr(models, name)(), getattr(jax_models, name)()
    assert g.shapes == want.shapes and g.name == want.name
    if name.startswith("alexnet"):
        assert getattr(models, name)(image_size=67).shapes == getattr(jax_models, name)(67).shapes
    assert models.from_pbtxt(MNIST).shapes == jax_models.from_pbtxt(MNIST).shapes
