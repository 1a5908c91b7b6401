"""The references: each provides what the benchmark takes from one
(`cellbench/reference/__init__.py`); the shared reader of the model text
and frozen copy of the port's draws; and, at float32 where rounding cannot
hide a difference of meaning, each reference's agreement with the port's
train step to round-off (the witness that the reference means what the
port means)."""

import re
import time

import numpy as np
import pytest
import torch

from cellbench import check, harness, reference
from cellbench.reference import draws, net
from cellbench.reference.textproto import parse
from cellbench.tests import join, tiny


def assert_interface(module, model: str, crop: int):
    """The reference `module` provides every name of the interface, its
    Net of `model` at `crop` too, and that Net's layers, edges and
    optimizers."""
    def has(obj, names, what):
        missing = [n for n in names if not hasattr(obj, n)]
        assert not missing, f"{module.__name__}: {what} lacks {missing}"

    has(module, reference.MODULE, "the module")
    n = module.Net(model, crop)
    has(n, reference.NET, "Net")
    has(n.input, reference.INPUT, "Net.input")
    has(n.output, reference.OUTPUT, "Net.output")
    for layer in n.layers.values():
        has(layer, reference.LAYER, "a layer")
    for e in n.edges:
        has(e, reference.EDGE, "an edge")
        has(e.wopt, reference.OPTIM, "an optimizer")
        has(e.bopt, reference.OPTIM, "an optimizer")
    assert set(n.param_shapes()) == {e.name for e in n.weighted}


@pytest.mark.parametrize("module,model", [(net, tiny.MODEL), (join, tiny.JOIN_MODEL)])
def test_each_reference_provides_the_interface(module, model):
    assert_interface(module, model, 16)


def test_the_interface_is_written_down_and_covers_what_the_harness_reads():
    doc = reference.__doc__
    for names in (reference.MODULE, reference.NET, reference.INPUT, reference.OUTPUT,
                  reference.LAYER, reference.EDGE, reference.OPTIM):
        for name in names:
            assert f"`{name}" in doc or f"`.{name}" in doc, name
    root = tiny.REPO / "cellbench"
    read = set()
    for path in root.rglob("*.py"):
        if not {"reference", "tests"} & set(path.relative_to(root).parts):
            read |= set(re.findall(r"\bnet\.(\w+)", path.read_text()))
    assert read <= set(reference.NET), read - set(reference.NET)


@pytest.mark.parametrize("cell", ["alexnet.train.b1024", "alexnet_local.train.b1024"])
def test_the_cells_reference_is_the_shared_net(cell):
    c = harness.Cell(tiny.REPO, cell)
    direct = net.Net("\n".join(c.config["model"]), c.config["crop"])
    assert c.reference.__file__ == net.__file__
    assert c.net.param_shapes() == direct.param_shapes()
    assert c.net.flops_per_image() == direct.flops_per_image()


def test_textproto():
    msg = parse('name: "a" # note\nlayer { name: "x" dropprob: 0.5 }\nlayer { is_input: true }\n'
                'edge { edge_type: CONV weight_optimizer { l2_decay: 5e-4 } }')
    assert msg["name"] == ["a"]
    assert msg["layer"] == [{"name": ["x"], "dropprob": [0.5]}, {"is_input": [True]}]
    assert msg["edge"][0]["edge_type"] == ["CONV"]
    assert msg["edge"][0]["weight_optimizer"][0]["l2_decay"] == [5e-4]
    with pytest.raises(ValueError):
        parse("layer { name: 1")


@pytest.mark.parametrize("seed,step", [(5, 0), (2**31 + 77, 3), (4_000_000_011, 2**33 + 1)])
def test_draws_follow_the_port(seed, step):
    from convnet_tpu_torch.data.jitter import crop_draw
    from convnet_tpu_torch.ops.dropout import dropout_reference, step_draws

    rng = torch.tensor([seed, step], dtype=torch.int64)
    keys, (oy, ox, fl) = step_draws(rng, [(10, 0), (11, 0)],
                                    crop_draw("input", 9, 256, 256, 224, True, True))
    roy, rox, rfl = draws.crops(seed, step, "input", 9, 256, 224, "cpu")
    assert oy.tolist() == roy.tolist() and ox.tolist() == rox.tolist()
    assert fl.tolist() == rfl.tolist()
    assert [tuple(k) for k in keys.tolist()] == [draws.layer_key(seed, step, i) for i in (10, 11)]
    x = torch.randn(3, 1, 1, 40)
    kept = dropout_reference(x, 0.5, keys[1]) != 0
    assert torch.equal(kept, draws.keep_mask(x.numel(), draws.layer_key(seed, step, 11), 0.5,
                                             "cpu").view(x.shape))


@pytest.mark.parametrize("config,cell", [("CONFIG", "tiny.train"),
                                         ("JOIN_CONFIG", "tinyjoin.train")])
def test_float32_port_matches_the_reference(tmp_path, monkeypatch, config, cell):
    cfg = getattr(tiny, config)
    model = [l for l in cfg["model"] if "activation_dtype" not in l]
    model = [l.replace('"bfloat16"', '"float32"') for l in model]
    monkeypatch.setitem(cfg, "model", model)
    root = tiny.make_root(tmp_path)
    got = {}
    harness.run(root, cell, 31, 0.1, False, torch.device("cpu"), time.perf_counter(),
                readings=got)
    for k in ("grad_gap", "change_gap", "after_grad_gap", "after_change_gap"):
        assert got[k] < 1e-5, (k, got[k])
    assert max(v for k, v in got.items() if ":" in k) < 1e-5


def test_logit_gap_ignores_a_common_shift():
    p = np.array([[0.7, 0.2, 0.1]])
    q = np.exp(np.log(p) + 0.3)
    assert check.logit_gap([(0, q / q.sum())], {0: p}) == pytest.approx(0.0, abs=1e-12)
    assert check.logit_gap([(0, p[:, ::-1])], {0: p}) > 0.5
    assert check.logit_gap([(0, np.full((1, 3), np.nan))], {0: p}) == float("inf")
