"""GoogLeNet on the port (the schema's CONCAT and AVGPOOL edges and
`Layer.loss_weight`) against the benchmark's plain reference
(`cellbench/reference/googlenet.py`), on the CPU at a small size: the stem,
two inception blocks with a stride-2 pool between them, one auxiliary
head of weight 0.3 and the 7x7 average pool, at cut widths and a 112 crop;
and the full `examples/imagenet/port/googlenet.pbtxt` as a Graph."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cellbench import harness
from cellbench.reference import googlenet as ref
from convnet_tpu_torch import config, trainer
from convnet_tpu_torch import model as pt_model
from convnet_tpu_torch.cli.grad_check import check_graph
from convnet_tpu_torch.data.jitter import JitterSpec
from convnet_tpu_torch.graph import build_graph
from convnet_tpu_torch.models import googlenet
from convnet_tpu_torch.ops.concat import concat_channels
from convnet_tpu_torch.ops.pool import avgpool2d
from convnet_tpu_torch.predictor import Predictor

CROP = 112
INIT = "initialization: DENSE_UNIFORM_SQRT_FAN_IN init_wt: 1.7320508 init_bias: 0.2"
OPT = ("weight_optimizer { base_epsilon: 0.05 initial_momentum: 0.9 final_momentum: 0.9 "
       "l2_decay: 0.0002 } bias_optimizer { base_epsilon: 0.1 initial_momentum: 0.9 "
       "final_momentum: 0.9 }")


def _block(name, src, width, c1, c3r, c3, c5r, c5, pp):
    """An inception block's layers and edges, as googlenet.pbtxt writes them."""
    layers = [f'layer {{ name: "{name}_{b}" num_channels: {c} activation: RECTIFIED_LINEAR }}'
              for b, c in (("1x1", c1), ("3x3_reduce", c3r), ("3x3", c3), ("5x5_reduce", c5r),
                           ("5x5", c5), ("pool_proj", pp))]
    layers += [f'layer {{ name: "{name}_pool" num_channels: {width} }}',
               f'layer {{ name: "{name}" num_channels: {c1 + c3 + c5 + pp} }}']
    convs = [(src, "1x1", 1, 0), (src, "3x3_reduce", 1, 0), (f"{name}_3x3_reduce", "3x3", 3, 1),
             (src, "5x5_reduce", 1, 0), (f"{name}_5x5_reduce", "5x5", 5, 2),
             (f"{name}_pool", "pool_proj", 1, 0)]
    edges = [f'edge {{ source: "{s}" dest: "{name}_{b}" edge_type: CONV kernel_size: {k} '
             f'padding: {p} {INIT} {OPT} }}' for s, b, k, p in convs]
    edges.append(f'edge {{ source: "{src}" dest: "{name}_pool" edge_type: MAXPOOL '
                 'kernel_size: 3 stride: 1 padding: 1 }')
    edges += [f'edge {{ source: "{name}_{b}" dest: "{name}" edge_type: CONCAT }}'
              for b in ("1x1", "3x3", "5x5", "pool_proj")]
    return layers, edges


def small_model(dtype="float32", aux_weight=0.3):
    """The small GoogLeNet: 112 -> conv7/2 -> 56 -> pool -> 28 -> LRN ->
    1x1, 3x3 -> LRN -> pool -> 14 (block a; the aux head's 5x5/3 pool
    -> 4) -> pool -> 7 (block b) -> avgpool 7 -> dropout 0.4 -> FC."""
    a_layers, a_edges = _block("ia", "pool2", 16, 4, 4, 8, 2, 4, 4)
    b_layers, b_edges = _block("ib", "pool3", 20, 8, 6, 8, 2, 4, 4)
    layers = [
        f'layer {{ name: "input" is_input: true num_channels: 3 image_size: {CROP} }}',
        'layer { name: "conv1" num_channels: 8 activation: RECTIFIED_LINEAR }',
        'layer { name: "pool1" num_channels: 8 }', 'layer { name: "norm1" num_channels: 8 }',
        'layer { name: "conv2_reduce" num_channels: 8 activation: RECTIFIED_LINEAR }',
        'layer { name: "conv2" num_channels: 16 activation: RECTIFIED_LINEAR }',
        'layer { name: "norm2" num_channels: 16 }', 'layer { name: "pool2" num_channels: 16 }',
        *a_layers, 'layer { name: "pool3" num_channels: 20 }',
        'layer { name: "aux1_pool" num_channels: 20 }',
        'layer { name: "aux1_conv" num_channels: 8 activation: RECTIFIED_LINEAR }',
        'layer { name: "aux1_fc" num_channels: 16 activation: RECTIFIED_LINEAR dropprob: 0.7 }',
        'layer { name: "aux1_output" is_output: true num_channels: 10 activation: SOFTMAX '
        f'data_field: "labels" loss_weight: {aux_weight} }}',
        *b_layers, 'layer { name: "pool5" num_channels: 24 dropprob: 0.4 }',
        'layer { name: "output" is_output: true num_channels: 10 activation: SOFTMAX '
        'data_field: "labels" }',
    ]
    edges = [
        f'edge {{ source: "input" dest: "conv1" edge_type: CONV kernel_size: 7 stride: 2 '
        f'padding: 2 {INIT} {OPT} }}',
        'edge { source: "conv1" dest: "pool1" edge_type: MAXPOOL kernel_size: 3 stride: 2 }',
        'edge { source: "pool1" dest: "norm1" edge_type: RESPONSE_NORM add_scale: 0.0001 '
        'pow_scale: 0.75 frac_of_filters_response_norm: 0.625 }',
        f'edge {{ source: "norm1" dest: "conv2_reduce" edge_type: CONV kernel_size: 1 '
        f'{INIT} {OPT} }}',
        f'edge {{ source: "conv2_reduce" dest: "conv2" edge_type: CONV kernel_size: 3 '
        f'padding: 1 {INIT} {OPT} }}',
        'edge { source: "conv2" dest: "norm2" edge_type: RESPONSE_NORM add_scale: 0.0001 '
        'pow_scale: 0.75 frac_of_filters_response_norm: 0.3125 }',
        'edge { source: "norm2" dest: "pool2" edge_type: MAXPOOL kernel_size: 3 stride: 2 }',
        *a_edges,
        'edge { source: "ia" dest: "pool3" edge_type: MAXPOOL kernel_size: 3 stride: 2 }',
        'edge { source: "ia" dest: "aux1_pool" edge_type: AVGPOOL kernel_size: 5 stride: 3 }',
        f'edge {{ source: "aux1_pool" dest: "aux1_conv" edge_type: CONV kernel_size: 1 '
        f'{INIT} {OPT} }}',
        f'edge {{ source: "aux1_conv" dest: "aux1_fc" edge_type: FC {INIT} {OPT} }}',
        f'edge {{ source: "aux1_fc" dest: "aux1_output" edge_type: FC {INIT} {OPT} }}',
        *b_edges,
        'edge { source: "ib" dest: "pool5" edge_type: AVGPOOL kernel_size: 7 stride: 1 }',
        f'edge {{ source: "pool5" dest: "output" edge_type: FC {INIT} {OPT} }}',
    ]
    head = (f'name: "small_googlenet"\nseed: 5\ncompute_dtype: "{dtype}"\n'
            f'activation_dtype: "{dtype}"\n')
    return head + "\n".join(layers + edges)


def _graph(text):
    return build_graph(config.parse_model(text), {"input": CROP})


def _weights(net, seed=0):
    """The reference's parameters, "he"-scaled normals (cellbench.weights'
    rule), biases from the model file."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for e in net.weighted:
        shapes = net.param_shapes()[e.name]
        out[e.name] = {"w": torch.randn(shapes["w"], generator=gen)
                       * math.sqrt(2.0 / net.fan_in(e)),
                       "b": torch.full(shapes["b"], e.init_bias)}
    return out


def _clone(params):
    return {n: {k: v.detach().clone() for k, v in p.items()} for n, p in params.items()}


def test_small_port_matches_reference_forward_loss_and_grads():
    """f32: every head's logits, the weighted loss and every leaf's
    gradient. The bar, 2e-5 of each tensor's largest magnitude, is f32
    round-off: the port sums its convs in NHWC and the reference in NCHW,
    each layer in another order, over about 20 layers."""
    text = small_model()
    graph, net = _graph(text), ref.Net(text, CROP)
    assert pt_model.param_shapes(graph) == net.param_shapes()
    params = _weights(net)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((4, CROP, CROP, 3), generator=gen)
    labels = torch.randint(0, 10, (4,), generator=gen)
    leaves = [(n, k) for n in params for k in ("w", "b")]

    mine = _clone(params)
    for n, k in leaves:
        mine[n][k].requires_grad_(True)
    out = pt_model.apply_fn(graph, mine, {"input": x}, return_layers=[])
    loss, metrics = pt_model.loss_fn(graph, mine, {"input": x, "labels": labels}, train=False)
    grads = torch.autograd.grad(loss, [mine[n][k] for n, k in leaves])

    theirs = _clone(params)
    for n, k in leaves:
        theirs[n][k].requires_grad_(True)
    heads = net.heads(theirs, x.permute(0, 3, 1, 2))
    want_loss = sum(net.layers[h].loss_weight * F.cross_entropy(z, labels)
                    for h, z in heads.items())
    want = torch.autograd.grad(want_loss, [theirs[n][k] for n, k in leaves])

    assert sorted(heads) == ["aux1_output", "output"] and net.output.name == "output"
    for h, z in heads.items():
        got = out[f"{h}:preact"]
        torch.testing.assert_close(got, z, rtol=0, atol=2e-5 * z.abs().max().item())
    assert abs(loss.item() - want_loss.item()) <= 2e-5 * want_loss.item()
    assert set(metrics) == {"loss", "aux1_output/errors", "output/errors"}
    for (n, k), g, w in zip(leaves, grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5 * w.abs().max().item(),
                                   msg=f"{n}/{k}")


@pytest.mark.parametrize("rows", [128, 3])
def test_small_sgd_step_matches_reference(monkeypatch, rows):
    """One train step of the port (uint8 images, its crops, flips and
    dropout masks) against the reference's, also in blocks of 3 rows of the
    batch of 4 (each block's crops and masks its rows of the batch's): the
    loss to 1e-5 and each leaf's change to 1e-4 of its largest magnitude,
    f32 round-off through one step's gradient."""
    monkeypatch.setattr(ref, "ROWS", rows)
    text = small_model()
    graph, net = _graph(text), ref.Net(text, CROP)
    params = _weights(net, seed=2)
    gen = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (4, 120, 120, 3), dtype=torch.uint8, generator=gen)
    labels = torch.randint(0, 10, (4,), dtype=torch.int32, generator=gen)
    seed, scale, mean = 2**31 + 7, 1 / 255, 0.45
    jitter = {"input": (JitterSpec(CROP, True, True, scale=scale),
                        np.full((3,), mean, np.float32), None)}
    state = {"params": _clone(params), "step": 0, "seed": seed,
             "moms": {n: {k: torch.zeros_like(v) for k, v in p.items()}
                      for n, p in params.items()}}
    metrics = trainer.make_train_step(graph, jitter, unroll=1)(state, {"input": images,
                                                                      "labels": labels})
    theirs = _clone(params)
    got = ref.train_steps(net, theirs, [(images, labels)], seed, CROP, scale, mean, steps=1)
    assert abs(float(metrics["loss"]) - got["loss"][0]) <= 1e-5 * got["loss"][0]
    for n, p in theirs.items():
        for k, v in p.items():
            change, want = state["params"][n][k] - params[n][k], v - params[n][k]
            torch.testing.assert_close(change, want, rtol=0,
                                       atol=1e-4 * want.abs().max().item(), msg=f"{n}/{k}")


def _join_model(second_source="b", second_kind="CONCAT", channels=6):
    return "\n".join([
        'name: "j"',
        'layer { name: "x" is_input: true num_channels: 3 image_size: 8 }',
        'layer { name: "a" num_channels: 2 }', 'layer { name: "b" num_channels: 4 }',
        'layer { name: "p" num_channels: 3 }',
        f'layer {{ name: "cat" num_channels: {channels} }}',
        'layer { name: "out" is_output: true num_channels: 2 activation: SOFTMAX }',
        f'edge {{ source: "x" dest: "a" edge_type: CONV kernel_size: 1 {INIT} }}',
        f'edge {{ source: "x" dest: "b" edge_type: CONV kernel_size: 3 padding: 1 {INIT} }}',
        'edge { source: "x" dest: "p" edge_type: MAXPOOL kernel_size: 2 stride: 2 }',
        'edge { source: "a" dest: "cat" edge_type: CONCAT }',
        f'edge {{ source: "{second_source}" dest: "cat" edge_type: {second_kind} }}'
        if second_kind == "CONCAT" else
        f'edge {{ source: "{second_source}" dest: "cat" edge_type: {second_kind} '
        f'kernel_size: 1 {INIT} }}',
        f'edge {{ source: "cat" dest: "out" edge_type: FC {INIT} }}',
    ])


def test_concat_takes_its_sources_channels_in_edge_order():
    g = build_graph(config.parse_model(_join_model()))
    assert g.shapes["cat"] == (8, 8, 6)
    assert [e.source for e in g.incoming("cat")] == ["a", "b"]
    params = pt_model.init_params(g, seed=0)
    x = torch.randn((2, 8, 8, 3))
    out = pt_model.apply_fn(g, params, {"x": x}, return_layers=["a", "b", "cat"])
    assert torch.equal(out["cat"], torch.cat([out["a"], out["b"]], dim=3))
    assert torch.equal(concat_channels([out["b"], out["a"]])[..., :4], out["b"])


@pytest.mark.parametrize("args,match", [
    (dict(second_source="p", channels=5), "concatenated sources disagree on H, W"),
    (dict(channels=7), "num_channels=7 but its CONCAT edges bring 6"),
    (dict(second_kind="CONV"), "CONCAT edges mixed with other edge kinds"),
])
def test_concat_refusals(args, match):
    with pytest.raises(ValueError, match=f"layer cat: {match}"):
        build_graph(config.parse_model(_join_model(**args)))


def _pool_model(h, k, s, p=0):
    return "\n".join([
        'name: "a"',
        f'layer {{ name: "x" is_input: true num_channels: 5 image_size: {h} }}',
        'layer { name: "pool" num_channels: 5 }',
        'layer { name: "out" is_output: true num_channels: 2 activation: SOFTMAX }',
        f'edge {{ source: "x" dest: "pool" edge_type: AVGPOOL kernel_size: {k} stride: {s} '
        f'padding: {p} }}',
        f'edge {{ source: "pool" dest: "out" edge_type: FC {INIT} }}',
    ])


@pytest.mark.parametrize("h,k,s", [(14, 5, 3), (7, 7, 1), (9, 3, 2)])
def test_avgpool_matches_aten(h, k, s):
    g = build_graph(config.parse_model(_pool_model(h, k, s)))
    x = torch.randn((3, h, h, 5), dtype=torch.float64)
    got = pt_model.apply_fn(g, pt_model.init_params(g, dtype=torch.float64), {"x": x},
                            return_layers=["pool"])["pool"]
    want = F.avg_pool2d(x.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)
    assert g.shapes["pool"] == tuple(want.shape[1:])
    torch.testing.assert_close(got, want, rtol=1e-15, atol=0)
    torch.testing.assert_close(avgpool2d(x, k, s), want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("h,k,s,p", [(14, 5, 3, 1), (13, 5, 3, 0), (4, 5, 1, 0)])
def test_avgpool_refuses_partial_windows(h, k, s, p):
    with pytest.raises(ValueError, match="partial window"):
        build_graph(config.parse_model(_pool_model(h, k, s, p)))


def test_loss_weight_scales_its_heads_gradient():
    """Doubling the aux head's weight doubles the gradient of its own
    leaves and leaves the main head's own leaves' alone; a weight that is
    not positive is refused."""
    x = torch.randn((2, CROP, CROP, 3), generator=torch.Generator().manual_seed(4))
    batch = {"input": x, "labels": torch.tensor([1, 7])}
    grads = []
    for w in (0.3, 0.6):
        g = _graph(small_model(aux_weight=w))
        params = pt_model.init_params(g, seed=1)
        leaves = [params[n]["w"].requires_grad_(True) for n in ("aux1_fc:aux1_output",
                                                              "pool5:output")]
        grads.append(torch.autograd.grad(pt_model.loss_fn(g, params, batch, train=False)[0],
                                         leaves))
    torch.testing.assert_close(grads[1][0], 2 * grads[0][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(grads[1][1], grads[0][1], rtol=0, atol=0)
    for bad in (0, -0.3):
        with pytest.raises(ValueError, match="loss_weight must be positive"):
            _graph(small_model(aux_weight=bad))


def test_check_graph_passes_in_float64():
    """Finite differences in float64 at the default bar, 2e-3, for every
    edge after the stem's two LRNs; the three before them at 2e-2: the
    LRN's math stays f32 under --x64 (as in the JAX package), and its
    round-off, through differences at eps 1e-3, reads up to 7.4e-3 there."""
    stem = {"input:conv1": 2e-2, "norm1:conv2_reduce": 2e-2, "conv2_reduce:conv2": 2e-2}
    for seed in (0, 1):
        failures, worst = check_graph(_graph(small_model()), batch_size=2, samples=4,
                                      use_x64=True, device="cpu", seed=seed, tol_edges=stem,
                                      log=lambda *_: None)
        assert failures == 0, worst


def test_predict_labels_takes_the_main_head():
    """predict_labels reads the output of the largest loss_weight (the main
    head, though the aux head comes first), and the first of equal ones."""
    for w, want in ((0.3, "output"), (1.0, "aux1_output"), (2.0, "aux1_output")):
        g = _graph(small_model(aux_weight=w))
        assert [l.name for l in g.output_layers] == ["aux1_output", "output"]
        pred = Predictor(g, pt_model.init_params(g, seed=0), batch_size=3, device="cpu")
        x = np.random.default_rng(0).standard_normal((3, CROP, CROP, 3)).astype(np.float32)
        acts = pred({"input": x})[want]
        assert np.array_equal(pred.predict_labels({"input": x}),
                              acts.reshape(3, -1).argmax(-1))


def test_full_googlenet_graph_is_table_1():
    g = googlenet()
    assert (len(g.edges), len(g.weighted_edges)) == (118, 64)
    for layer, side in (("conv1", 112), ("pool1", 56), ("conv2", 56), ("pool2", 28),
                        ("pool3", 14), ("pool4", 7), ("aux1_pool", 4), ("aux2_pool", 4)):
        assert g.shapes[layer][:2] == (side, side), layer
    widths = [g.shapes[b][2] for b in ("i3a", "i3b", "i4a", "i4b", "i4c", "i4d", "i4e", "i5a",
                                       "i5b")]
    assert widths == [256, 480, 512, 512, 512, 528, 832, 832, 1024]
    assert [l.loss_weight for l in g.output_layers] == pytest.approx([0.3, 0.3, 1.0])
    cfg = harness._json(harness.ROOT / "cellbench" / "configs" / "googlenet.json")
    net = ref.Net("\n".join(cfg["model"]), cfg["crop"])
    assert pt_model.param_shapes(g) == net.param_shapes()
    count = sum(math.prod(s) for p in net.param_shapes().values() for s in p.values())
    assert count == 13_378_280 and net.flops_per_image() == 3_182_088_192
    assert net.output.name == "output" and net.output.channels == 1000
    with open(harness.ROOT / "examples" / "imagenet" / "port" / "googlenet.pbtxt") as f:
        text = f.read()
    # the configuration runs the example's model, cleared to one chip's
    # share, with zero biases beside the cell's he-scaled weights
    ran, example = (build_graph(config.parse_model(t)).edges
                    for t in ("\n".join(cfg["model"]), text))
    assert ran == tuple(dataclasses.replace(e, init_bias=0.0) for e in example)
    assert {round(e.init_bias, 6) for e in example} == {0.0, 0.2}


def test_reference_imports_neither_jax_nor_the_port():
    import ast

    path = harness.ROOT / "cellbench" / "reference" / "googlenet.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "dataclasses", "typing", "torch", "cellbench"}


def test_the_cell_reads_every_train_metric_and_the_joins():
    """The cell takes its configuration's reference and reports the train
    cells' end-to-end metric, the per-layer metrics they report, the two
    of the joins and the host's ms a step."""
    cell = harness.Cell(harness.ROOT, "googlenet.train.b2048")
    old = harness.Cell(harness.ROOT, "alexnet.train.b1024")
    assert cell.reference.__file__.endswith("reference/googlenet.py")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "train_images_per_s"]
    names = [m["name"] for m in cell.per_layer]
    # all but trainer.enqueue_ms, whose spin cannot hold a step of more
    # launches than CUDA's launch queue takes; trainer.host_ms reads the
    # host's side of the step from the profiled stretch instead
    assert names == [m["name"] for m in old.per_layer if m["name"] != "trainer.enqueue_ms"] + [
        "model.concat_ms", "kernels.concat_roofline", "trainer.host_ms"]
    assert cell.traffic["batch"] == 2048 and cell.config["reduced"] == ["parallel"]
    for name in names:
        cell.reader(name)


DUMMY = """
name: "dummy"
batch_size: 4
data_config { layer_name: "input" data_type: DUMMY image_size: 112 num_colors: 3
              scale: 0.00392156862 dummy_size: 64 }
data_config { layer_name: "labels" data_type: DUMMY dummy_size: 64 dummy_num_classes: 10 }
"""


def test_small_googlenet_trains_through_the_cli_and_serves_its_checkpoint(tmp_path):
    """The train CLI over DUMMY data (the Trainer, its step and the
    checkpoint writer), then a Predictor from the checkpoint: the labels
    of its main head."""
    import glob

    from convnet_tpu_torch.cli import train

    model, data = tmp_path / "small_googlenet.pbtxt", tmp_path / "dummy.pbtxt"
    model.write_text("checkpoint_after: 2\n" + small_model("bfloat16"))
    data.write_text(DUMMY)
    out = tmp_path / "run"
    assert train.main([str(model), str(data), "--output-dir", str(out), "--max-iter", "3",
                       "--batch-size", "4", "--device", "cpu"]) == 0
    path = sorted(glob.glob(str(out / "*.h5")))[-1]
    graph = _graph(small_model("bfloat16"))
    pred = Predictor.from_checkpoint(graph, path, batch_size=2, device="cpu")
    x = np.random.default_rng(1).standard_normal((2, CROP, CROP, 3)).astype(np.float32)
    labels = pred.predict_labels({"input": x})
    assert np.array_equal(labels, pred({"input": x})["output"].reshape(2, -1).argmax(-1))


def test_reference_provides_what_the_benchmark_takes():
    """Every name that `cellbench/reference/__init__.py` lists, on the
    module, its Net of the full model, its layers, edges and optimizers."""
    from cellbench import reference

    def has(obj, names):
        assert all(hasattr(obj, n) for n in names), [n for n in names if not hasattr(obj, n)]

    cfg = harness._json(harness.ROOT / "cellbench" / "configs" / "googlenet.json")
    has(ref, reference.MODULE)
    net = ref.Net("\n".join(cfg["model"]), cfg["crop"])
    for obj, names in ((net, reference.NET), (net.input, reference.INPUT),
                       (net.output, reference.OUTPUT)):
        has(obj, names)
    for layer in net.layers.values():
        has(layer, reference.LAYER)
    for e in net.edges:
        has(e, reference.EDGE)
        has(e.wopt, reference.OPTIM)
        has(e.bopt, reference.OPTIM)
    assert [e.name for e in net.weighted] == list(net.param_shapes())


def test_grouped_update_is_the_per_leaf_update_bit_for_bit():
    """apply_updates' grouped launches (`optim._update_group`, leaves that
    share l2, eps and momentum) give `_update_leaf`'s bits on every leaf of
    the small GoogLeNet, weights and biases, at a step where the schedule
    has decayed."""
    from convnet_tpu_torch import optim

    graph = _graph(small_model())
    params = pt_model.init_params(graph, seed=3)
    gen = torch.Generator().manual_seed(5)
    moms = {n: {k: torch.randn(v.shape, generator=gen) for k, v in p.items()}
            for n, p in params.items()}
    grads = {n: {k: torch.randn(v.shape, generator=gen) for k, v in p.items()}
             for n, p in params.items()}
    want_p, want_m = _clone(params), _clone(moms)
    for e, k, spec in optim._leaves(graph):
        optim._update_leaf(spec, want_p[e.name][k], want_m[e.name][k], grads[e.name][k],
                           optim.epsilon_at(spec, 7), optim.momentum_at(spec, 7))
    grads_before = _clone(grads)
    optim.apply_updates(graph, params, moms, grads, step=7)
    for n in params:
        for k in ("w", "b"):
            assert torch.equal(params[n][k], want_p[n][k]) and torch.equal(moms[n][k],
                                                                           want_m[n][k]), n
            assert torch.equal(grads[n][k], grads_before[n][k]), n


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_group_update_is_the_leaf_update_bit_for_bit_on_large_leaves(device):
    """`_update_group` over leaves of a few elements to several million
    (the card's foreach launches split these into many chunks) gives
    `_update_leaf`'s bits, and leaves the gradients as they were."""
    from convnet_tpu_torch import optim

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the card's foreach kernels run only there")
    gen = torch.Generator().manual_seed(11)
    sizes = [(7,), (96, 3, 3, 64), (1 << 20,), (3 * (1 << 20) + 5,)]
    ws, ms, gs = ([torch.randn(n, generator=gen).to(device) for n in sizes] for _ in range(3))
    spec = _graph(small_model()).weighted_edges[0].weight_optimizer
    l2, eps, mom = spec.l2_decay, optim.epsilon_at(spec, 7), optim.momentum_at(spec, 7)
    want_w, want_m = [w.clone() for w in ws], [m.clone() for m in ms]
    for w, m, g in zip(want_w, want_m, gs):
        optim._update_leaf(spec, w, m, g, eps, mom)
    g_before = [g.clone() for g in gs]
    optim._update_group(l2, eps, mom, ws, ms, gs)
    for i in range(len(sizes)):
        assert torch.equal(ws[i], want_w[i]) and torch.equal(ms[i], want_m[i]), sizes[i]
        assert torch.equal(gs[i], g_before[i]), sizes[i]


def test_host_ms_reads_the_profiled_steps_host_side():
    """`trainer.host_ms` reads the profiled stretch's mean `trainer.step`
    span, and nothing outside a train cell or where no stretch credits."""
    import types

    cell = harness.Cell(harness.ROOT, "googlenet.train.b2048")
    read = cell.reader("trainer.host_ms")
    spans = {"host_ms": 71.5, "busy_ms": 188.4, "stage": {}, "kind": {}, "site": {}}
    assert read(types.SimpleNamespace(kind="train", program={"step": None,
                                                             "spans": spans})) == 71.5
    assert read(types.SimpleNamespace(kind="train", program={"step": None, "spans": None})) is None
    assert read(types.SimpleNamespace(kind="serve", program={})) is None
