"""The plain references that decide `correct`: plain PyTorch, float32,
importing nothing of the port.

A configuration (`cellbench/configs/<config>.json`) names its reference
under "reference": the module `cellbench/reference/<reference>.py`, which
the harness loads by path; a configuration that names none takes the
shared `net`. A model that `net` refuses (a layer with a second incoming
edge, an edge type that it does not write out, several outputs) brings a
reference of its own as a new file here. It may reuse `draws` and
`textproto`, and has to provide what the harness (`harness.py`), the
kinds (`kinds/`), the calibration (`calibrate.py`), `weights.py` and the
metric readers (`metrics/`) take from a reference, by these names:

The module (`MODULE`):
- `Net(text, crop)`: the network of the model file's text at the crop;
  raises ValueError for a model that the module does not write out.
- `train_steps(net, params, batches, seed, crop, scale, mean, steps=3,
  precision="float32", rows=None, coords=None, moms=None, t0=0)`, those
  after `mean` given by keyword: `steps` SGD steps in float32 from
  `params` and `moms` (both updated in place; zero momenta where None),
  step t0 + i on batches[i] = (uint8 (B, H, W, C) images, int labels),
  with the crops and dropout masks of (seed, t0 + i) drawn as the port
  draws them (`draws`); `precision` "fp8" or "bf16"
  rounds the products' operands and gradients (the control, and a
  witness of rounding alone); `rows` keeps only the first rows of each
  batch (a fault). Returns {"loss": [each step's], "grad": {leaf: norm of
  the first step's g + l2 w}, "change": {leaf: norm of the parameters'
  change after the steps}} and, with coords ({leaf: flat indices}),
  "grad_at" and "change_at": those elements of the two as numpy arrays;
  leaves are named "<edge>/w" and "<edge>/b". The module's train_steps
  owns its loss: a model with several output layers states there how
  their losses combine (the port sums them).
- `exact_f32()`: a context manager in which products and convolutions
  are float32 (TF32 off).

A `Net` (`NET`):
- `input` (`INPUT`): the input layer; `.name`, its layer name, and
  `.field`, the batch field that it reads and that the crops are drawn
  for;
- `output` (`OUTPUT`): the output layer; `.name`, and `.channels`, the
  number of classes;
- `layers` (`LAYER`): {name: layer}, each with `.is_input` and
  `.activation` (the model file's name, such as "RECTIFIED_LINEAR");
- `edges` (`EDGE`): every edge in forward order, each with `.name`,
  `.kind` (the model file's edge_type, such as "CONV"), `.source`,
  `.dest`, `.stride`, `.padding`, `.init` (the initialization's name),
  `.init_wt`, `.init_bias`, `.add_scale`, `.pow_scale`, `.frac` (a
  response norm's share of the channels), and `.wopt`, `.bopt` (`OPTIM`):
  the weights' and the bias's optimizer, with `.epsilon(t)` and
  `.momentum(t)`, the step size and momentum of step t;
- `weighted`: the edges that hold parameters, in forward order;
- `shapes`: {layer: (H, W, C)} at the crop;
- `param_shapes()`: {edge: {"w": shape, "b": shape}} of the weighted
  edges, equal to the port's `model.param_shapes` of the same model (the
  harness checks it): parameters stay `{edge: {"w", "b"}}`, as
  `check.py`, the train kind's `follow` and the port's state hold them;
- `fan_in(e)`: the inputs that one output unit of weighted edge e sums;
- `edge_flops(e)`: an image's forward FLOPs (2 x multiply-adds) of edge
  e, 0 for one without weights;
- `flops_per_image()`: an image's forward FLOPs over the edges;
- `prologue(images, crop, scale, mean)`: uint8 (B, H, W, C) images to the
  float32 NCHW centre crops, x * scale - mean, that `probabilities`
  takes;
- `probabilities(params, x, precision="float32")`: the output layer's
  softmax, (B, K) float32 ("fp8": the control's rounding).
"""

#: The names that the benchmark takes from a reference module, a `Net`,
#: its input and output layers, each of its layers and edges, and each
#: edge's optimizers, as the docstring above describes them.
MODULE = ("Net", "train_steps", "exact_f32")
NET = ("input", "output", "layers", "edges", "weighted", "shapes", "param_shapes", "fan_in",
       "edge_flops", "flops_per_image", "prologue", "probabilities")
INPUT = ("name", "field")
OUTPUT = ("name", "channels")
LAYER = ("is_input", "activation")
EDGE = ("name", "kind", "source", "dest", "stride", "padding", "init", "init_wt", "init_bias",
        "add_scale", "pow_scale", "frac", "wopt", "bopt")
OPTIM = ("epsilon", "momentum")
