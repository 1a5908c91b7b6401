"""The gather probes' port on the CPU, against the TPU probes they replace.

Each `tools/r5_probe_gather{,2,3,4}.py` is read with `ast` (the scripts
probe at import) and only its function definitions and assignments are
executed, with `jax.jit` shimmed so that `.lower(*args)` captures the
function and its arguments instead of compiling, and `pl.pallas_call`
forced to `interpret=True`. Each of the 40 sub-probes of ROADMAP Queue B
rows 15-29 then runs in the interpreter on the arguments that
`convnet_tpu_torch/tools/gather_probe.py` builds for it (seeded random
values, offsets in the probe's range; their shapes and dtypes are the
probe's own), and through the port's kernel (on the CPU its plain
version): the two must be array-equal bit for bit. Three probes are held
so, by what they are:

- P1 (`r5_probe_gather.py:70`) fails in the interpreter as written (its
  out block is (1, W, L), its squeezed in block (W, L): the shape fault
  that wave 2's docstring names); the port of P1 is held to P1-fix's run,
  and a case pins that P1 still fails.
- P20's block and its body's last reshape, (H * 21, 256), do not hold the
  (8, 12, 56, 96) view its body takes; it runs with the script's H set to
  96 for the call, so that its `value_probe` block is the consistent
  (2016, 256), and is also held to numpy's x[:, :, ::-1, :].
- P24's input BlockSpec is Blocked, so its oy counts 224-row blocks and
  only oy = 0 lies inside the image: gather_probe builds P24 at oy = 0
  (P31's cases take oy and ox in 0..32).
"""

import ast
import functools
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_port_parity import jax_reference_numerics  # noqa: F401  (autouse fixture)

from convnet_tpu_torch import ops
from convnet_tpu_torch.ops import gather
from convnet_tpu_torch.ops.gather import Dim, crop_deinterleave, crop_window, relayout
from convnet_tpu_torch.tools import gather_probe as gp

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SEED = 5
P20_ROWS = 8 * 12 * 56 * 96 // 256  # 2016


def _load(path: Path):
    """The script's functions and assignments, run in a scope whose `jax.jit`
    captures (f, args) at .lower and whose pallas_call interprets. Returns
    (scope, capture dict)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    body = [n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.Assign))]
    captured = {}

    def jit(f):
        def lower(*args):
            captured["f"], captured["args"] = f, args
            return types.SimpleNamespace(compile=lambda: None)

        return types.SimpleNamespace(lower=lower)

    jax_shim = types.SimpleNamespace(jit=jit, lax=jax.lax, ShapeDtypeStruct=jax.ShapeDtypeStruct)
    pl_shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    pl_shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    scope = {"jax": jax_shim, "jnp": jnp, "pl": pl_shim, "pltpu": pltpu, "np": np}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"), scope)
    return scope, captured


@functools.lru_cache(maxsize=None)
def _script(name: str):
    return _load(REPO / name)


def _tpu_function(probe_name: str):
    """(the interpreted function, the arguments the probe lowers it with)
    for a probe's TPU function (P1's is P1-fix's, P20 at its consistent
    shape)."""
    probe_name = "P1-fix" if probe_name == "P1" else probe_name
    site = next(p.site for p in gp.PROBES if p.name == probe_name)
    path, fn = site.split(":")[0], site.split()[1]
    scope, captured = _script(path)
    if probe_name != "P20":
        scope[fn]()
        return captured["f"], captured["args"]

    def with_h(call):  # P20's block and its body's last reshape are (H * 21, 256)
        h, scope["H"] = scope["H"], P20_ROWS // 21
        try:
            return call()
        finally:
            scope["H"] = h

    with_h(scope[fn])
    f = captured["f"]
    return (lambda *args: with_h(lambda: f(*args))), captured["args"]


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _bits(a) -> np.ndarray:
    """A bf16 array's bits, so that -0 and NaN payloads count."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _interpret(probe_name: str, args):
    f, want_args = _tpu_function(probe_name)
    assert len(args) == len(want_args)
    for t, w in zip(args, want_args):  # the probe's own shapes and dtypes
        assert tuple(t.shape) == tuple(w.shape), probe_name
        assert np.dtype(_to_jax(t).dtype) == np.dtype(w.dtype), probe_name
    return f(*(_to_jax(t) for t in args))


def _case(probe_name: str, mode: str = "random"):
    probe = next(p for p in gp.PROBES if p.name == probe_name)
    return probe, probe.build(gp.PROBE, gp.Draw(CPU, SEED, mode))


@pytest.mark.parametrize("name", [p.name for p in gp.PROBES])
def test_probe_matches_its_tpu_function(name):
    probe, case = _case(name)
    got = gp.run(probe, case)
    want = _interpret(name, case.args)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert gp.same_bits(got, gp.run(probe, case, "plain"))
    if case.library is not None:  # the library call is the same function
        assert gp.same_bits(got, case.library().reshape(got.shape))


# the probes whose scalar selects a path, at the ends of its range and
# past them (P18: zeros outside 0..32; the rolls: any shift)
SELECTED = [("P26", 0), ("P26", 3), ("P18", 0), ("P18", 32), ("P18", 33), ("P18", -3),
            ("P2", -3), ("P2", 300), ("P3", 1000), ("P22", 0), ("P22", 1), ("P22", -1),
            ("P19b", 0), ("P19b", 224), ("P19b", 300), ("P7", 32), ("P8", 4), ("P27", 32),
            ("P28", 32)]


@pytest.mark.parametrize("name,s0", SELECTED)
def test_selected_scalars_match_the_tpu_function(name, s0):
    probe, case = _case(name)
    s = case.args[0].clone()
    s[0] = s0
    args = (s,) + case.args[1:]
    got = case.call(gp.KERNELS[probe.kernel][0], *args)
    np.testing.assert_array_equal(_bits(got), _bits(_interpret(name, args)))
    if name == "P18" and not 0 <= s0 <= 32:
        assert not got.float().any()


@pytest.mark.parametrize("mode", ["low", "high"])
@pytest.mark.parametrize("name", ["P1-fix", "P13b", "P23", "P24", "P31"])
def test_per_image_offsets_at_their_ends(name, mode):
    probe, case = _case(name, mode)
    want = _interpret(name, case.args)
    np.testing.assert_array_equal(_bits(gp.run(probe, case)), _bits(want))


def test_p1_as_written_fails_in_the_interpreter():
    scope, captured = _script("tools/r5_probe_gather.py")
    scope["p1"]()
    with pytest.raises(ValueError, match="Invalid shape for `swap`"):
        captured["f"](*captured["args"])


def test_p20_is_the_q_flip():
    probe, case = _case("P20")
    x = case.args[1].float().numpy()
    want = x.reshape(8, 12, 56, 96)[:, :, ::-1, :].reshape(P20_ROWS, 256)
    np.testing.assert_array_equal(gp.run(probe, case).float().numpy(), want)


def test_p24_reads_224_row_blocks():
    """P24 as written reads rows 224 * oy[b]: at oy = 1 its image b is no
    crop of rows 1..224, which the port computes."""
    probe, case = _case("P24")
    oy = case.args[0].clone()
    oy[0] = 1
    args = (oy,) + case.args[1:]
    want = np.asarray(_interpret("P24", args).astype(jnp.float32))[0]
    got = case.call(crop_deinterleave, *args)[0].float().numpy()
    assert not np.array_equal(got, want)


def test_the_table_covers_every_site():
    names = [p.name for p in gp.PROBES]
    assert len(names) == 40 and len(set(names)) == 40
    assert sorted({p.row for p in gp.PROBES}) == list(range(15, 30))
    for p in gp.PROBES:
        path, line = p.site.split()[0].split(":")
        assert "pallas_call(" in (REPO / path).read_text().splitlines()[int(line) - 1]
        assert p.kernel in gp.KERNELS
    assert sum(len(v) for v in gp.SITES.values()) == 15 + 3  # rows 16 and 19 use two or three


# -- the kernels' plain versions at a ragged shape, against numpy --------------------


def _ragged(mode):
    d = gp.Draw(CPU, SEED, mode)
    g = gp.RAGGED
    return d, g


@pytest.mark.parametrize("mode", ["random", "low", "high"])
def test_crop_window_at_a_ragged_shape(mode):
    d, g = _ragged(mode)
    x = d.bf16((g.b, g.h, g.l))
    oy, ox = d.ints(g.b, g.h - g.w), d.ints(g.b, (g.l - g.cw) // 3)
    got = crop_window(x, g.w, g.cw, row_off=d.t(oy), col_off=d.t(ox), col_mult=3)
    xn = x.float().numpy()
    want = np.stack([xn[b, oy[b]:oy[b] + g.w, 3 * ox[b]:3 * ox[b] + g.cw] for b in range(g.b)])
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("mode", ["random", "low", "high"])
def test_crop_deinterleave_at_a_ragged_shape(mode):
    """out[b, rp*P + p, cpc*Q + q] = bf16(f32(crop[4p + rp, 12q' + cpc'])
    * f32(1/255) - f32(0.45)), q' and cp' mirrored where fl[b] > 0."""
    d, g = _ragged(mode)
    x = d.u8((g.b, g.h, g.l))
    oy, ox, fl = d.ints(g.b, g.h - g.w), d.ints(g.b, (g.l - g.cw) // 3), d.ints(g.b, 1)
    got = crop_deinterleave(x, d.t(oy), d.t(ox), d.t(fl), p=g.p, q=g.q)
    xn = x.numpy()
    for b in range(g.b):
        crop = xn[b, oy[b]:oy[b] + g.w, 3 * ox[b]:3 * ox[b] + g.cw].reshape(g.p, 4, g.q, 4, 3)
        if fl[b]:
            crop = crop[:, :, ::-1, ::-1, :]  # pixel 4q + cp -> 4Q - 1 - (4q + cp)
        v = crop.transpose(1, 0, 3, 4, 2).reshape(g.w, g.cw).astype(np.float32)
        v = v * np.float32(1 / 255.0) - np.float32(0.45)
        want = torch.from_numpy(v).to(torch.bfloat16)
        assert gp.same_bits(got[b], want), b


@pytest.mark.parametrize("name", [e.name for e in gp.EDGES if e.kernel == "crop_deinterleave"])
def test_crop_deinterleave_edge_against_numpy(name):
    """Each crop_deinterleave edge geometry's plain version against the
    formula of test_crop_deinterleave_at_a_ragged_shape (the identity for
    a bf16 input); an image whose crop leaves its input is NaN (0x7fc0),
    whole."""
    edge = next(e for e in gp.EDGES if e.name == name)
    case = edge.build(gp.Draw(CPU, SEED))
    got = gp.run_edge(edge, case, "plain")
    oy, ox = (a.numpy() for a in case.args[:2])
    fl = case.args[2].numpy() if len(case.args) == 4 else np.zeros_like(ox)
    x = case.args[-1]
    b, w, cw = got.shape
    p, q = w // 4, cw // 12
    h, l = x.shape[1:]
    u8 = x.dtype == torch.uint8
    xn = x.numpy() if u8 else x.float().numpy()
    nan = torch.full((w, cw), float("nan"), dtype=torch.bfloat16)
    for i in range(b):
        if oy[i] < 0 or oy[i] + w > h or ox[i] < 0 or 3 * ox[i] + cw > l:
            assert gp.same_bits(got[i], nan), i
            continue
        crop = xn[i, oy[i]:oy[i] + w, 3 * ox[i]:3 * ox[i] + cw].reshape(p, 4, q, 4, 3)
        if fl[i] > 0:
            crop = crop[:, :, ::-1, ::-1, :]
        v = crop.transpose(1, 0, 3, 4, 2).reshape(w, cw).astype(np.float32)
        if u8:
            v = v * np.float32(1 / 255.0) - np.float32(0.45)
        assert gp.same_bits(got[i], torch.from_numpy(v).to(torch.bfloat16)), i


def test_relayout_at_a_ragged_shape():
    d, g = _ragged("random")
    x = d.bf16((g.h, g.l))
    s = d.t(np.array([7] + [0] * 7, np.int32))
    rolled = relayout(x, [Dim(g.h, g.l, roll_by_s=True), Dim(g.l, -1)], base=g.l - 1, s=s)
    np.testing.assert_array_equal(rolled.float().numpy(),
                                  np.roll(x.float().numpy()[:, ::-1], 7, 0))
    t = relayout(x, [Dim(g.l, 1), Dim(g.h, g.l)])
    np.testing.assert_array_equal(t.float().numpy(), x.float().numpy().T)


# -- the wrappers' checks ---------------------------------------------------------


def test_offsets_outside_their_range_raise_on_the_cpu():
    x = torch.zeros((2, 256, 768), dtype=torch.bfloat16)
    off = torch.tensor([0, 33], dtype=torch.int32)
    with pytest.raises(ValueError, match="row origin"):
        crop_window(x, 224, 768, row_off=off)
    with pytest.raises(ValueError, match="column origin"):
        crop_window(x, 224, 672, col_off=off, col_mult=3)
    zeros = crop_window(x + 1, 224, 672, col_off=off, col_mult=3, outside="zero")
    assert zeros[0].float().eq(1).all() and not zeros[1].float().any()
    u8 = torch.zeros((2, 256, 768), dtype=torch.uint8)
    with pytest.raises(ValueError, match="oy outside"):
        crop_deinterleave(u8, off, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="ox outside"):
        crop_deinterleave(u8, torch.zeros(2, dtype=torch.int32), off)
    # the plain version writes what the card writes for such an image: NaN
    nan = gather.crop_deinterleave_reference(u8, off, off)
    assert torch.isnan(nan[1].float()).all() and not torch.isnan(nan[0].float()).any()
    with pytest.raises(ValueError, match="reads elements"):
        relayout(x[0], [Dim(256, 768), Dim(768, -1)])
    with pytest.raises(TypeError, match="int32"):
        crop_window(x, 224, 768, row_off=off.long())
    with pytest.raises(TypeError, match="uint8"):
        relayout(x, [Dim(4, 1)], epilogue="scale_u8")


def test_no_kernel_for_another_device():
    meta = torch.device("meta")
    off = torch.zeros(1, dtype=torch.int32, device=meta)
    x = torch.empty((1, 256, 768), dtype=torch.bfloat16, device=meta)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="no kernel for device"):
        crop_window(x, 224, 768, row_off=off, outside="zero")
    with pytest.raises(ValueError, match="no kernel for device"):
        relayout(x, [Dim(256, 768), Dim(768, 1)])
    with pytest.raises(ValueError, match="no kernel for device"):
        crop_deinterleave(x, off, off)
    assert ops.launch_counts() == before


def test_gather_probe_on_the_cpu(capsys):
    # --trace traces the card's activities: nothing to add on the CPU
    assert gp.main(["--device", "cpu", "--batch", "2", "--calls", "1", "--trace"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    per_image = [p.name for p in gp.PROBES if p.per_image]
    assert [l.get("probe") for l in lines] == (
        [p.name for p in gp.PROBES] + per_image + [None])
    for l in lines[:-1]:
        assert l["metric"] == "gather_probe" and l["device"] == "cpu"
        assert l["power_limit_w"] is None and l["max_abs_err"] == 0.0
        assert l["launches"] == dict.fromkeys(ops.KERNEL_NAMES, 0)
        assert l["ms"] > 0 and l["plain_ms"] > 0 and l["bound_ms"] > 0
        assert (l["library"] == "none") == (l["library_ms"] is None) and "trace" not in l
    assert [l["batch"] for l in lines[40:-1]] == [2] * len(per_image)
    assert lines[-1]["metric"] == "crop_deinterleave_vs_jitter_s2d" and lines[-1]["batch"] == 2


def test_gather_probe_runs_the_probes_named(capsys):
    assert gp.main(["--device", "cpu", "--batch", "2", "--calls", "1",
                    "--probes", "P31,P21"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [(l["probe"], l["batch"]) for l in lines] == [("P21", None), ("P31", None),
                                                         ("P31", 2)]
    with pytest.raises(ValueError, match="no sub-probe"):
        gp.main(["--device", "cpu", "--probes", "P99"])


# -- relayout's host plan (ops/gather.py _relayout_plan) ----------------------------

#: the route each relayout sub-probe takes (csrc/relayout.cu)
ROUTES = {
    "P2": "run copy", "P3": "run copy", "P4": "run copy", "P5": "run copy", "P6": "run copy",
    "P2b": "run copy", "P3b": "run copy", "P14a": "run copy", "P14b": "run copy",
    "P15a": "run reverse", "P15b": "run copy", "P15c": "run copy", "P16": "tile transpose",
    "P17a": "run copy", "P19": "run copy", "P20": "run copy", "P20b": "run reverse",
    "P22": "run, copy or reverse by s[0]", "P19b": "run copy", "P25a": "run, nothing read",
    "P25b": "run reverse", "P25c": "run copy", "P25d": "tile transpose", "P30": "tile transpose",
}
#: the reduced rank where merging changes it (the others keep theirs)
RANKS = {"P14a": 1, "P14b": 1, "P17a": 1, "P15c": 2, "P20": 3, "P25b": 2, "P25c": 3}


def _route(plan) -> str:
    if plan.route == "tile":
        return "tile transpose"
    inner = plan.dims[-1]
    if inner.stride == 0:
        return "run, nothing read"
    if abs(inner.stride) != 1:
        return "run, element by element"
    if inner.mirror_if_s:
        return "run, copy or reverse by s[0]"
    return "run copy" if inner.stride == 1 else "run reverse"


def _recorded_map(case: gp.Case):
    """The map and keywords that a relayout case hands its wrapper."""
    seen = {}

    def record(x, dims, **kw):
        seen.update(x=x, dims=tuple(dims), **kw)
        return relayout(x, dims, **kw)

    case.call(record, *case.args)
    return seen


def _check_plan(m):
    """The reduced map, through relayout_reference, computes the original's
    output bit for bit, and reads the original's box, inside the input."""
    dims, base, epilogue = m["dims"], m.get("base", 0), m.get("epilogue", "copy")
    plan = gather._relayout_plan(dims, base, epilogue)
    assert plan.route in gather.RELAYOUT_ROUTES and 1 <= len(plan.dims) <= 4
    kw = dict(s=m.get("s"), epilogue=epilogue, scale=m.get("scale", 1.0), k=m.get("k", 0))
    want = gather.relayout_reference(m["x"], dims, base=base, **kw)
    got = gather.relayout_reference(m["x"], plan.dims, base=plan.base, **kw)
    assert gp.same_bits(got.reshape(want.shape), want)
    if epilogue != "antidiagonal":
        assert gather._read_box(plan.dims, plan.base) == gather._read_box(dims, base)
        lo, hi = gather._read_box(plan.dims, plan.base)
        assert 0 <= lo and hi < m["x"].numel()
    if plan.route == "tile":
        assert abs(plan.dims[plan.unit].stride) == 1 and plan.unit < len(plan.dims) - 1
    return plan


@pytest.mark.parametrize("geometry", ["PROBE", "RAGGED"])
@pytest.mark.parametrize("name", [p.name for p in gp.PROBES if p.kernel == "relayout"])
def test_relayout_plan_of_each_probe(name, geometry):
    probe = next(p for p in gp.PROBES if p.name == name)
    m = _recorded_map(probe.build(getattr(gp, geometry), gp.Draw(CPU, SEED)))
    plan = _check_plan(m)
    assert _route(plan) == ROUTES[name]
    assert len(plan.dims) == RANKS.get(name, len(m["dims"]))


@pytest.mark.parametrize("name", [e.name for e in gp.EDGES if e.kernel == "relayout"])
def test_relayout_plan_of_each_edge(name):
    edge = next(e for e in gp.EDGES if e.name == name)
    _check_plan(_recorded_map(edge.build(gp.Draw(CPU, SEED))))


def test_relayout_plan_merges_and_keeps():
    plan = gather._relayout_plan
    # P20's (8, 12, q, 96) view: img and cpc merge; q runs backwards, so stays
    assert plan((Dim(8, 12 * 56 * 96), Dim(12, 56 * 96), Dim(56, -96), Dim(96, 1)), 55 * 96) == (
        "run", (Dim(96, 56 * 96), Dim(56, -96), Dim(96, 1)), 55 * 96, 2)
    # negative strides merge where the rule holds; a roll or a mirror blocks it
    assert plan((Dim(4, -6), Dim(3, -2)), 23).dims == (Dim(12, -2),)
    assert plan((Dim(4, 6), Dim(3, 2, roll=1)), 0).dims == (Dim(4, 6), Dim(3, 2, roll=1))
    assert plan((Dim(4, 6), Dim(3, 2, roll=3)), 0).dims == (Dim(12, 2),)  # a whole turn
    assert plan((Dim(4, 6, mirror_if_s=True), Dim(3, 2)), 0).route == "run"
    assert len(plan((Dim(4, 6, mirror_if_s=True), Dim(3, 2)), 0).dims) == 2
    # the row epilogues keep dim 0, size 1 included; other size-1 dims go
    assert plan((Dim(1, 7), Dim(5, 3), Dim(3, 1)), 0, "row_below_s").dims == (
        Dim(1, 7), Dim(15, 1))
    assert plan((Dim(1, 7), Dim(5, 3), Dim(3, 1)), 0, "copy").dims == (Dim(15, 1),)
    assert plan((Dim(1, 7), Dim(1, 3)), 4, "copy") == ("run", (Dim(1, 1),), 4, 0)
    # the anti-diagonal: first and last dims, the ones between as one
    assert plan((Dim(9, 1), Dim(3, 5), Dim(2, 8), Dim(21, 2)), 0, "antidiagonal").dims == (
        Dim(9, 0), Dim(6, 0), Dim(21, 0))
    # the tile's unit dim is the innermost of the +-1 dims before the last
    assert plan((Dim(3, 1), Dim(4, -1), Dim(5, 12)), 3)[::3] == ("tile", 1)


def test_relayout_plan_splits_runs_reverses_and_gathers():
    """A roll that splits each run, a stride of -1, and a map with no stride
    of +-1, which the run route reads element by element inside its box."""
    x = torch.arange(600, dtype=torch.int16).view(torch.bfloat16)
    s = torch.tensor([7] + [0] * 7, dtype=torch.int32)
    for dims, base, route in (([Dim(20, 30), Dim(30, 1, roll_by_s=True)], 0, "run copy"),
                              ([Dim(20, 30), Dim(30, -1, roll=4)], 29, "run reverse"),
                              ([Dim(20, 29), Dim(6, 3)], 0, "run, element by element"),
                              ([Dim(30, 1), Dim(20, 30)], 0, "tile transpose")):
        p = _check_plan(dict(x=x, dims=tuple(dims), base=base, s=s))
        assert _route(p) == route

