"""HDF5 checkpoints (counterpart of `convnet_tpu/checkpoint.py`).

The file format is the contract of `docs/checkpoint_format.md`, shared with
the JAX package, so a checkpoint written by either loads in the other: one
group per weighted edge ("source:dest") holding float32 datasets "w", "b",
"w_mom" and "b_mom" in the JAX package's layouts (HWIO conv filters,
(in, out) FC weights), and file attrs "step", "model_name" and
"timestamp". `load` also accepts the layout variants that document lists
(aliased dataset names, flat datasets, transposed or flattened weights).

These functions take and return numpy arrays; the callers move tensors.
Files are read and written by the port's own HDF5 module
(`convnet_tpu_torch/hdf5.py`), so no h5py is needed.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import numpy as np

from convnet_tpu_torch import hdf5


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y%m%d%H%M%S")


def checkpoint_path(directory: str, model_name: str, timestamp: str) -> str:
    return os.path.join(directory, f"{model_name}_{timestamp}.h5")


def save(
    directory: str,
    model_name: str,
    params: Dict,
    moms: Optional[Dict] = None,
    step: int = 0,
    timestamp: Optional[str] = None,
) -> str:
    """Write a timestamped checkpoint of {edge: {"w", "b"}} arrays (and the
    momenta, when given); returns the file path."""
    os.makedirs(directory, exist_ok=True)
    ts = timestamp or _timestamp()
    path = checkpoint_path(directory, model_name, ts)
    # second-resolution timestamps can collide (fast tests, rapid saves);
    # suffixed names still sort after the base name lexically
    i = 0
    while timestamp is None and os.path.exists(path):
        i += 1
        path = checkpoint_path(directory, model_name, f"{ts}_{i}")
    with hdf5.File(path, "w") as f:
        f.attrs["step"] = int(step)
        f.attrs["model_name"] = model_name
        f.attrs["timestamp"] = ts
        for edge_name, leaves in params.items():
            grp = f.create_group(edge_name)
            grp.create_dataset("w", data=np.asarray(leaves["w"], np.float32))
            grp.create_dataset("b", data=np.asarray(leaves["b"], np.float32))
            if moms is not None:
                grp.create_dataset("w_mom", data=np.asarray(moms[edge_name]["w"], np.float32))
                grp.create_dataset("b_mom", data=np.asarray(moms[edge_name]["b"], np.float32))
    return path


# Dataset-name aliases of the layouts load() accepts (docs/checkpoint_format.md).
_W_NAMES = ("w", "weight", "weights")
_B_NAMES = ("b", "bias", "biases")
_WM_NAMES = ("w_mom", "weight_mom", "w_momentum", "dw_history")
_BM_NAMES = ("b_mom", "bias_mom", "b_momentum", "db_history")
_FLAT_B_SUFFIXES = ("_bias", "_b")
_FLAT_WM_SUFFIXES = ("_w_mom", "_weight_mom", "_mom")
_FLAT_BM_SUFFIXES = ("_b_mom", "_bias_mom")


def _pick(grp, names):
    for n in names:
        if n in grp:
            return grp[n][...]
    return None


def _strip_suffix(name: str, suffixes) -> Optional[str]:
    for s in suffixes:
        if name.endswith(s):
            return name[: -len(s)]
    return None


def _coerce_weight(arr: np.ndarray, expected: Optional[Tuple[int, ...]]) -> np.ndarray:
    """A weight array in the model's layout: 2-D transposes and
    (out, k*k*in) or (k*k*in, out) flattenings of 4-D conv filters are put
    back; any other array of the expected size is reshaped row-major."""
    if expected is None or tuple(arr.shape) == tuple(expected):
        return arr
    expected = tuple(expected)
    if arr.ndim == 2 and len(expected) == 2 and arr.shape == expected[::-1]:
        return arr.T
    if arr.size == int(np.prod(expected)) and len(expected) == 4:
        k1, k2, cin, cout = expected
        if arr.ndim == 2 and arr.shape[0] == cout:
            # (cout, k*k*cin) row-major -> HWIO
            return arr.reshape(cout, k1, k2, cin).transpose(1, 2, 3, 0)
        if arr.ndim == 2 and arr.shape[1] == cout:
            # (k*k*cin, cout) -> HWIO
            return arr.reshape(k1, k2, cin, cout)
    if arr.size == int(np.prod(expected)):
        return arr.reshape(expected)
    raise ValueError(
        f"checkpoint weight shape {arr.shape} incompatible with model shape {expected}"
    )


def load(
    path: str, expected_shapes: Optional[Dict] = None
) -> Tuple[Dict, Optional[Dict], int]:
    """Read (params, moms or None, step) from a checkpoint file, as numpy
    arrays. Accepts, by auto-detection (docs/checkpoint_format.md):
      A. the canonical layout: one group per edge with w/b(/w_mom/b_mom);
      B. a group per edge with aliased dataset names (weight/bias/...);
      C. flat datasets: f["src:dst"] the weight, the bias at
         f["src:dst_bias"], momenta at _mom-suffixed names.
    With `expected_shapes` ({edge: {"w": shape, "b": shape}}, from
    model.param_shapes) transposed or flattened weights take the model's
    layout, and a missing bias loads as zeros of its expected shape."""
    params: Dict = {}
    moms: Dict = {}
    have_moms = False

    def exp(edge, key):
        if expected_shapes and edge in expected_shapes:
            v = expected_shapes[edge].get(key)
            return tuple(np.shape(v)) if not isinstance(v, tuple) else v
        return None

    with hdf5.File(path, "r") as f:
        step = int(f.attrs.get("step", 0))
        flat_w: Dict[str, np.ndarray] = {}
        flat_other: Dict[str, np.ndarray] = {}
        for name, item in f.items():
            if isinstance(item, hdf5.Group):
                w = _pick(item, _W_NAMES)
                if w is None:
                    raise ValueError(
                        f"checkpoint {path}: group {name!r} has no weight dataset "
                        f"(looked for {_W_NAMES})"
                    )
                params[name] = {"w": _coerce_weight(w, exp(name, "w")), "b": _pick(item, _B_NAMES)}
                wm, bm = _pick(item, _WM_NAMES), _pick(item, _BM_NAMES)
                if wm is not None:
                    have_moms = True
                    moms[name] = {"w": _coerce_weight(wm, exp(name, "w")), "b": bm}
            else:  # flat dataset layout
                base = _strip_suffix(name, _FLAT_B_SUFFIXES + _FLAT_WM_SUFFIXES + _FLAT_BM_SUFFIXES)
                if base is None:
                    flat_w[name] = item[...]
                else:
                    flat_other[name] = item[...]

    def flat(name, suffixes):
        return next((flat_other[name + s] for s in suffixes if name + s in flat_other), None)

    for name, w in flat_w.items():
        params[name] = {"w": _coerce_weight(w, exp(name, "w")), "b": flat(name, _FLAT_B_SUFFIXES)}
        wm = flat(name, _FLAT_WM_SUFFIXES)
        if wm is not None:
            have_moms = True
            moms[name] = {"w": _coerce_weight(wm, exp(name, "w")), "b": flat(name, _FLAT_BM_SUFFIXES)}
    # missing biases and bias momenta load as zeros of the right shape
    for name, leaves in params.items():
        if leaves["b"] is None:
            e = exp(name, "b")
            leaves["b"] = np.zeros(e if e else (leaves["w"].shape[-1],), np.float32)
    for name, leaves in moms.items():
        if leaves["b"] is None:
            leaves["b"] = np.zeros_like(params[name]["b"])
    return params, (moms if have_moms else None), step


def load_edge(path: str, edge_name: str, expected_shape=None) -> Dict:
    """One edge's {"w", "b"} (PRETRAINED initialization), from any layout
    load() accepts."""
    with hdf5.File(path, "r") as f:
        if edge_name not in f:
            raise KeyError(f"edge {edge_name!r} not in checkpoint {path}")
        item = f[edge_name]
        if isinstance(item, hdf5.Group):
            w = _pick(item, _W_NAMES)
            b = _pick(item, _B_NAMES)
        else:
            w = item[...]
            b = next(
                (f[edge_name + s][...] for s in _FLAT_B_SUFFIXES if edge_name + s in f), None
            )
    w = _coerce_weight(w, expected_shape)
    if b is None:
        b = np.zeros((w.shape[-1],), np.float32)
    return {"w": w, "b": b}


def latest(directory: str, model_name: str) -> Optional[str]:
    """The newest checkpoint of a model in `directory` (timestamps sort
    lexically), or None."""
    if not os.path.isdir(directory):
        return None
    prefix = f"{model_name}_"
    files = [f for f in os.listdir(directory) if f.startswith(prefix) and f.endswith(".h5")]
    if not files:
        return None
    return os.path.join(directory, sorted(files)[-1])
