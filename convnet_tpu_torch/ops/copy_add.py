"""The chip probes' two-in, one-out bf16 add (counterpart of
`tools/r3_chip2.py:56 copy_kernel`, the same body at `tools/r3_chip4.py:192`
and `tools/r3_warm4.py:104`), on no model's path: `tools/copy_probe.py`
sweeps it over tilings to read the card's streaming rate.

`copy_add(a, b, tile_rows, tile_cols)` computes o = a + b on row-major
(m, n) bf16. For a CPU tensor it runs the plain version,
`copy_add_reference` (`a + b`); for a CUDA tensor it launches the kernel
`csrc/copy_add.cu`, one CTA of 256 threads a tile_rows x tile_cols tile, or
raises. The kernel rounds as torch.add does, so it is array-equal to
`a + b`.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Launches of the CUDA kernel in this process (CPU calls do not count).
LAUNCHES = 0
_WORD = 8  # bf16 values in a 16-byte word


def copy_add_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    return a + b


def copy_add(a: torch.Tensor, b: torch.Tensor, tile_rows: int = 16,
             tile_cols: Optional[int] = None) -> torch.Tensor:
    """a + b for (m, n) bf16 a and b; on the card, one CTA a tile_rows x
    tile_cols tile (tile_cols None or above n: whole rows). On the card a
    and b must be contiguous and 16-byte aligned, n and tile_cols
    multiples of 8."""
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"copy_add: shapes {tuple(a.shape)} and {tuple(b.shape)} (two equal "
                         "(m, n) shapes only)")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"copy_add: dtypes {a.dtype}, {b.dtype} (bf16 only)")
    if a.device != b.device:
        raise ValueError(f"copy_add: a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return copy_add_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"copy_add: no kernel for device {a.device}")
    m, n = a.shape
    tile_cols = n if tile_cols is None else min(tile_cols, n)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("copy_add: a and b must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("copy_add: a and b must start on a 16-byte boundary")
    if n % _WORD or tile_cols % _WORD or tile_rows < 1:
        raise ValueError(f"copy_add: n = {n} and tile_cols = {tile_cols} must be multiples of "
                         f"{_WORD}, tile_rows = {tile_rows} at least 1")
    o = torch.empty_like(a)
    if m == 0:
        return o
    from convnet_tpu_torch.ops import _build

    global LAUNCHES
    with torch.cuda.device(a.device):
        rc = _build.library().cn_copy_add(
            a.data_ptr(), b.data_ptr(), o.data_ptr(), m, n, tile_rows, tile_cols,
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    _build.check(rc, "copy_add")
    LAUNCHES += 1
    return o
