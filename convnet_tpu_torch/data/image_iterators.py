"""Image-file streams: JPEG and other image lists, sliding windows, text
matrices (counterpart of `convnet_tpu/data/image_iterators.py`).

An IMAGE_RAW list decodes with the native JPEG loader when every file is
a JPEG (`data/native.py`, built with g++ at first use; its decoder gives
libjpeg-turbo's bytes, as the JAX package's libjpeg loader does), else
with PIL on a pool of threads; the choice is the JAX package's
(`_all_jpeg` sniffs the magic bytes of files without a known extension).
PIL's decode is close to libjpeg's, not equal, so `RawImageStream.backend`
says which reader a stream took ("native" or "pil") and `backend_reason`
why it took PIL, and the Trainer and the extract CLI log both. Resizing is the
reference's: the shorter side to raw_image_size, then a center crop of the
longer side; the random crop happens on the device.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import List

import numpy as np

from convnet_tpu_torch import proto as pb
from convnet_tpu_torch.data.datahandler import Stream

JPEG_EXTS = (".jpg", ".jpeg", ".jpe", ".jfif")
OTHER_IMAGE_EXTS = (".png", ".bmp", ".gif", ".tif", ".tiff", ".webp", ".ppm", ".pgm")


def _read_file_list(path: str) -> List[str]:
    base = os.path.dirname(os.path.abspath(path))
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(line if os.path.isabs(line) else os.path.join(base, line))
    return out


def decode_and_resize(path: str, raw_size: int, num_colors: int) -> np.ndarray:
    """Decode one image, scale its shorter side to raw_size and center-crop
    the longer one -> (raw_size, raw_size, num_colors) uint8. A JPEG that
    shrinks decodes at a power-of-2 DCT scale first (PIL's draft), as the
    native loader does."""
    from PIL import Image

    mode = "RGB" if num_colors == 3 else "L"
    img = Image.open(path)
    if img.format == "JPEG":
        img.draft(mode, (raw_size, raw_size))
    img = img.convert(mode)
    w, h = img.size
    scale = raw_size / min(w, h)
    nw, nh = max(raw_size, int(round(w * scale))), max(raw_size, int(round(h * scale)))
    img = img.resize((nw, nh), Image.BILINEAR)
    left, top = (nw - raw_size) // 2, (nh - raw_size) // 2
    arr = np.asarray(img.crop((left, top, left + raw_size, top + raw_size)), dtype=np.uint8)
    return arr[:, :, None] if arr.ndim == 2 else arr


class RawImageStream(Stream):
    """file_pattern: a list of image paths, one a line (relative to the
    list's directory). Rows are (raw, raw, C) uint8."""

    def __init__(self, cfg: pb.DataStreamConfig, num_threads: int = 8):
        super().__init__(cfg)
        if not cfg.file_pattern:
            raise ValueError(f"stream {cfg.layer_name}: IMAGE_RAW needs file_pattern")
        self._paths = _read_file_list(cfg.file_pattern)
        self._raw = cfg.raw_image_size or cfg.image_size
        if not self._raw:
            raise ValueError(f"stream {cfg.layer_name}: needs raw_image_size or image_size")
        self._native = None
        self._pool = None
        # the native loader decodes JPEG only; a list with anything else
        # goes to the PIL pool, as does one the native loader cannot take
        if not self._all_jpeg(self._paths):
            self.backend_reason = "the list holds files that are not JPEGs"
        else:
            try:
                from convnet_tpu_torch.data import native

                self._native = native.NativeImageLoader(
                    self._paths, self._raw, cfg.num_colors, num_threads
                )
            except Exception as e:
                self.backend_reason = f"the native loader failed: {type(e).__name__}: {e}"
        if self._native is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(num_threads)
        self.backend = "native" if self._native is not None else "pil"

    @staticmethod
    def _all_jpeg(paths: List[str], sniff_limit: int = 64) -> bool:
        """True when every path looks like a JPEG: the extension decides
        where it is known; other names have their first two bytes sniffed,
        up to sniff_limit of them (beyond that the answer is no)."""
        to_sniff = []
        for p in paths:
            ext = os.path.splitext(p)[1].lower()
            if ext in JPEG_EXTS:
                continue
            if ext in OTHER_IMAGE_EXTS:
                return False
            to_sniff.append(p)
            if len(to_sniff) > sniff_limit:
                return False
        for p in to_sniff:
            try:
                with open(p, "rb") as f:
                    if f.read(2) != b"\xff\xd8":
                        return False
            except OSError:
                return False
        return True

    @property
    def num_rows(self) -> int:
        return len(self._paths)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self._native is not None:
            self._native.close()

    def read_rows(self, indices: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native.load(indices)
        futs = [
            self._pool.submit(decode_and_resize, self._paths[i], self._raw, self.cfg.num_colors)
            for i in indices
        ]
        return np.stack([f.result() for f in futs])


class SlidingWindowStream(Stream):
    """Dense windows over large images, for patchwise eval: row k is
    (image, window) in row-major window order at stride window_stride;
    windows that run past the edge are zero-padded."""

    def __init__(self, cfg: pb.DataStreamConfig):
        super().__init__(cfg)
        from PIL import Image

        self._paths = _read_file_list(cfg.file_pattern)
        self._win = cfg.image_size
        self._stride = max(1, cfg.window_stride)
        if not self._win:
            raise ValueError(f"stream {cfg.layer_name}: SLIDING_WINDOW needs image_size")
        self._raw = cfg.raw_image_size or 0
        self._index: List[tuple] = []  # (path index, y, x)
        for pi, p in enumerate(self._paths):
            with Image.open(p) as im:
                w, h = im.size
            if self._raw:
                scale = self._raw / min(w, h)
                w, h = int(round(w * scale)), int(round(h * scale))
            for y in range(0, max(1, h - self._win + 1), self._stride):
                for x in range(0, max(1, w - self._win + 1), self._stride):
                    self._index.append((pi, y, x))
        self._cache_idx = -1
        self._cache_img = None

    @property
    def num_rows(self) -> int:
        return len(self._index)

    def _full_image(self, pi: int) -> np.ndarray:
        if pi != self._cache_idx:
            from PIL import Image

            img = Image.open(self._paths[pi]).convert("RGB" if self.cfg.num_colors == 3 else "L")
            if self._raw:
                w, h = img.size
                scale = self._raw / min(w, h)
                img = img.resize((int(round(w * scale)), int(round(h * scale))), Image.BILINEAR)
            arr = np.asarray(img, dtype=np.uint8)
            self._cache_idx, self._cache_img = pi, arr[:, :, None] if arr.ndim == 2 else arr
        return self._cache_img

    def read_rows(self, indices: np.ndarray) -> np.ndarray:
        out = np.zeros((len(indices), self._win, self._win, self.cfg.num_colors), np.uint8)
        for k, row in enumerate(indices):
            pi, y, x = self._index[int(row)]
            patch = self._full_image(pi)[y: y + self._win, x: x + self._win]
            out[k, : patch.shape[0], : patch.shape[1]] = patch
        return out


class TxtStream(Stream):
    """A whitespace-separated numeric matrix, one row per example (f32)."""

    def __init__(self, cfg: pb.DataStreamConfig):
        super().__init__(cfg)
        self._data = np.loadtxt(cfg.file_pattern, dtype=np.float32, ndmin=2)

    @property
    def num_rows(self) -> int:
        return self._data.shape[0]

    def read_rows(self, indices: np.ndarray) -> np.ndarray:
        return self._maybe_reshape_images(self._data[indices])
