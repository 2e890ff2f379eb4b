"""Image-folder dataset loader (reference ``ImageDataHandler``,
Utilities.cpp:349-395).

Layout of a dataset folder (e.g. the Mitten fixture):
  RGB/*.png    n 8-bit colour images (decoded /255, RGB order)
  mask.png     8-bit grayscale, nonzero = masked
  Depth/*.png  n 16-bit depth maps, value = min_z + (png/65535)*(max_z-min_z)
  K.txt        3 CSV rows of the intrinsics K, then one line "sf,min_z,max_z"

File lists are sorted lexicographically, matching ``cv::glob`` so image
ordering (and hence per-image lighting indices) is identical to the
reference. Arrays come out row-major ``(n, c, h, w)`` — the transpose of
the reference's column-major MATLAB layout with identical (row, col) pixel
indexing.

Decoding uses the native C++ loader (libpng) when built, else the numpy
codec in ``io/png.py``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ProblemData:
    """Loaded problem inputs (host arrays)."""

    I: np.ndarray  # (n, c, h, w) float32 in [0, 1]
    K: np.ndarray  # (3, 3) float32
    mask: np.ndarray  # (h, w) float32 (0/1-ish; nonzero = masked)
    sf: int
    z0: np.ndarray  # (m, h/sf, w/sf) float32

    @property
    def shape(self):
        return self.I.shape


def _decode_png(path: str) -> np.ndarray:
    """Decode a PNG to a numpy array (native loader if available)."""
    from . import native_loader
    from .png import read_png

    arr = native_loader.decode_png(path)
    return read_png(path) if arr is None else arr


def _read_k_file(path: str):
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    K = np.zeros((3, 3), np.float32)
    for i in range(3):
        vals = [float(v) for v in lines[i].split(",")]
        K[i, :] = vals
    sf_s, min_z_s, max_z_s = lines[3].split(",")
    return K, int(float(sf_s)), float(min_z_s), float(max_z_s)


def _decode_many(files):
    """Decode a list of PNGs in parallel.

    The native libpng decoder runs through ctypes, which releases the GIL,
    so a thread pool gives real decode parallelism (the reference decodes
    its n frames sequentially through cv::imread, Utilities.cpp:330-352);
    the numpy codec's zlib inflate also drops the GIL."""
    from concurrent.futures import ThreadPoolExecutor

    if len(files) <= 1:
        return [_decode_png(f) for f in files]
    with ThreadPoolExecutor(max_workers=min(8, len(files))) as ex:
        return list(ex.map(_decode_png, files))


def load_image_dataset(folder: str) -> ProblemData:
    rgb_files = sorted(glob.glob(os.path.join(folder, "RGB", "*")))
    if not rgb_files:
        raise FileNotFoundError(f"no RGB images under {folder}/RGB")
    imgs = []
    for a in _decode_many(rgb_files):
        if a.ndim == 2:
            a = np.stack([a] * 3, axis=-1)
        imgs.append(a[..., :3].astype(np.float32) / 255.0)
    I = np.stack(imgs)  # (n, h, w, c)
    I = np.moveaxis(I, -1, 1)  # (n, c, h, w), RGB order (Utilities.cpp:335-347)

    K, sf, min_z, max_z = _read_k_file(os.path.join(folder, "K.txt"))

    mask_raw = _decode_png(os.path.join(folder, "mask.png"))
    if mask_raw.ndim == 3:
        mask_raw = mask_raw[..., 0]
    mask = mask_raw.astype(np.float32) / 255.0  # nonzero = masked

    depth_files = sorted(glob.glob(os.path.join(folder, "Depth", "*")))
    z0 = []
    for a in _decode_many(depth_files):
        z0.append(min_z + (a.astype(np.float32) / 65535.0) * (max_z - min_z))
    z0 = np.stack(z0)

    h, w = mask.shape
    hl, wl = h // sf, w // sf
    if z0.shape[1:] != (hl, wl):
        raise ValueError(f"depth shape {z0.shape[1:]} != (h/sf, w/sf) = {(hl, wl)}")
    return ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0)
