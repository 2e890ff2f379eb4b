"""MATLAB ``.mat`` dataset loader (reference ``MatFileDataHandler``,
Utilities.cpp:159-199).

Reads variables ``I`` (h x w x c x n double), ``K`` (3x3 double), ``mask``
(h x w uint8), ``sf`` (double scalar), ``z0`` (h/sf x w/sf [x m] double)
from either MAT v5 (scipy.io) or MAT v7.3/HDF5 (h5py) files — the matio
1.5.10 dependency replaced by pure Python.

MATLAB stores column-major; we transpose into the framework's row-major
``(n, c, h, w)`` convention.
"""

from __future__ import annotations

import numpy as np

from .image_loader import ProblemData


def _load_vars_v5(path):
    import scipy.io as sio

    m = sio.loadmat(path)
    return {k: m[k] for k in ("I", "K", "mask", "sf", "z0")}


def _load_vars_v73(path):
    from .writers import import_h5py

    h5py = import_h5py()

    out = {}
    with h5py.File(path, "r") as f:
        for k in ("I", "K", "mask", "sf", "z0"):
            # h5py exposes MATLAB arrays with reversed (C-order) dims;
            # transpose back to MATLAB's logical dim order.
            a = np.asarray(f[k])
            out[k] = a.transpose(range(a.ndim)[::-1])
    return out

def save_mat_dataset(path: str, data: ProblemData, fmt: str = "mat73"):
    """Write a ProblemData as a MATLAB dataset file (the reference's input
    container: variables ``I, K, mask, sf, z0`` in MATLAB column-major dim
    order, Utilities.cpp:159-199). ``fmt``: ``mat73`` (HDF5, the
    reference's mitten_sf2.mat era container) or ``mat5`` (scipy.io).

    The inverse of :func:`load_mat_dataset` — used to convert image-folder
    datasets to the MATLAB input path and by the round-trip tests/bench."""
    # I/K/z0 must be doubles: the reference's MatFileDataHandler memcpy's
    # their payloads as double (Utilities.cpp:124-131,173,195) — float32
    # variables would be decoded as garbage by the reference binary.
    I = np.moveaxis(np.asarray(data.I, np.float64),
                    (0, 1, 2, 3), (3, 2, 0, 1))  # (h,w,c,n)
    z0 = np.moveaxis(np.asarray(data.z0, np.float64), 0, -1)  # (h/sf,w/sf,m)
    out = {
        "I": I,
        "K": np.asarray(data.K, np.float64),
        "mask": (np.asarray(data.mask) != 0).astype(np.uint8),
        "sf": np.float64(data.sf),
        "z0": z0,
    }
    if fmt == "mat5":
        import scipy.io as sio

        sio.savemat(path, out)
        return
    from .writers import save_mat73

    save_mat73(path, out)


def load_mat_dataset(path: str) -> ProblemData:
    try:
        v = _load_vars_v5(path)
    except (NotImplementedError, ValueError):
        v = _load_vars_v73(path)

    I = np.asarray(v["I"], np.float32)  # (h, w, c, n) MATLAB dims
    if I.ndim == 3:
        I = I[..., None]
    I = np.moveaxis(I, (0, 1, 2, 3), (2, 3, 1, 0))  # -> (n, c, h, w)

    K = np.asarray(v["K"], np.float32).reshape(3, 3)
    mask = np.asarray(v["mask"], np.float32)
    sf = int(np.asarray(v["sf"]).ravel()[0])

    z0 = np.asarray(v["z0"], np.float32)
    if z0.ndim == 2:
        z0 = z0[..., None]
    z0 = np.moveaxis(z0, -1, 0)  # (m, h/sf, w/sf)
    return ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0)
