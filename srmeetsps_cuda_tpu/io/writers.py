"""Result dumps and visualizations.

The reference dumps ``s.mat/rho.mat/z.mat/N.mat`` every outer iteration
(SRPS.cu:330-333; writers Utilities.cpp:46-122, variable name ``x``,
masked pixels packed in column-major scan order) as its golden-output
verification channel, and shows normals/albedo in OpenCV windows
(SRPS.cu:319-327). Here: ``scipy.io.savemat`` / ``npz`` with the same
packing convention, and PNG snapshots replacing the interactive windows.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..ops.grid import masked_select_colmajor


def import_h5py():
    """h5py, the optional dependency of MAT v7.3 (HDF5) files."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("MAT v7.3 (HDF5) files need the optional h5py "
                          "package; use --dump-format mat5 or npz, or "
                          "MAT v5 input, without it") from e
    return h5py


_MAT73_CLASS = {
    np.dtype(np.float64): b"double",
    np.dtype(np.float32): b"single",
    np.dtype(np.int32): b"int32",
    np.dtype(np.int64): b"int64",
    np.dtype(np.uint8): b"uint8",
}


def save_mat73(path: str, variables: dict):
    """HDF5-based MAT 7.3 writer — the container the reference produces
    (``Mat_CreateVer(..., MAT_FT_MAT73)``, Utilities.cpp:50,69,90).

    Layout per the public format: a 512-byte userblock with the MATLAB
    text header (version 0x0200, endian 'IM'), one dataset per variable
    stored transposed (MATLAB column-major vs HDF5 row-major) with a
    ``MATLAB_class`` attribute. Readable by MATLAB >= 7.3 and h5py."""
    h5py = import_h5py()

    with h5py.File(path, "w", userblock_size=512) as f:
        for name, arr in variables.items():
            a = np.atleast_2d(np.asarray(arr))
            d = f.create_dataset(name, data=a.T)
            cls = _MAT73_CLASS.get(a.dtype)
            if cls is None:
                raise TypeError(f"unsupported MAT 7.3 dtype: {a.dtype}")
            d.attrs.create("MATLAB_class", np.bytes_(cls))
    import time as _time

    text = ("MATLAB 7.3 MAT-file, Platform: posix, Created on: "
            + _time.strftime("%a %b %d %H:%M:%S %Y")
            + " HDF5 schema 1.00 .").encode()[:116]
    header = text.ljust(116, b" ") + b"\x00" * 8 + b"\x00\x02" + b"IM"
    with open(path, "r+b") as f:
        f.write(header.ljust(512, b"\x00"))


def load_mat_any(path: str) -> dict:
    """Read a MAT file of either container (v5 via scipy, 7.3 via h5py),
    returning MATLAB-shaped (column-major-equivalent) arrays."""
    import scipy.io as sio

    try:
        m = sio.loadmat(path)
        return {k: v for k, v in m.items() if not k.startswith("__")}
    except NotImplementedError:
        h5py = import_h5py()

        out = {}
        with h5py.File(path, "r") as f:
            for k in f.keys():
                out[k] = np.asarray(f[k]).T
        return out


def save_vector_mat(path: str, data: np.ndarray, version: str = "7.3"):
    """Single packed vector under variable name 'x' (Utilities.cpp:46-63).
    Default container is MAT 7.3, matching the reference; version='5'
    writes the scipy v5 container (2 GB variable cap)."""
    x = np.asarray(data).reshape(-1, 1)
    if version == "7.3":
        save_mat73(path, {"x": x})
        return
    import scipy.io as sio

    sio.savemat(path, {"x": x})


def save_sparse_mat(path: str, ii, jj, kk, rows: int, cols: int,
                    version: str = "7.3"):
    """COO triplets + dims, the reference's write_MAT_sparse layout
    (Utilities.cpp:85-122): int32 ``ii``/``jj`` (0-based, as stored on
    device), float32 ``kk``, scalar ``rows``/``cols``. MATLAB-diffable via
    ``sparse(ii+1, jj+1, kk, rows, cols)``."""
    variables = {
        "ii": np.asarray(ii, np.int32).reshape(-1, 1),
        "jj": np.asarray(jj, np.int32).reshape(-1, 1),
        "kk": np.asarray(kk, np.float32).reshape(-1, 1),
        "rows": np.int32(rows),
        "cols": np.int32(cols),
    }
    if version == "7.3":
        save_mat73(path, variables)
        return
    import scipy.io as sio

    sio.savemat(path, variables)


def _mat_version(fmt: str) -> str:
    return "5" if fmt == "mat5" else "7.3"


def dump_preprocessing(dirpath: str, zs, z, mask, fmt: str = "mat"):
    """``zs_init.mat`` (full LR grid, SRPS.cu:143) and ``z_init.mat``
    (masked HR initial depth, SRPS.cu:250) — the reference's verification
    channel for the preprocessing chain."""
    os.makedirs(dirpath, exist_ok=True)
    v = _mat_version(fmt)
    save_vector_mat(os.path.join(dirpath, "zs_init.mat"),
                    np.asarray(zs).T.ravel(), version=v)  # colmajor layout
    save_vector_mat(os.path.join(dirpath, "z_init.mat"),
                    masked_select_colmajor(np.asarray(z), np.asarray(mask)),
                    version=v)


def dump_state(dirpath: str, state, mask, fmt: str = "mat", tag: str = ""):
    """Dump s/rho/z/N with the reference's packing (column-major masked).
    fmt: 'mat' = MAT 7.3 (the reference's container), 'mat5' = scipy v5,
    'npz'."""
    os.makedirs(dirpath, exist_ok=True)
    mask = np.asarray(mask)
    z = masked_select_colmajor(np.asarray(state.z), mask)
    rho = np.stack(
        [masked_select_colmajor(np.asarray(c), mask) for c in np.asarray(state.rho)]
    )
    N = np.stack(
        [masked_select_colmajor(np.asarray(k), mask) for k in np.asarray(state.N)]
    )
    s = np.asarray(state.s)
    if fmt in ("mat", "mat5"):
        v = _mat_version(fmt)
        # Reference flattens s as (n, c, 4) row-major contiguous
        # (d_s layout: image-major, then channel, then harmonic).
        save_vector_mat(os.path.join(dirpath, f"s{tag}.mat"), s.reshape(-1),
                        version=v)
        save_vector_mat(os.path.join(dirpath, f"rho{tag}.mat"),
                        rho.reshape(-1), version=v)
        save_vector_mat(os.path.join(dirpath, f"z{tag}.mat"), z, version=v)
        save_vector_mat(os.path.join(dirpath, f"N{tag}.mat"), N.reshape(-1),
                        version=v)
    else:
        np.savez(
            os.path.join(dirpath, f"state{tag}.npz"), s=s, rho=rho, z=z, N=N
        )


def save_checkpoint(path: str, state, iteration: int):
    """Full-resolution resumable checkpoint (the reference dumps but has no
    load path — SURVEY.md section 5; we add resume since it's nearly free)."""
    np.savez(
        path,
        z=np.asarray(state.z),
        rho=np.asarray(state.rho),
        s=np.asarray(state.s),
        N=np.asarray(state.N),
        dz=np.asarray(state.dz),
        energy=np.asarray(state.energy),
        last_energy=np.asarray(state.last_energy),
        iteration=iteration,
    )


def load_checkpoint(path: str):
    """Accepts either the checkpoint file or a dump directory holding
    ``checkpoint.npz``."""
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.npz")
    d = np.load(path)
    return {k: d[k] for k in d.files}


def _to_u8(a):
    return np.clip(a * 255.0, 0, 255).astype(np.uint8)


def normals_image(N, mask) -> np.ndarray:
    """0.5 +/- 0.5 encoding with min-max normalise (Utilities.cpp:280-298)."""
    N = np.asarray(N)
    mask = np.asarray(mask) != 0
    img = np.zeros(mask.shape + (3,), np.float32)
    img[..., 0] = np.clip(0.5 + 0.5 * N[0], 0, 1)
    img[..., 1] = np.clip(0.5 + 0.5 * N[1], 0, 1)
    img[..., 2] = np.clip(0.5 - 0.5 * N[2], 0, 1)
    img *= mask[..., None]
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return _to_u8(img)


def albedo_image(rho, mask) -> np.ndarray:
    """Median + 5 sigma clamp per channel (Utilities.cpp:242-278)."""
    rho = np.asarray(rho)
    mask = np.asarray(mask) != 0
    img = np.zeros(mask.shape + (rho.shape[0],), np.float32)
    for c in range(rho.shape[0]):
        vals = rho[c][mask]
        med = np.median(vals)
        std = float(np.sqrt(np.mean(vals**2) - np.mean(vals) ** 2))
        clamp = med + 5 * std
        img[..., c] = np.clip(np.minimum(rho[c], clamp), 0, 1) * mask
    return _to_u8(img)


def bone_colormap_lut() -> np.ndarray:
    """256x3 uint8 RGB LUT of the MATLAB/OpenCV *bone* colormap — a
    grayscale ramp with a blue cast, piecewise linear with breakpoints at
    3/8 and 3/4 (what cv::applyColorMap(COLORMAP_BONE) applies,
    Utilities.cpp:310)."""
    x = np.linspace(0.0, 1.0, 256)
    r = np.where(x < 0.75, 7.0 * x / 8.0, (11.0 * x - 3.0) / 8.0)
    g = np.where(x < 0.375, 7.0 * x / 8.0,
                 np.where(x < 0.75, (29.0 * x - 3.0) / 24.0,
                          7.0 * x / 8.0 + 0.125))
    b = np.where(x < 0.375, 29.0 * x / 24.0, 7.0 * x / 8.0 + 0.125)
    return _to_u8(np.stack([r, g, b], axis=-1))


def depth_image(z, mask) -> np.ndarray:
    """Negated, min-max normalised over masked pixels, BONE-colormapped
    (z_as_opencv_mat, Utilities.cpp:300-320). Returns (h, w, 3) RGB;
    unmasked pixels are black, as in the reference's zeroed canvas."""
    z = np.asarray(z)
    mask = np.asarray(mask) != 0
    vals = -z[mask]
    lo, hi = vals.min(), vals.max()
    g = np.zeros(mask.shape, np.float32)
    if hi > lo:
        g[mask] = (-z[mask] - lo) / (hi - lo)
    idx = np.clip(g * 255.0, 0, 255).astype(np.uint8)
    img = bone_colormap_lut()[idx]
    img[~mask] = 0
    return img


def save_png(path: str, img_u8: np.ndarray):
    from .png import write_png

    write_png(path, img_u8)


def save_visualizations(dirpath: str, state, mask, tag: str = ""):
    os.makedirs(dirpath, exist_ok=True)
    save_png(os.path.join(dirpath, f"normals{tag}.png"), normals_image(state.N, mask))
    save_png(os.path.join(dirpath, f"albedo{tag}.png"), albedo_image(state.rho, mask))
    save_png(os.path.join(dirpath, f"depth{tag}.png"), depth_image(state.z, mask))
