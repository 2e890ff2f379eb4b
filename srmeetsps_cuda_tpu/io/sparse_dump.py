"""Sparse-operator triplet dumps — the reference's golden debug channel.

The reference can dump any sparse operator as a MAT file holding the COO
triplets ``ii/jj/kk`` plus ``rows/cols`` scalars (``write_MAT_sparse``,
Utilities.cpp:85-122), MATLAB-diffable via ``sparse(ii+1, jj+1, kk)``. This
framework designed those matrices out (the operators are dense-grid
stencils/resamples), so this module *reconstructs* the equivalent COO
triplets from the product's own operator fields — the GradientMasks
booleans and the LR mask — purely for the verification channel.

Index conventions match the reference exactly: pixels are scanned in
column-major order (linear index ``i + j*h``), masked-space indices come
from that scan restricted to the mask (SRPS.cu:151-168), and the indices
are written 0-based as stored on device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _colmajor_masked_index(mask: np.ndarray) -> np.ndarray:
    """index_in_masked_matrix (SRPS.cu:160-168): for each column-major
    linear pixel index, its position among masked pixels (garbage where
    unmasked)."""
    m = (np.asarray(mask) != 0).T.ravel()  # column-major scan
    return np.cumsum(m) - 1


def _canon(ii, jj, kk) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Canonical (row, col)-sorted order. The reference's nnz ordering is a
    build artifact; MATLAB ``sparse()`` is order-insensitive, so dumps are
    emitted canonically sorted for direct diffing."""
    order = np.lexsort((jj, ii))
    return (ii[order].astype(np.int32), jj[order].astype(np.int32),
            kk[order].astype(np.float32))


def gradient_coo(gm, mask) -> Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...], int]:
    """COO triplets of ``Dx`` and ``Dy`` over masked-index space.

    Derived from the product's GradientMasks stencil-selection fields; the
    entries are the reference's (SRPS.cu:23-71): forward difference puts
    +1 at the next masked neighbour and -1 at self, backward difference
    +1 at self and -1 at the previous.

    Returns ((ii, jj, kk) for Dx, same for Dy, npix).
    """
    mask = np.asarray(mask)
    h, w = mask.shape
    midx = _colmajor_masked_index(mask)
    npix = int((mask != 0).sum())

    def mp(i, j):
        return midx[i + j * h]

    def axis_coo(fwd, bwd, di, dj):
        fi, fj = np.nonzero(np.asarray(fwd) != 0)
        bi, bj = np.nonzero(np.asarray(bwd) != 0)
        rows = np.concatenate([mp(fi, fj), mp(fi, fj),
                               mp(bi, bj), mp(bi, bj)])
        cols = np.concatenate([mp(fi + di, fj + dj), mp(fi, fj),
                               mp(bi, bj), mp(bi - di, bj - dj)])
        vals = np.concatenate([np.ones_like(fi, np.float32),
                               -np.ones_like(fi, np.float32),
                               np.ones_like(bi, np.float32),
                               -np.ones_like(bi, np.float32)])
        return _canon(rows, cols, vals)

    dx = axis_coo(gm.fwd_x, gm.bwd_x, 0, 1)
    dy = axis_coo(gm.fwd_y, gm.bwd_y, 1, 0)
    return dx, dy, npix


def downsample_coo(h: int, w: int, sf: int):
    """COO triplets of the full-grid box-downsampling matrix ``D``
    (Utilities.cpp:201-220): one row per LR pixel, sf*sf entries of value
    1/sf^2 over the corresponding HR tile, column-major index space."""
    hl, wl = h // sf, w // sf
    il, jl = np.meshgrid(np.arange(hl), np.arange(wl), indexing="ij")
    rows = (il + jl * hl).ravel()
    k, jx = np.meshgrid(np.arange(sf), np.arange(sf), indexing="ij")
    # HR linear (colmajor) indices of the tile under each LR pixel.
    hr = ((il[..., None, None] * sf + k) +
          (jl[..., None, None] * sf + jx) * h)
    rows = np.repeat(rows, sf * sf)
    cols = hr.reshape(hl * wl, sf * sf).ravel()
    vals = np.full(rows.shape, 1.0 / (sf * sf), np.float32)
    return _canon(rows, cols, vals) + (hl * wl, h * w)


def kt_coo(mask, masks, sf: int):
    """COO triplets of ``KT``: ``D`` restricted to masked LR rows and
    masked HR columns, values 1/sf^2 (SRPS.cu:170-193). Shape
    npixs x npix in masked-index spaces."""
    mask = np.asarray(mask)
    masks = np.asarray(masks)
    h, w = mask.shape
    ii, jj, kk, _, _ = downsample_coo(h, w, sf)
    m_hr = (mask != 0).T.ravel()
    m_lr = (masks != 0).T.ravel()
    keep = m_lr[ii] & m_hr[jj]
    midx_lr = _colmajor_masked_index(masks)
    midx_hr = _colmajor_masked_index(mask)
    return (_canon(midx_lr[ii[keep]], midx_hr[jj[keep]], kk[keep])
            + (int(m_lr.sum()), int(m_hr.sum())))


def dump_operators(dirpath: str, prob, sf: int) -> None:
    """Write D/Dx/Dy/KT triplet MAT files (the reference's
    WRITE_MAT_FROM_DEVICE_SPARSE channel, Utilities.h:84-96)."""
    import os

    from .writers import save_sparse_mat

    mask = np.asarray(prob.mask)
    h, w = mask.shape
    os.makedirs(dirpath, exist_ok=True)
    dx, dy, npix = gradient_coo(prob.gm, mask)
    save_sparse_mat(os.path.join(dirpath, "Dx.mat"), *dx, npix, npix)
    save_sparse_mat(os.path.join(dirpath, "Dy.mat"), *dy, npix, npix)
    save_sparse_mat(os.path.join(dirpath, "D.mat"), *downsample_coo(h, w, sf))
    save_sparse_mat(os.path.join(dirpath, "KT.mat"), *kt_coo(mask, prob.masks, sf))
