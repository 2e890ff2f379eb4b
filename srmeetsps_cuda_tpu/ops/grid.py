"""Dense-grid operators replacing the reference's sparse matrices.

The reference builds explicit COO/CSR matrices for the downsampling operator
``D`` (Utilities.cpp:201-220), its mask-filtered version ``KT``
(SRPS.cu:170-193) and applies them with cuSPARSE SpMV. Every one of these
is a *structured* operator on the regular image grid, so we keep all state
as dense ``(h, w)`` arrays (zeros outside the mask, static shapes for XLA)
and express the operators as reshapes/reductions that XLA fuses into its
loop kernels — no gather/scatter, no dynamic shapes.

Conventions
-----------
Arrays are row-major ``(h, w)``: axis 0 is the image row ``i``, axis 1 the
column ``j``. This is the transpose of the reference's column-major MATLAB
layout but indexes pixels identically (reference linear index ``i + j*h``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def box_downsample(z: jax.Array, sf: int) -> jax.Array:
    """sf x sf box average: the dense equivalent of the reference's ``D``.

    ``D`` has one row per LR pixel with ``sf*sf`` entries of value
    ``1/sf^2`` covering the corresponding HR tile (Utilities.cpp:201-220),
    i.e. exactly a box mean over aligned sf x sf tiles.

    Works on arrays of shape ``(..., h, w)`` with ``h % sf == w % sf == 0``.
    """
    *lead, h, w = z.shape
    if h % sf or w % sf:
        raise ValueError(f"box_downsample: ({h},{w}) not divisible by sf={sf}")
    window = (1,) * len(lead) + (sf, sf)
    s = jax.lax.reduce_window(z, 0.0, jax.lax.add, window, window, "VALID")
    return s / float(sf * sf)


def box_upsample_adjoint(u: jax.Array, sf: int) -> jax.Array:
    """Adjoint of :func:`box_downsample`: ``D^T u``.

    Replicates each LR value into its sf x sf HR tile and scales by
    ``1/sf^2`` (each ``D`` entry is ``1/sf^2``).
    """
    *lead, hl, wl = u.shape
    up = jnp.broadcast_to(
        u[..., :, None, :, None], (*lead, hl, sf, wl, sf)
    ).reshape(*lead, hl * sf, wl * sf)
    return up / float(sf * sf)


def make_ktw(mask: jax.Array, masks: jax.Array, sf: int) -> jax.Array:
    """``diag(KT^T KT)`` on the HR grid: ``mask * up(masks) / sf^4``.

    Each masked HR pixel under a kept LR pixel has exactly one ``KT`` entry
    of ``1/sf^2`` in its column, so the diagonal of ``KT^T KT`` is that
    entry squared (the Jacobi preconditioner's data-term part)."""
    hl, wl = masks.shape
    up = jnp.broadcast_to(masks[:, None, :, None], (hl, sf, wl, sf)
                          ).reshape(hl * sf, wl * sf)
    return mask * up / float(sf**4)


def lr_mask(mask: jax.Array, sf: int) -> jax.Array:
    """Low-resolution mask: ``D @ mask`` then zero entries ``< 1``.

    Mirrors SRPS.cu:110-111 (SpMV + ``thrust::replace_if(<1 -> 0)``): an LR
    pixel is kept iff *all* sf x sf HR pixels under it are masked.
    """
    m = box_downsample(mask.astype(jnp.float32), sf)
    return jnp.where(m >= 1.0, 1.0, 0.0)


def resample_masked(z: jax.Array, masks: jax.Array, sf: int) -> jax.Array:
    """``KT @ z``: masked box downsample.

    ``KT`` is ``D`` restricted to masked LR rows and masked HR columns, all
    values ``1/sf^2`` (SRPS.cu:170-193). With ``z`` dense and zeroed outside
    the HR mask, dropping unmasked columns is automatic; row restriction is
    the multiply by the LR mask.
    """
    return box_downsample(z, sf) * masks


def resample_masked_t(u: jax.Array, mask: jax.Array, masks: jax.Array, sf: int) -> jax.Array:
    """``KT^T @ u``: adjoint of :func:`resample_masked`.

    Keeps the result supported on the HR mask (KT's columns only cover
    masked HR pixels).
    """
    return box_upsample_adjoint(u * masks, sf) * mask


def meshgrid_camera(h: int, w: int, cx: float, cy: float, dtype=jnp.float32):
    """Camera-centred pixel coordinates.

    Mirrors the ``meshgrid_create`` kernel (devicecalls.cu:151-158):
    ``xx = j - cx`` (column minus principal point x = K[0,2]),
    ``yy = i - cy`` (row minus principal point y = K[1,2]).
    Returns two ``(h, w)`` arrays.
    """
    jj = jax.lax.broadcasted_iota(dtype, (h, w), 1)
    ii = jax.lax.broadcasted_iota(dtype, (h, w), 0)
    return jj - jnp.asarray(cx, dtype), ii - jnp.asarray(cy, dtype)


def mean_across_frames(z0: jax.Array):
    """Per-pixel mean of the LR depth frames with missing-data flags.

    Mirrors the ``mean_across_channels`` kernel (devicecalls.cu:95-110):
    zeros are skipped in the numerator but the denominator is the *full*
    frame count ``n`` (a reference quirk we reproduce), and a pixel is
    flagged for inpainting if *any* frame is zero there.

    Args:
      z0: ``(n, h, w)`` stack of LR depth maps, 0 = missing.

    Returns:
      ``(mean, inpaint_locations)`` both ``(h, w)``; the flag array is bool.
    """
    n = z0.shape[0]
    mean = jnp.sum(z0, axis=0) / float(n)  # zeros contribute nothing
    inpaint = jnp.any(z0 == 0.0, axis=0)
    return mean, inpaint


def masked_select_colmajor(arr, mask):
    """Gather masked values in the reference's column-major scan order.

    The reference compacts masked pixels with ``thrust::copy_if`` over
    column-major buffers (SRPS.cu:231,239,246), so dumps/goldens index
    pixels in Fortran order. Host-side (NumPy) utility for IO and tests.
    """
    import numpy as np

    a = np.asarray(arr)
    m = np.asarray(mask) != 0
    return a.T[m.T]


def masked_scatter_colmajor(values, mask):
    """Inverse of :func:`masked_select_colmajor`: dense (h, w) from packed."""
    import numpy as np

    m = np.asarray(mask) != 0
    out = np.zeros(m.shape, dtype=np.asarray(values).dtype)
    outT = out.T
    outT[m.T] = values
    return outT.T

