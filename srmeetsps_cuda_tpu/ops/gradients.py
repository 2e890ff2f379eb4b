"""Masked forward-difference-with-backward-fallback gradients.

The reference builds sparse matrices ``Dx``/``Dy`` over the masked pixel set
(``make_gradient``, SRPS.cu:10-71): per pixel and axis it prefers a forward
difference to the next masked neighbour and falls back (else-if) to a
backward difference; pixels with neither neighbour get a zero row. Here
these are two-point stencils gated by mask-derived boolean fields — pure
shift + select, fused by XLA, no sparse storage at all.

Semantics (x = columns axis ``j``, y = rows axis ``i``, matching the
reference's column-major layout where "right/left" moves by ``h``):

  fwd_x(i,j) = mask(i,j) & mask(i,j+1)                     -> z(i,j+1)-z(i,j)
  bwd_x(i,j) = ~fwd_x & mask(i,j) & mask(i,j-1)            -> z(i,j)-z(i,j-1)
  fwd_y(i,j) = mask(i,j) & mask(i+1,j)                     -> z(i+1,j)-z(i,j)
  bwd_y(i,j) = ~fwd_y & mask(i,j) & mask(i-1,j)            -> z(i,j)-z(i-1,j)

Out-of-bounds neighbours count as unmasked (zero padding).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def _shift_up(a):  # value at (i, j) becomes a(i+1, j); bottom row -> 0
    return jnp.concatenate([a[..., 1:, :], jnp.zeros_like(a[..., :1, :])], axis=-2)


def _shift_down(a):  # value at (i, j) becomes a(i-1, j); top row -> 0
    return jnp.concatenate([jnp.zeros_like(a[..., :1, :]), a[..., :-1, :]], axis=-2)


def _shift_left(a):  # value at (i, j) becomes a(i, j+1); last col -> 0
    return jnp.concatenate([a[..., :, 1:], jnp.zeros_like(a[..., :, :1])], axis=-1)


def _shift_right(a):  # value at (i, j) becomes a(i, j-1); first col -> 0
    return jnp.concatenate([jnp.zeros_like(a[..., :, :1]), a[..., :, :-1]], axis=-1)


class GradientMasks(NamedTuple):
    """Boolean stencil-selection fields derived from the HR mask.

    Encodes exactly the reference's forward-else-backward choice per pixel
    and axis (SRPS.cu:29-48).
    """

    fwd_x: jax.Array
    bwd_x: jax.Array
    fwd_y: jax.Array
    bwd_y: jax.Array

    @staticmethod
    def from_mask(mask: jax.Array) -> "GradientMasks":
        m = mask != 0
        fwd_x = m & _shift_left(m)
        bwd_x = m & _shift_right(m) & ~fwd_x
        fwd_y = m & _shift_up(m)
        bwd_y = m & _shift_down(m) & ~fwd_y
        f32 = lambda b: b.astype(jnp.float32)
        return GradientMasks(f32(fwd_x), f32(bwd_x), f32(fwd_y), f32(bwd_y))


def grad_x(z: jax.Array, gm: GradientMasks) -> jax.Array:
    """``Dx @ z`` on the dense grid."""
    return gm.fwd_x * (_shift_left(z) - z) + gm.bwd_x * (z - _shift_right(z))


def grad_y(z: jax.Array, gm: GradientMasks) -> jax.Array:
    """``Dy @ z`` on the dense grid."""
    return gm.fwd_y * (_shift_up(z) - z) + gm.bwd_y * (z - _shift_down(z))


def grad_x_t(y: jax.Array, gm: GradientMasks) -> jax.Array:
    """``Dx^T @ y``.

    Row ``p`` of Dx scatters ``+1`` to its chosen neighbour and ``-1`` to
    itself (forward) or the mirror (backward); the adjoint gathers those
    contributions. Output support stays inside the mask by construction.
    """
    fy = gm.fwd_x * y
    by = gm.bwd_x * y
    return _shift_right(fy) - fy + by - _shift_left(by)


def grad_y_t(y: jax.Array, gm: GradientMasks) -> jax.Array:
    """``Dy^T @ y``."""
    fy = gm.fwd_y * y
    by = gm.bwd_y * y
    return _shift_down(fy) - fy + by - _shift_up(by)
