"""Bicubic resize matching ``cv::resize(..., INTER_CUBIC)``.

The reference upsamples the smoothed LR depth to HR with OpenCV bicubic
interpolation (SRPS.cu:146-149). OpenCV uses the Keys cubic kernel with
A = -0.75, half-pixel-centre alignment ``src = (dst + 0.5) * (in/out) - 0.5``
and replicate clamping of the 4-tap neighbourhood at the borders.

Separable implementation as two dense interpolation-matrix GEMMs
(``W_h @ img @ W_w^T``) — the matrices are built host-side once per shape
and the GEMMs go to the device's matrix library, so this is also the fast
path for repeated / batched use (vmap maps it to batched GEMM).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_A = -0.75  # OpenCV's bicubic coefficient


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Keys kernel weights for the 4 taps at offsets (-1, 0, 1, 2) given
    the fractional position t in [0, 1). Mirrors OpenCV interpolateCubic."""
    A = _A
    w = np.empty(t.shape + (4,), np.float64)
    w[..., 0] = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w[..., 1] = ((A + 2) * t - (A + 3)) * t * t + 1
    w[..., 2] = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    w[..., 3] = 1.0 - w[..., 0] - w[..., 1] - w[..., 2]
    return w


@functools.lru_cache(maxsize=32)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bicubic interpolation matrix with replicate
    border clamping."""
    scale = n_in / n_out
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    w = _cubic_weights(t)
    W = np.zeros((n_out, n_in), np.float64)
    for tap in range(4):
        idx = np.clip(i0 - 1 + tap, 0, n_in - 1)
        np.add.at(W, (dst.astype(np.int64), idx), w[..., tap])
    return W.astype(np.float32)


def resize_bicubic(img: jax.Array, out_h: int, out_w: int) -> jax.Array:
    """Resize trailing (h, w) dims of ``img`` to (out_h, out_w)."""
    *lead, h, w = img.shape
    Wh = jnp.asarray(_interp_matrix(h, out_h))
    Ww = jnp.asarray(_interp_matrix(w, out_w))
    out = jnp.einsum(
        "oi,...iw->...ow", Wh, jnp.asarray(img, jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    out = jnp.einsum(
        "pw,...hw->...hp", Ww, out, precision=jax.lax.Precision.HIGHEST
    )
    return out
