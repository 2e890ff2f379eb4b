"""Depth-hole inpainting: JAX substitute for ``cv::INPAINT_TELEA``.

The reference fills missing LR depth (pixels where any frame reported 0)
with OpenCV's Telea fast-marching inpaint, radius 16 (SRPS.cu:129-133).
Telea's FMM is inherently sequential; the data-parallel equivalent is a
confidence-weighted diffusion fill: a coarse-to-fine pyramid seed (so
arbitrarily large holes converge in O(log) work) followed by Jacobi
smoothing iterations of the masked harmonic equation. Acceptance is
downstream-metric-based (final depth RMSE), per SURVEY.md section 7 —
Telea is not bitwise reproducible nor does it need to be: the filled
values only feed the *initialisation* of z and the LR data term on pixels
that are almost all inside the valid mask anyway.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

_KERNEL = jnp.array(
    [[0.5, 1.0, 0.5], [1.0, 0.0, 1.0], [0.5, 1.0, 0.5]], jnp.float32
)


def _conv3(x):
    return lax.conv_general_dilated(
        x[None, None],
        _KERNEL[None, None],
        window_strides=(1, 1),
        padding="SAME",
    )[0, 0]


def _down2(x):
    h, w = x.shape
    ph, pw = h % 2, w % 2
    if ph or pw:
        x = jnp.pad(x, ((0, ph), (0, pw)))
    h2, w2 = x.shape
    return x.reshape(h2 // 2, 2, w2 // 2, 2).sum(axis=(1, 3))


def _up2(x, h, w):
    up = jnp.repeat(jnp.repeat(x, 2, axis=0), 2, axis=1)
    return up[:h, :w]


@partial(jax.jit, static_argnames=("iters",))
def inpaint_diffusion(img: jax.Array, holes: jax.Array, iters: int = 256) -> jax.Array:
    """Fill ``holes`` (bool/0-1 array, 1 = missing) in ``img``.

    Known pixels are preserved exactly; holes receive a smooth (harmonic)
    extension of the surrounding values.
    """
    img = jnp.asarray(img, jnp.float32)
    known = 1.0 - jnp.asarray(holes, jnp.float32)
    h, w = img.shape

    # Coarse-to-fine pyramid seed: average known values down until every
    # cell has support, then propagate back up into the holes.
    levels = []
    num, den = img * known, known
    size = max(h, w)
    while size > 1:
        levels.append((num, den))
        num, den = _down2(num), _down2(den)
        size = (size + 1) // 2
    fill = num / jnp.maximum(den, 1e-20)  # 1x-ish coarsest level
    for num_l, den_l in reversed(levels):
        hl, wl = num_l.shape
        fill = _up2(fill, hl, wl)
        has = den_l > 0
        fill = jnp.where(has, num_l / jnp.maximum(den_l, 1e-20), fill)
    seed = jnp.where(known > 0, img, fill)

    # Jacobi relaxation of the harmonic fill on the hole set.
    def body(_, u):
        avg = _conv3(u) / 6.0
        return jnp.where(known > 0, img, avg)

    return lax.fori_loop(0, iters, body, seed)
