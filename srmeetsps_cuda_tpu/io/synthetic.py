"""Exactly-consistent synthetic datasets, rendered from a seed.

The images are rendered with the solver's OWN masked-stencil normals of a
known surface, so photometric consistency is exact: ``I = rho * (N(z) . s)``.
The surface carries high-frequency detail (wavelength ~2.6 px) that the
bicubic initialisation cannot recover from the sf-downsampled depth — the
information exists only in the images, so recovering it tests the solver's
core claim. Used by the tests, ``bench.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

from .image_loader import ProblemData

# The Mitten fixture's geometry (960x1280 HR, 20 RGB images, sf=2,
# fx = fy = 1216.73): the reference's shipped dataset.
MITTEN_GEOMETRY = dict(h=960, w=1280, sf=2, n=20, c=3, f=1216.73)


def disc_mask(h: int, w: int, radius: float = 0.45) -> np.ndarray:
    """Centred disc of ``radius * min(h, w)``, as float32 0/1."""
    yy, xx = np.mgrid[0:h, 0:w]
    return (((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
            < (radius * min(h, w)) ** 2).astype(np.float32)


def surface(h: int, w: int, hf_amp: float = 1.5) -> np.ndarray:
    """Smooth depth field plus high-frequency detail, (h, w) float32."""
    yy, xx = np.mgrid[0:h, 0:w]
    return (80 + 6 * np.sin(xx / 5.0) + 5 * np.cos(yy / 6.0)
            + hf_amp * np.sin(2.4 * xx) * np.cos(2.2 * yy)).astype(np.float32)


def render_consistent(rng: np.random.Generator, mask: np.ndarray, *,
                      sf: int = 2, n: int = 6, c: int = 3,
                      hf_amp: float = 1.5, noise: float = 1.0,
                      f: float = 400.0):
    """Render a dataset on ``mask``'s grid. Draws from ``rng`` in a fixed
    order (albedo, then each image's lighting, then the LR depth noise),
    so a seed fixes the dataset. Returns (ProblemData, z_true, N_true)."""
    import jax.numpy as jnp

    from ..ops import gradients as gradops
    from ..ops.grid import meshgrid_camera
    from ..ops.normals import normals_from_depth

    mask = np.asarray(mask, np.float32)
    h, w = mask.shape
    z_true = surface(h, w, hf_amp)
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    gm = gradops.GradientMasks.from_mask(jnp.asarray(mask))
    zt = jnp.asarray(z_true * mask)
    zx, zy = gradops.grad_x(zt, gm), gradops.grad_y(zt, gm)
    xx, yy = meshgrid_camera(h, w, cx, cy)
    N_true, _ = normals_from_depth(zt, zx, zy, xx * mask, yy * mask,
                                   jnp.asarray(mask), f, f)
    N_true = np.asarray(N_true)
    rho_true = (0.4 + 0.3 * rng.random((c, 1, 1))).astype(np.float32)
    I = np.empty((n, c, h, w), np.float32)
    for i in range(n):
        s = np.array([0.2, 0.2, -0.9, 0.3]) + 0.2 * rng.standard_normal(4)
        shade = np.einsum("k,khw->hw", s.astype(np.float32), N_true)
        I[i] = (rho_true * shade[None]) * mask
    z0 = np.stack([
        z_true[::sf, ::sf] + noise * rng.standard_normal((h // sf, w // sf))
        for _ in range(n)]).astype(np.float32)
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    return ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0), z_true, N_true


def mean_normal_error_deg(N, N_true, mask) -> float:
    """Mean angle (degrees) between estimated and true normals over the
    mask."""
    m = np.asarray(mask) != 0
    dot = np.clip((np.asarray(N)[:3] * np.asarray(N_true)[:3]).sum(0), -1, 1)
    return float(np.degrees(np.arccos(dot[m])).mean())
