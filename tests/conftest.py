"""Test configuration: force an 8-device virtual CPU mesh.

jax.config takes effect before the first backend initialisation, so the
tests run on the CPU with 8 devices whatever accelerator the host has
(SURVEY.md section 4: multi-device tests via forced host devices).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_mask(rng, h, w, fill=0.7, blob=True):
    """Random connected-ish mask with irregular boundary, plus guaranteed
    fully-masked and fully-unmasked regions."""
    if blob:
        yy, xx = np.mgrid[0:h, 0:w]
        cy, cx = h / 2 + rng.uniform(-h / 8, h / 8), w / 2 + rng.uniform(-w / 8, w / 8)
        r = min(h, w) * 0.42
        base = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        noise = rng.random((h, w)) < 0.05
        m = base ^ noise
    else:
        m = rng.random((h, w)) < fill
    return m.astype(np.float32)


@pytest.fixture
def small_problem(rng):
    """A tiny random SRPS problem instance for operator tests."""
    h, w, sf, n, c = 24, 16, 2, 4, 3
    mask = random_mask(rng, h, w)
    I = rng.random((n, c, h, w)).astype(np.float32)
    z = (rng.random((h, w)).astype(np.float32) + 0.5) * mask
    rho = (rng.random((c, h, w)).astype(np.float32)) * mask
    s = rng.standard_normal((n, c, 4)).astype(np.float32)
    z0 = (rng.random((n, h // sf, w // sf)).astype(np.float32) + 0.5)
    return dict(h=h, w=w, sf=sf, n=n, c=c, mask=mask, I=I, z=z, rho=rho, s=s,
                z0=z0, fx=531.2, fy=532.8, cx=w / 2 - 0.5, cy=h / 2 - 0.5)
