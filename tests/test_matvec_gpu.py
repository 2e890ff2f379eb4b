"""The GPU depth-CG kernel (solve/matvec_gpu.py) in interpret mode against
its plain reference ``models.srps.depth_matvec``, and the choice of kernel
per lowering platform."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import lax

from conftest import random_mask
from srmeetsps_cuda_tpu.config import SolverConfig
from srmeetsps_cuda_tpu.models import srps
from srmeetsps_cuda_tpu.parallel import batched
from srmeetsps_cuda_tpu.solve import matvec_gpu
from srmeetsps_cuda_tpu.solve.cg import conjugate_gradient


def _problem(rng, h, w, sf, full=False):
    mask = (np.ones((h, w), np.float32) if full
            else random_mask(rng, h, w))
    I = rng.random((3, 3, h, w)).astype(np.float32)
    K = [[300.0, 0, w / 2 - 0.5], [0, 300.0, h / 2 - 0.5], [0, 0, 1]]
    z0s = (rng.random((h // sf, w // sf)).astype(np.float32) + 0.5)
    prob = srps.build_problem(I, mask, K, sf, z0s)
    z = (rng.random((h, w)).astype(np.float32) + 0.5) * mask
    st = srps.init_state(prob, z)
    mom = srps.s_moments(prob, st.s)
    op = srps.build_depth_operator(prob, mom, st.rho, st.dz, 1.0)
    return prob, st, op


# (16, 64) is one exact tile; (40, 72) ragged tiles; (8, 16) smaller than
# a tile in both directions.
@pytest.mark.parametrize("shape", [(16, 64), (40, 72), (8, 16)])
@pytest.mark.parametrize("sf", [1, 2, 4])
def test_kernel_matches_depth_matvec(rng, sf, shape):
    prob, st, op = _problem(rng, *shape, sf)
    v = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    w, pw = matvec_gpu.depth_matvec_dot(v, op, prob, sf, 1.0, interpret=True)
    ref = srps.depth_matvec(v, op, prob, sf, 1.0)
    scale = float(jnp.max(jnp.abs(ref)))
    assert float(jnp.max(jnp.abs(w - ref))) <= 1e-5 * scale
    pw_ref = float(jnp.vdot(v, ref, precision=lax.Precision.HIGHEST))
    np.testing.assert_allclose(float(pw), pw_ref, rtol=1e-5,
                               atol=1e-6 * scale * v.size)


def test_kernel_full_mask_and_lambda(rng):
    prob, st, op = _problem(rng, 24, 32, 2, full=True)
    v = st.z
    w, _ = matvec_gpu.depth_matvec_dot(v, op, prob, 2, 0.25, interpret=True)
    ref = srps.depth_matvec(v, op, prob, 2, 0.25)
    np.testing.assert_allclose(np.asarray(w), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(jnp.max(jnp.abs(ref))))


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
def test_cg_with_kernel_matches_plain_cg(rng, jacobi):
    """solve/cg.py with the fused matvec+dot follows the plain recurrence."""
    sf = 2
    prob, st, op = _problem(rng, 40, 72, sf)
    mv = functools.partial(srps.depth_matvec, op=op, prob=prob, sf=sf,
                           lam=1.0)
    b = srps.depth_rhs(op, prob, sf, 1.0) - mv(st.z)
    diag = srps.depth_diag(op, prob, sf, 1.0)
    precond = (lambda r: r / diag) if jacobi else None
    ref = conjugate_gradient(mv, b, st.z, tol=1e-30, max_iter=4,
                             precond=precond)
    got = conjugate_gradient(
        mv, b, st.z, tol=1e-30, max_iter=4, precond=precond,
        matvec_dot=lambda p: matvec_gpu.depth_matvec_dot(
            p, op, prob, sf, 1.0, interpret=True))
    assert int(got.iterations) == int(ref.iterations) == 5
    rms = float(jnp.sqrt(jnp.mean(ref.x ** 2)))
    assert float(jnp.sqrt(jnp.mean((got.x - ref.x) ** 2))) < 1e-4 * rms


def _lowered(fn, args, platform):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,kernel", [("cpu", False), ("cuda", True)])
def test_iteration_picks_kernel_per_platform(rng, platform, kernel):
    """One outer iteration lowered for each platform: the Triton kernel is
    in the CUDA program and only there; the CPU program stays plain."""
    prob, st, _ = _problem(rng, 24, 32, 2)
    cfg = SolverConfig(cg_max_iter=3)
    txt = _lowered(lambda s, p: srps.srps_iteration(s, p, 2, cfg),
                   (st, prob), platform)
    assert ("depth_matvec_dot" in txt) is kernel
    assert ("triton" in txt) is kernel


def test_lockstep_batch_lowers_kernel_for_cuda(rng):
    """vmap (lockstep batches) batches the kernel's grid."""
    pairs = [_problem(rng, 24, 32, 2)[:2] for _ in range(2)]
    probs = batched.stack_problems([p for p, _ in pairs])
    states = batched.stack_states([s for _, s in pairs])
    cfg = SolverConfig(cg_max_iter=3)
    txt = _lowered(jax.vmap(lambda s, p: srps.srps_iteration(s, p, 2, cfg)),
                   (states, probs), "cuda")
    assert "depth_matvec_dot" in txt
