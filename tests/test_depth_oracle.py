"""The single-device depth solve (``estimate_depth``: the collapsed
matvec inside solve/cg.py) against the oracle's explicit sparse normal
equations, across scale factors, Jacobi preconditioning and mask kinds."""

import numpy as np
import pytest
import jax.numpy as jnp

import oracle
from conftest import random_mask
from srmeetsps_cuda_tpu.config import SolverConfig
from srmeetsps_cuda_tpu.models import srps
from srmeetsps_cuda_tpu.ops.grid import masked_select_colmajor as pack

H, W, N, C = 24, 16, 3, 3
CG_CAP = 4  # short horizon: f32 and f64 iterates still agree closely


def _mask(rng, kind):
    if kind == "full":
        return np.ones((H, W), np.float32)
    return random_mask(rng, H, W, blob=(kind == "blob"))


def _case(rng, sf, kind):
    mask = _mask(rng, kind)
    I = rng.random((N, C, H, W)).astype(np.float32)
    fx, fy, cx, cy = 531.2, 532.8, W / 2 - 0.5, H / 2 - 0.5
    K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
    z0s = (rng.random((H // sf, W // sf)).astype(np.float32) + 0.5)
    prob = srps.build_problem(I, mask, K, sf, z0s)
    z = (rng.random((H, W)).astype(np.float32) + 0.5) * mask
    st = srps.init_state(prob, z)
    s = jnp.asarray(rng.standard_normal((N, C, 4)).astype(np.float32))
    rho = jnp.asarray(rng.random((C, H, W)).astype(np.float32) * mask)
    mom = srps.s_moments(prob, s)

    Dx, Dy, _, _ = oracle.make_gradient(mask.T.ravel(), H, W)
    _, _, KT = oracle.lr_mask_and_KT(mask.T.ravel(), H, W, sf)
    I_pack = np.stack([np.stack([
        pack(np.asarray(prob.I[c, i]).reshape(H, W), mask) for c in range(C)])
        for i in range(N)])
    rho_p = np.stack([pack(np.asarray(rho[c]), mask) for c in range(C)])
    M, rhs, A, B = oracle.depth_system(
        rho_p, pack(np.asarray(st.dz), mask), np.asarray(s, np.float64),
        pack(np.asarray(prob.xx), mask), pack(np.asarray(prob.yy), mask),
        fx, fy, Dx, Dy, KT, pack(np.asarray(prob.z0s), np.asarray(prob.masks)),
        I_pack)
    z0s_pack = pack(np.asarray(prob.z0s), np.asarray(prob.masks))
    return prob, st, mom, rho, mask, M, rhs, A, B, KT, z0s_pack


@pytest.mark.parametrize("mask_kind", ["blob", "random", "full"])
@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("sf", [1, 2, 4])
def test_estimate_depth_matches_oracle_cg(rng, sf, jacobi, mask_kind):
    prob, st, mom, rho, mask, M, rhs, A, B, KT, z0s_pack = _case(
        rng, sf, mask_kind)
    cfg = SolverConfig(cg_max_iter=CG_CAP, cg_tol=1e-30,
                       jacobi_preconditioner=jacobi)
    z_new, energy, iters = srps.estimate_depth(prob, mom, rho, st.dz, st.z,
                                               sf, cfg)
    x0 = pack(np.asarray(st.z), mask)
    solver = oracle.pcg_jacobi if jacobi else oracle.cg
    z_want, k_want = solver(M, rhs - M @ x0, x0, tol=1e-30, max_iter=CG_CAP)
    assert int(iters) == k_want == CG_CAP + 1
    got = pack(np.asarray(z_new), mask)
    rms = np.sqrt(np.mean(z_want ** 2))
    assert np.sqrt(np.mean((got - z_want) ** 2)) / rms < 1e-3
    # Unmasked pixels stay exactly zero.
    assert np.all(np.asarray(z_new)[mask == 0] == 0)
    e_want = oracle.depth_energy(z_want, A, B, KT, z0s_pack)
    np.testing.assert_allclose(float(energy), e_want, rtol=1e-3)
