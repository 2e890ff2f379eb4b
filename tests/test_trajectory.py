"""Full alternating-optimization trajectory parity vs the oracle.

The strongest correctness test: run the complete outer loop both in the
framework (dense masked grids, collapsed Gram-field operators,
matrix-free f32 CG) and in the oracle (explicit sparse matrices mirroring
the reference's COO construction, f64 CG), and compare s / rho / z after
every iteration. This exercises the exact interplay the reference binary
has: lighting uses old rho/N, albedo uses new s, depth uses new s/rho with
frozen dz, normals recomputed last (SRPS.cu:276-335).
"""

import numpy as np
import jax.numpy as jnp

from conftest import random_mask
from srmeetsps_cuda_tpu.config import SolverConfig
from srmeetsps_cuda_tpu.models import srps
from srmeetsps_cuda_tpu.ops.grid import masked_select_colmajor as pack
import oracle


def oracle_iteration(state_o, fixtures, cg_max_iter=100):
    """One outer iteration in oracle-land (packed masked vectors)."""
    (Dx, Dy, KT, I_pack, xx_p, yy_p, z0s_pack, fx, fy) = fixtures
    s, rho, z, N, dz = (state_o["s"], state_o["rho"], state_o["z"],
                        state_o["N"], state_o["dz"])
    s = oracle.lighting_solve(rho, N, I_pack, s)
    rho = oracle.albedo_solve(N, s, I_pack, rho)
    M, rhs, A, B = oracle.depth_system(
        rho, dz, s, xx_p, yy_p, fx, fy, Dx, Dy, KT, z0s_pack, I_pack)
    b_res = rhs - M @ z
    # float32 CG: the reference's actual arithmetic (all S-routines), so
    # the oracle trajectory stalls at the same precision ours does.
    z, _ = oracle.cg(M, b_res, z, tol=1e-9, max_iter=cg_max_iter,
                     dtype=np.float32)
    z = z.astype(np.float64)
    energy = oracle.depth_energy(z, A, B, KT, z0s_pack)
    zx, zy = Dx @ z, Dy @ z
    N, dz = oracle.normals(z, zx, zy, xx_p, yy_p, fx, fy)
    return dict(s=s, rho=rho, z=z, N=N, dz=dz, energy=energy)


def _trajectory_fixture(rng):
    """Shared well-conditioned render fixture: returns
    (prob, state, fixtures, state_o, sf)."""
    h, w, sf, n, c = 24, 16, 2, 5, 3
    mask = random_mask(rng, h, w)
    fx, fy = 500.0, 505.0
    cx, cy = w / 2 - 0.5, h / 2 - 0.5
    K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]

    # Smooth synthetic depth + images derived from a Lambertian-ish render
    # so the systems are well-conditioned (unlike pure noise).
    yy2, xx2 = np.mgrid[0:h, 0:w]
    z_true = (50 + 5 * np.sin(xx2 / 4.0) + 4 * np.cos(yy2 / 5.0)).astype(np.float32)
    I = np.empty((n, c, h, w), np.float32)
    for i in range(n):
        light = rng.standard_normal(3) * 0.3 + np.array([0.1, 0.1, 0.8])
        shade = (light[0] * np.sin(xx2 / 4.0) + light[1] * np.cos(yy2 / 5.0)
                 + light[2])
        for ch in range(c):
            I[i, ch] = np.clip(0.3 * (ch + 1) * shade
                               + 0.02 * rng.standard_normal((h, w)), 0, None)
    z0s_full = z_true[::sf, ::sf] + 0.1 * rng.standard_normal(
        (h // sf, w // sf)).astype(np.float32)

    prob = srps.build_problem(I, mask, K, sf, z0s_full)
    z_init = z_true * mask
    state = srps.init_state(prob, z_init)

    # Oracle fixtures in packed column-major masked space.
    Dx, Dy, imask, _ = oracle.make_gradient(mask.T.ravel(), h, w)
    masks_o, imasks, KT = oracle.lr_mask_and_KT(mask.T.ravel(), h, w, sf)
    masks2d = np.asarray(prob.masks)
    I_pack = np.stack([
        np.stack([pack(np.asarray(prob.I[ch, i]).reshape(mask.shape), mask) for ch in range(c)])
        for i in range(n)])
    xx_p = pack(np.asarray(prob.xx), mask)
    yy_p = pack(np.asarray(prob.yy), mask)
    z0s_pack = pack(np.asarray(prob.z0s), masks2d)
    fixtures = (Dx, Dy, KT, I_pack, xx_p, yy_p, z0s_pack, fx, fy)

    state_o = dict(
        s=np.asarray(state.s, np.float64),
        rho=np.stack([pack(np.asarray(state.rho[ch]), mask) for ch in range(c)]),
        z=pack(z_init, mask).astype(np.float64),
        N=np.stack([pack(np.asarray(state.N[k]), mask) for k in range(4)]),
        dz=pack(np.asarray(state.dz), mask),
        energy=np.nan,
    )
    return prob, state, fixtures, state_o, sf, mask


def test_three_iteration_trajectory(rng):
    prob, state, fixtures, state_o, sf, mask = _trajectory_fixture(rng)
    c = int(prob.I.shape[0])

    # The depth normal matrix is ill-conditioned (cond ~1e8) and CG does
    # not converge within the reference's iteration cap, so any two f32
    # implementations (ours, the reference CUDA binary, the oracle's f32
    # CG) drift apart along the low-curvature modes, and the drift
    # compounds through the alternation. The principled split is:
    #   iteration 1: TIGHT parity on s / rho / z / energy — proves every
    #     operator and the CG plumbing match before drift can compound;
    #   iterations 2-3: stability invariants — bounded drift, energies
    #     within a few percent, both trajectories descending.
    cfg = SolverConfig()
    energies, energies_o = [], []
    for it in range(3):
        state = srps.srps_iteration(state, prob, sf, cfg)
        state_o = oracle_iteration(state_o, fixtures)
        energies.append(float(state.energy))
        energies_o.append(state_o["energy"])
        z_got = pack(np.asarray(state.z), mask)
        rmse = np.sqrt(np.mean((z_got - state_o["z"]) ** 2))
        scale = np.sqrt(np.mean(state_o["z"] ** 2))
        if it == 0:
            np.testing.assert_allclose(
                np.asarray(state.s), state_o["s"], rtol=5e-3, atol=5e-4,
                err_msg="s mismatch at iteration 1")
            rho_got = np.stack([pack(np.asarray(state.rho[ch]), mask)
                                for ch in range(c)])
            np.testing.assert_allclose(
                rho_got, state_o["rho"], rtol=2e-2, atol=2e-3,
                err_msg="rho mismatch at iteration 1")
            assert rmse / scale < 1e-2, f"iter-1 depth RMSE {rmse/scale:.2e}"
            # Calibration: perturbing the input images by 1 ulp moves this
            # energy by +-0.4% (the iter-1 CG runs its full 100-iteration
            # cap unconverged, so the f32-vs-f64 drift is chaotic); 1.5e-2
            # is ~3 sigma of that measured sensitivity.
            np.testing.assert_allclose(
                energies[0], energies_o[0], rtol=1.5e-2,
                err_msg="energy mismatch at iteration 1")
        else:
            assert rmse / scale < 0.1, (
                f"relative depth RMSE {rmse/scale:.2e} at iteration {it+1}")
            np.testing.assert_allclose(
                energies[it], energies_o[it], rtol=1e-1,
                err_msg=f"energy mismatch at iteration {it+1}")
    # Note: the total energy may legitimately rise across OUTER iterations
    # (A and B are rebuilt from the new s/rho/dz each time — that is
    # precisely why the reference stops on energy increase, SRPS.cu:299).
    # The invariant is that both implementations' trajectories track each
    # other, which the per-iteration energy comparisons above enforce.


def test_iteration1_energy_tight_small_cg_cap(rng):
    """TIGHT iteration-1 energy parity (ADVICE r2): with the CG capped at
    5 iterations both sides take exactly 5 f32 steps, so the chaotic
    unconverged-at-100 drift that forced the 1.5e-2 tolerance above cannot
    compound — the energy must then agree to ~f32 operator rounding. This
    keeps CLAUDE.md's "iteration-1 energies are a tight invariant" true
    without loosening the realistic-cap check."""
    prob, state, fixtures, state_o, sf, mask = _trajectory_fixture(rng)
    cfg = SolverConfig(cg_max_iter=5)
    state = srps.srps_iteration(state, prob, sf, cfg)
    state_o = oracle_iteration(state_o, fixtures, cg_max_iter=5)
    np.testing.assert_allclose(
        float(state.energy), state_o["energy"], rtol=2e-3,
        err_msg="tight iteration-1 energy mismatch (cg cap 5)")
    z_got = pack(np.asarray(state.z), mask)
    rmse = np.sqrt(np.mean((z_got - state_o["z"]) ** 2))
    scale = np.sqrt(np.mean(state_o["z"] ** 2))
    assert rmse / scale < 1e-4, f"iter-1 depth RMSE {rmse/scale:.2e}"


class TestConvergedRegimeRMSE:
    """The BASELINE.json north star (depth RMSE <= 1e-4), tested directly:
    on a well-conditioned fixture (small focal length -> cond(M) ~ 2e4),
    CG run to convergence must match the f64 oracle's *direct* solve of
    the reference's explicit sparse system M z = rhs. This validates that
    the matrix-free Gram-field operators compose to exactly the
    reference's matrix, not merely to a similar one."""

    def test_depth_rmse_vs_f64_direct_solve(self, rng):
        import scipy.sparse.linalg as spla
        from functools import partial
        import jax.numpy as jnp
        from srmeetsps_cuda_tpu.ops.grid import masked_select_colmajor as pack
        from srmeetsps_cuda_tpu.solve.cg import conjugate_gradient

        h, w, sf, n, c = 24, 16, 2, 4, 3
        fx = fy = 30.0
        mask = random_mask(rng, h, w)
        I = rng.random((n, c, h, w)).astype(np.float32)
        K = [[fx, 0, w / 2 - 0.5], [0, fy, h / 2 - 0.5], [0, 0, 1]]
        z0s = rng.random((h // sf, w // sf)).astype(np.float32) + 0.5
        prob = srps.build_problem(I, mask, K, sf, z0s)
        z = (rng.random((h, w)).astype(np.float32) + 0.5) * np.asarray(prob.mask)
        st = srps.init_state(prob, z)
        s = (np.array([0, 0, -1, 0.2])
             + 0.1 * rng.standard_normal((n, c, 4))).astype(np.float32)
        mom = srps.s_moments(prob, jnp.asarray(s))
        rho = np.asarray(st.rho)
        lam = 1.0
        op = srps.build_depth_operator(prob, mom, jnp.asarray(rho), st.dz, lam)

        # f64 oracle: explicit sparse system + direct solve.
        m = np.asarray(prob.mask)
        Dx, Dy, _, _ = oracle.make_gradient(m.T.ravel(), h, w)
        _, _, KT = oracle.lr_mask_and_KT(m.T.ravel(), h, w, sf)
        I_pack = np.stack([
            np.stack([pack(np.asarray(prob.I[cc, i]).reshape(m.shape), m) for cc in range(c)])
            for i in range(n)])
        rho_p = np.stack([pack(rho[cc], m) for cc in range(c)])
        M, rhs_o, _, _ = oracle.depth_system(
            rho_p.astype(np.float64), pack(np.asarray(st.dz), m).astype(np.float64),
            s.astype(np.float64), pack(np.asarray(prob.xx), m),
            pack(np.asarray(prob.yy), m), fx, fy, Dx, Dy, KT,
            pack(np.asarray(prob.z0s), np.asarray(prob.masks)).astype(np.float64),
            I_pack.astype(np.float64), lam)
        cond = np.linalg.cond(M.toarray())
        assert cond < 1e5, f"fixture not well-conditioned: {cond:.2e}"
        x_star = spla.spsolve(M.tocsc(), rhs_o)

        # Framework: matrix-free warm-started CG run to convergence.
        matvec = partial(srps.depth_matvec, op=op, prob=prob, sf=sf, lam=lam)
        rhs = srps.depth_rhs(op, prob, sf, lam)
        diag = srps.depth_diag(op, prob, sf, lam)
        res = conjugate_gradient(matvec, rhs - matvec(st.z), st.z,
                                 tol=0.0, max_iter=1500,
                                 precond=lambda r: r / diag)
        z_pack = pack(np.asarray(res.x), m)
        rmse = float(np.sqrt(np.mean((z_pack - x_star) ** 2)))
        assert rmse <= 1e-4, rmse
        # In practice f32 converges ~100x below the north-star bound here.
        assert rmse <= 5e-6, rmse
