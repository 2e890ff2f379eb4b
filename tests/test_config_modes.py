"""Config-mode coverage: bf16 images, Jacobi preconditioning, CLI parse."""

import numpy as np
import jax.numpy as jnp

from conftest import random_mask
from srmeetsps_cuda_tpu.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu.models import srps


def _data(rng, h=32, w=32, sf=2, n=3, c=3):
    mask = random_mask(rng, h, w)
    I = rng.random((n, c, h, w)).astype(np.float32)
    K = [[300.0, 0, w / 2 - 0.5], [0, 300.0, h / 2 - 0.5], [0, 0, 1]]
    z0s = (rng.random((h // sf, w // sf)).astype(np.float32) + 0.5)
    z = (rng.random((h, w)).astype(np.float32) + 0.5) * mask
    return I, mask, K, sf, z0s, z


class TestBF16Images:
    def test_close_to_f32(self, rng):
        I, mask, K, sf, z0s, z = _data(rng)
        cfg = SolverConfig()
        p32 = srps.build_problem(I, mask, K, sf, z0s)
        p16 = srps.build_problem(I, mask, K, sf, z0s, image_dtype="bfloat16")
        assert p16.I.dtype == jnp.bfloat16
        s32 = srps.init_state(p32, z)
        s16 = srps.init_state(p16, z)
        st32 = srps.srps_iteration(s32, p32, sf, cfg)
        st16 = srps.srps_iteration(s16, p16, sf, cfg)
        # bf16 images perturb the data term by ~2^-8 relative.
        np.testing.assert_allclose(np.asarray(st16.s), np.asarray(st32.s),
                                   rtol=3e-2, atol=3e-3)
        np.testing.assert_allclose(float(st16.energy), float(st32.energy),
                                   rtol=3e-2)


class TestJacobi:
    def test_reaches_lower_residual(self, rng):
        I, mask, K, sf, z0s, z = _data(rng, h=48, w=48)
        prob = srps.build_problem(I, mask, K, sf, z0s)
        st = srps.init_state(prob, z)
        mom = srps.s_moments(prob, st.s)
        cfg_p = SolverConfig(jacobi_preconditioner=True, cg_max_iter=50,
                             cg_tol=1e-6)
        cfg_n = SolverConfig(cg_max_iter=50, cg_tol=1e-6)
        z_p, e_p, k_p = srps.estimate_depth(prob, mom, st.rho, st.dz, st.z,
                                            sf, cfg_p)
        z_n, e_n, k_n = srps.estimate_depth(prob, mom, st.rho, st.dz, st.z,
                                            sf, cfg_n)
        # Preconditioned CG should reach at least as low an energy within
        # the same iteration budget.
        assert float(e_p) <= float(e_n) * 1.01, (float(e_p), float(e_n))


class TestCLIParse:
    def test_reference_flags(self):
        from srmeetsps_cuda_tpu.cli import build_parser

        p = build_parser()
        a = p.parse_args(["-t", "images", "-d", "/x", "-g", "1",
                          "-x", "128", "-y", "8"])
        assert a.dstype == "images" and a.dsloc == "/x"
        assert a.device == 1 and a.blockx == 128 and a.blocky == 8

    def test_solver_flags(self):
        from srmeetsps_cuda_tpu.cli import build_parser

        p = build_parser()
        a = p.parse_args(["--dsloc", "/x", "--lambda", "2.5", "--jacobi",
                          "--fused", "--nan-check"])
        assert a.lam == 2.5 and a.jacobi and a.fused
        assert a.nan_check
