"""Manual shard_map halo-exchange CG parity vs the single-device path."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from conftest import random_mask
from srmeetsps_cuda_tpu.config import SolverConfig
from srmeetsps_cuda_tpu.models import srps
from srmeetsps_cuda_tpu.parallel import shard_cg
from srmeetsps_cuda_tpu.solve.cg import conjugate_gradient


def _setup(rng, h=64, w=32, sf=2, n=3, c=3):
    mask = random_mask(rng, h, w)
    I = rng.random((n, c, h, w)).astype(np.float32)
    K = [[300.0, 0, w / 2 - 0.5], [0, 300.0, h / 2 - 0.5], [0, 0, 1]]
    z0s = (rng.random((h // sf, w // sf)).astype(np.float32) + 0.5)
    prob = srps.build_problem(I, mask, K, sf, z0s)
    z = (rng.random((h, w)).astype(np.float32) + 0.5) * mask
    st = srps.init_state(prob, z)
    mom = srps.s_moments(prob, st.s)
    op = srps.build_depth_operator(prob, mom, st.rho, st.dz, 1.0)
    return prob, st, op


class TestShardCG:
    def test_matvec_band_matches_reference(self, rng):
        """shard_map matvec over 8 row bands == single-device matvec."""
        h, w, sf = 64, 32, 2
        prob, st, op = _setup(rng, h, w, sf)
        v = rng.standard_normal((h, w)).astype(np.float32) * np.asarray(prob.mask)
        want = np.asarray(srps.depth_matvec(jnp.asarray(v), op, prob, sf, 1.0))

        mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
        from jax import shard_map
        import functools

        def body(v_l, P11, P12, P13, P22, P23, P33, fx, bx, fy, by,
                 mask_l, masks_l):
            F = jnp.stack([P11, P12, P13, P22, P23, P33, fx, bx, fy, by])
            Fm = jnp.moveaxis(F, 0, 1)
            topF, botF = shard_cg._halo_rows(
                Fm.reshape(Fm.shape[0], -1), 1, "x")
            Fm_ext = jnp.concatenate(
                [topF.reshape(1, *Fm.shape[1:]), Fm,
                 botF.reshape(1, *Fm.shape[1:])], 0)
            F_ext = jnp.moveaxis(Fm_ext, 1, 0)
            names = ["P11", "P12", "P13", "P22", "P23", "P33",
                     "fwd_x", "bwd_x", "fwd_y", "bwd_y"]
            Fx = {k: F_ext[i] for i, k in enumerate(names)}
            return shard_cg.matvec_band(v_l, Fx, "x", sf, 1.0,
                                        masks_l, mask_l)

        spec = P("x", None)
        fn = shard_map(body, mesh=mesh, in_specs=(spec,) * 13,
                       out_specs=spec, check_vma=False)
        got = np.asarray(fn(
            jnp.asarray(v), op.P11, op.P12, op.P13, op.P22, op.P23, op.P33,
            prob.gm.fwd_x, prob.gm.bwd_x, prob.gm.fwd_y, prob.gm.bwd_y,
            prob.mask, prob.masks))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    def test_full_cg_matches_single_device(self, rng):
        h, w, sf = 64, 32, 2
        prob, st, op = _setup(rng, h, w, sf)
        import functools

        mv = functools.partial(srps.depth_matvec, op=op, prob=prob,
                               sf=sf, lam=1.0)
        rhs = srps.depth_rhs(op, prob, sf, 1.0)
        b_res = rhs - mv(st.z)
        r0 = float(jnp.vdot(b_res, b_res))
        ref = conjugate_gradient(mv, b_res, st.z, tol=1e-4, max_iter=30)

        mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
        x, k, r1 = shard_cg.cg_sharded(
            mesh, "x", st.z, b_res, op, prob.gm, prob.mask, prob.masks,
            sf=sf, lam=1.0, tol=1e-4, max_iter=30)
        assert abs(int(k) - int(ref.iterations)) <= 2
        # The instantaneous ||r||^2 at an unconverged cap is NOT an
        # invariant (it fluctuates across reassociations while the error
        # decreases smoothly); assert comparable *progress* instead:
        # both runs must have cut r^2 by >=5x, within 10x of each other.
        assert float(r1) <= 0.2 * r0
        assert float(ref.residual_sq) <= 0.2 * r0
        ratio = float(r1) / float(ref.residual_sq)
        assert 0.1 < ratio < 10.0
        d = np.asarray(x) - np.asarray(ref.x)
        rms = np.sqrt(np.mean(np.asarray(ref.x) ** 2))
        assert np.sqrt(np.mean(d**2)) / rms < 5e-2


class TestShardJacobi:
    """Jacobi-preconditioned sharded CG (``--sharded N --jacobi``) must
    follow the single-device preconditioned solve.cg trajectory."""

    def test_jacobi_short_horizon_matches_single_device(self, rng):
        """5 PCG iterations: same recurrence as solve.cg's preconditioned
        variant, so before f32 drift compounds the iterates must agree
        tightly."""
        h, w, sf = 64, 32, 2
        prob, st, op = _setup(rng, h, w, sf)
        import functools

        mv = functools.partial(srps.depth_matvec, op=op, prob=prob,
                               sf=sf, lam=1.0)
        rhs = srps.depth_rhs(op, prob, sf, 1.0)
        b_res = rhs - mv(st.z)
        invd = 1.0 / srps.depth_diag(op, prob, sf, 1.0)
        ref = conjugate_gradient(mv, b_res, st.z, tol=1e-30, max_iter=5,
                                 precond=lambda r: invd * r)

        mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
        x, k, rr = shard_cg.cg_sharded_jacobi(
            mesh, "x", st.z, b_res, invd, op, prob.gm, prob.mask,
            prob.masks, sf=sf, lam=1.0, tol=1e-30, max_iter=5)
        assert int(k) == int(ref.iterations)
        d = np.asarray(x) - np.asarray(ref.x)
        rms = np.sqrt(np.mean(np.asarray(ref.x) ** 2))
        assert np.sqrt(np.mean(d ** 2)) / rms < 1e-4

    def test_jacobi_fused_solve_matches_single_chip(self, rng):
        """Full fused sharded solve with the --fast preset config vs the
        single-chip jacobi solve: same iteration count, energies tracking
        to f32 reduction-order tolerance."""
        from functools import partial

        from srmeetsps_cuda_tpu.parallel import sharded

        h, w, sf = 64, 32, 2
        prob, st, _ = _setup(rng, h, w, sf)
        cfg = SolverConfig(max_iterations=3, jacobi_preconditioner=True,
                           cg_max_iter=30)
        final_s, trace_s = jax.jit(
            srps.solve_fused, static_argnums=(2, 3))(st, prob, sf, cfg)
        mesh = sharded.make_mesh_1d(8)
        pb1 = sharded.shard_pytree_rows(prob, mesh)
        st1 = sharded.shard_pytree_rows(st, mesh)
        out, trace = jax.jit(partial(
            sharded.solve_fused_sharded, sf=sf, cfg=cfg, mesh=mesh))(
            st1, pb1)
        assert int(out.iteration) == int(final_s.iteration)
        n_it = int(final_s.iteration)
        np.testing.assert_allclose(np.asarray(trace)[:n_it],
                                   np.asarray(trace_s)[:n_it], rtol=1e-3)


class TestShardCGSingleReduction:
    def test_cgs_matches_standard(self, rng):
        """Chronopoulos-Gear sharded CG (one fused psum pair per iteration)
        vs the standard two-psum sharded CG: same iteration count, same
        progress, bounded iterate drift (the alpha recurrence reorders
        rounding)."""
        h, w, sf = 64, 32, 2
        prob, st, op = _setup(rng, h, w, sf)
        import functools

        mv = functools.partial(srps.depth_matvec, op=op, prob=prob,
                               sf=sf, lam=1.0)
        rhs = srps.depth_rhs(op, prob, sf, 1.0)
        b_res = rhs - mv(st.z)
        r0 = float(jnp.vdot(b_res, b_res))

        mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
        x_s, k_s, r_s = shard_cg.cg_sharded(
            mesh, "x", st.z, b_res, op, prob.gm, prob.mask, prob.masks,
            sf=sf, lam=1.0, tol=1e-4, max_iter=30)
        x_c, k_c, r_c = shard_cg.cg_sharded_cgs(
            mesh, "x", st.z, b_res, op, prob.gm, prob.mask, prob.masks,
            sf=sf, lam=1.0, tol=1e-4, max_iter=30)
        assert abs(int(k_s) - int(k_c)) <= 2
        assert float(r_c) <= 0.2 * r0
        ratio = float(r_c) / float(r_s)
        assert 0.1 < ratio < 10.0
        # At-cap iterate is not an invariant on this unconverged
        # ill-conditioned system; correctness is the exact 2-iteration
        # test below — here only bound the ballpark.
        d = np.asarray(x_c) - np.asarray(x_s)
        rms = np.sqrt(np.mean(np.asarray(x_s) ** 2))
        assert np.sqrt(np.mean(d ** 2)) / rms < 2e-1

    @pytest.mark.slow
    def test_cgs_exact_at_short_horizon(self, rng):
        """At 2 iterations the CGS recurrence is algebraically identical to
        standard CG — parity is tight before rounding drift compounds."""
        h, w, sf = 64, 32, 2
        prob, st, op = _setup(rng, h, w, sf)
        import functools

        mv = functools.partial(srps.depth_matvec, op=op, prob=prob,
                               sf=sf, lam=1.0)
        rhs = srps.depth_rhs(op, prob, sf, 1.0)
        b_res = rhs - mv(st.z)
        mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
        x_s, _, _ = shard_cg.cg_sharded(
            mesh, "x", st.z, b_res, op, prob.gm, prob.mask, prob.masks,
            sf=sf, lam=1.0, tol=1e-4, max_iter=2)
        x_c, _, _ = shard_cg.cg_sharded_cgs(
            mesh, "x", st.z, b_res, op, prob.gm, prob.mask, prob.masks,
            sf=sf, lam=1.0, tol=1e-4, max_iter=2)
        np.testing.assert_allclose(np.asarray(x_c), np.asarray(x_s),
                                   rtol=1e-4, atol=1e-4)


class TestShardedIteration:
    def test_iteration_sharded_matches_single_device(self, rng):
        """The product path: srps_iteration_sharded (manual halo CG) vs
        the plain single-device iteration."""
        from srmeetsps_cuda_tpu.parallel.sharded import (
            make_mesh_1d, shard_pytree_rows, srps_iteration_sharded)

        h, w, sf = 64, 32, 2
        prob, st, _ = _setup(rng, h, w, sf)
        cfg = SolverConfig(cg_max_iter=30)
        want = srps.srps_iteration(st, prob, sf, cfg)

        mesh = make_mesh_1d(8)
        prob_s = shard_pytree_rows(prob, mesh)
        st_s = shard_pytree_rows(st, mesh)
        import functools
        got = jax.jit(functools.partial(
            srps_iteration_sharded, sf=sf, cfg=cfg, mesh=mesh))(st_s, prob_s)
        np.testing.assert_allclose(float(got.energy), float(want.energy),
                                   rtol=1e-2)
        assert abs(int(got.cg_iters) - int(want.cg_iters)) <= 2
        d = np.asarray(got.z) - np.asarray(want.z)
        rms = np.sqrt(np.mean(np.asarray(want.z) ** 2))
        assert np.sqrt(np.mean(d ** 2)) / rms < 5e-2

    def test_solve_fused_sharded_runs(self, rng):
        from srmeetsps_cuda_tpu.parallel.sharded import (
            make_mesh_1d, shard_pytree_rows, solve_fused_sharded)

        h, w, sf = 64, 32, 2
        prob, st, _ = _setup(rng, h, w, sf)
        cfg = SolverConfig(max_iterations=3, cg_max_iter=20)
        mesh = make_mesh_1d(8)
        prob_s = shard_pytree_rows(prob, mesh)
        st_s = shard_pytree_rows(st, mesh)
        import functools
        final, trace = jax.jit(functools.partial(
            solve_fused_sharded, sf=sf, cfg=cfg, mesh=mesh))(st_s, prob_s)
        assert np.isfinite(float(final.energy))
        trace = np.asarray(trace)
        n_it = int(final.iteration)
        assert n_it >= 1 and np.all(np.isfinite(trace[:n_it]))


class TestShardCGMeshSizes:
    """Each sharded CG recurrence against its single-device counterpart on
    2-, 4- and 8-device row meshes, at a horizon short enough that f32
    reduction order has not yet compounded."""

    @pytest.mark.parametrize("variant", ["std", "cgs", "jacobi"])
    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_matches_single_device(self, rng, n_dev, variant):
        import functools

        h, w, sf = 64, 32, 2
        prob, st, op = _setup(rng, h, w, sf)
        mv = functools.partial(srps.depth_matvec, op=op, prob=prob, sf=sf,
                               lam=1.0)
        b_res = srps.depth_rhs(op, prob, sf, 1.0) - mv(st.z)
        invd = 1.0 / srps.depth_diag(op, prob, sf, 1.0)
        # Plain CG on this random system is the most sensitive to
        # reduction order (and CGS reassociates it further): 2 iterations
        # keep both within the tight tolerance; Jacobi PCG holds for 5.
        cap = 5 if variant == "jacobi" else 2
        ref = conjugate_gradient(
            mv, b_res, st.z, tol=1e-30, max_iter=cap,
            precond=(lambda r: invd * r) if variant == "jacobi" else None)
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
        kw = dict(sf=sf, lam=1.0, tol=1e-30, max_iter=cap)
        if variant == "jacobi":
            x, k, _ = shard_cg.cg_sharded_jacobi(
                mesh, "x", st.z, b_res, invd, op, prob.gm, prob.mask,
                prob.masks, **kw)
        else:
            fn = (shard_cg.cg_sharded_cgs if variant == "cgs"
                  else shard_cg.cg_sharded)
            x, k, _ = fn(mesh, "x", st.z, b_res, op, prob.gm, prob.mask,
                         prob.masks, **kw)
        assert int(k) == int(ref.iterations) == cap + 1
        d = np.asarray(x) - np.asarray(ref.x)
        rms = np.sqrt(np.mean(np.asarray(ref.x) ** 2))
        assert np.sqrt(np.mean(d ** 2)) / rms < 1e-4
