"""Batched (vmap) and grid-sharded (GSPMD mesh) solve tests.

Runs on the forced 8-device CPU mesh from conftest.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from conftest import random_mask
from srmeetsps_cuda_tpu.config import SolverConfig
from srmeetsps_cuda_tpu.models import srps
from srmeetsps_cuda_tpu.parallel import batched, sharded


def make_problem(rng, h=32, w=32, sf=2, n=3, c=3, seed_shift=0.0):
    mask = random_mask(rng, h, w)
    I = rng.random((n, c, h, w)).astype(np.float32)
    z = (rng.random((h, w)).astype(np.float32) + 0.5 + seed_shift) * mask
    K = [[300.0, 0, w / 2 - 0.5], [0, 300.0, h / 2 - 0.5], [0, 0, 1]]
    z0s = (rng.random((h // sf, w // sf)).astype(np.float32) + 0.5)
    prob = srps.build_problem(I, mask, K, sf, z0s)
    state = srps.init_state(prob, z)
    return prob, state


class TestBatched:
    def test_matches_solo_trajectories(self, rng):
        cfg = SolverConfig(max_iterations=3)
        sf = 2
        probs, states = [], []
        for b in range(3):
            pb, st = make_problem(rng, seed_shift=0.1 * b)
            probs.append(pb)
            states.append(st)
        prob_b = batched.stack_problems(probs)
        state_b = batched.stack_states(states)
        final_b, trace_b = batched.solve_batched(state_b, prob_b, sf, cfg)
        trace_b = np.asarray(trace_b)
        for b in range(3):
            final_s, trace_s = srps.solve_fused(states[b], probs[b], sf, cfg)
            n_it = int(final_s.iteration)
            assert n_it >= 1
            # vmap reorders reductions => f32 rounding differs; with the
            # ill-conditioned unconverged CG the z iterates drift along
            # low-curvature modes, but energies (the observable the
            # stopping rule uses) must track. Iteration counts may flip by
            # one when a lane sits exactly on the rel-tol boundary.
            lane_valid = int(np.isfinite(trace_b[b]).sum())
            assert abs(lane_valid - n_it) <= 1, (lane_valid, n_it)
            m = min(lane_valid, n_it)
            np.testing.assert_allclose(
                trace_b[b, :m], np.asarray(trace_s)[:m], rtol=1e-2)


class TestBatchedStreaming:
    """solve_batched_streaming = B async dispatches of the SAME jitted
    fused-solve program a solo run uses, so each lane must be
    bit-identical to its solo solve (the lockstep test above only gets
    rtol=1e-2 because vmap reorders reductions)."""

    def test_streaming_matches_solo_bitexact(self, rng):
        from srmeetsps_cuda_tpu.runtime.solver import _jit_solve_fused

        cfg = SolverConfig(max_iterations=3)
        sf = 2
        probs, states = [], []
        for b in range(3):
            pb, st = make_problem(rng, seed_shift=0.1 * b)
            probs.append(pb)
            states.append(st)
        finals, traces = batched.solve_batched_streaming(
            states, probs, sf, cfg)
        # Stacked input form: one jitted unstack, same results.
        finals2, traces2 = batched.solve_batched_streaming(
            batched.stack_states(states), batched.stack_problems(probs),
            sf, cfg)
        for b in range(3):
            final_s, trace_s = _jit_solve_fused(states[b], probs[b], sf, cfg)
            assert int(np.asarray(finals[b].iteration)) == int(
                final_s.iteration)
            np.testing.assert_array_equal(np.asarray(finals[b].z),
                                          np.asarray(final_s.z))
            np.testing.assert_array_equal(np.asarray(traces[b]),
                                          np.asarray(trace_s))
            np.testing.assert_array_equal(np.asarray(finals2[b].z),
                                          np.asarray(final_s.z))
            np.testing.assert_array_equal(np.asarray(traces2[b]),
                                          np.asarray(trace_s))

    def test_solve_batch_routing(self, rng):
        cfg = SolverConfig(max_iterations=2)
        sf = 2
        pairs = [make_problem(rng, seed_shift=0.1 * b) for b in range(2)]
        probs = [p for p, _ in pairs]
        states = [s for _, s in pairs]
        f_st, t_st = batched.solve_batch(states, probs, sf, cfg,
                                         mode="stream")
        f_lk, t_lk = batched.solve_batch(states, probs, sf, cfg,
                                         mode="lockstep")
        # Same trajectories up to reduction order (see lockstep test).
        for b in range(2):
            n = min(int(np.isfinite(np.asarray(t_st[b])).sum()),
                    int(np.isfinite(np.asarray(t_lk[b])).sum()))
            np.testing.assert_allclose(np.asarray(t_st[b])[:n],
                                       np.asarray(t_lk[b])[:n], rtol=1e-2)
        # "auto" = stream, also with several devices visible (the
        # 8-device CPU test mesh).
        assert batched.resolve_batch_mode("auto") == "stream"
        f_a, t_a = batched.solve_batch(states, probs, sf, cfg, mode="auto")
        for b in range(2):
            np.testing.assert_array_equal(np.asarray(t_a[b]),
                                          np.asarray(t_st[b]))
        with pytest.raises(ValueError):
            batched.solve_batch(states, probs, sf, cfg, mode="bogus")


class TestSharded:
    def test_mesh_construction(self):
        mesh = sharded.make_mesh(8, data=2)
        assert mesh.shape["data"] == 2
        assert mesh.shape["x"] * mesh.shape["y"] == 4

    def test_sharded_step_matches_single_device(self, rng):
        cfg = SolverConfig(max_iterations=2)
        sf = 2
        # Shapes divisible by mesh tiles * sf.
        pb, st = make_problem(rng, h=32, w=32)
        ref = srps.srps_iteration(st, pb, sf, cfg)

        mesh = sharded.make_mesh(8, data=1)  # spatial 8-way
        pb_s = sharded.shard_pytree(pb, mesh)
        st_s = sharded.shard_pytree(st, mesh)
        out = sharded.step_sharded(st_s, pb_s, sf, cfg)
        np.testing.assert_allclose(float(out.energy), float(ref.energy),
                                   rtol=1e-2)
        # GSPMD reduction orders differ from single-device; the unconverged
        # CG iterate drifts pointwise along low-curvature modes, so bound
        # the relative RMS drift rather than per-element closeness.
        d = np.asarray(out.z) - np.asarray(ref.z)
        rms = np.sqrt(np.mean(np.asarray(ref.z) ** 2))
        assert np.sqrt(np.mean(d ** 2)) / rms < 2e-2

    def test_sharded_fused_solve(self, rng):
        cfg = SolverConfig(max_iterations=2)
        sf = 2
        pb, st = make_problem(rng, h=32, w=64)
        mesh = sharded.make_mesh(8, data=1)
        pb_s = sharded.shard_pytree(pb, mesh)
        st_s = sharded.shard_pytree(st, mesh)
        final, trace = sharded.solve_sharded(st_s, pb_s, sf, cfg, mesh)
        ref_final, ref_trace = srps.solve_fused(st, pb, sf, cfg)
        assert int(final.iteration) == int(ref_final.iteration)
        n_it = int(final.iteration)
        np.testing.assert_allclose(np.asarray(trace)[:n_it],
                                   np.asarray(ref_trace)[:n_it], rtol=1e-2)

    def test_dryrun_entrypoint(self):
        sharded.dryrun(8)


class TestGraftEntry:
    def test_entry_compiles(self):
        import sys, os
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        from __graft_entry__ import entry

        fn, args = entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out.z)
        assert np.isfinite(float(out.energy))


class TestMixedGeometryPadding:
    def test_padded_solve_matches_native(self, rng):
        """prepare(pad_to=...) zero-pads outside the mask AFTER
        preprocessing, so the solver trajectory must match the native-grid
        solve (masked-exact operators; only reduction order differs)."""
        import jax.numpy as jnp

        from conftest import random_mask
        from srmeetsps_cuda_tpu.config import SolverConfig
        from srmeetsps_cuda_tpu.io.image_loader import ProblemData
        from srmeetsps_cuda_tpu.models import srps
        from srmeetsps_cuda_tpu.runtime.solver import prepare

        h, w, sf, n, c = 24, 16, 2, 3, 3
        mask = random_mask(rng, h, w)
        I = rng.random((n, c, h, w)).astype(np.float32)
        K = np.array([[200.0, 0, w / 2 - 0.5], [0, 200.0, h / 2 - 0.5],
                      [0, 0, 1]], np.float32)
        z0 = np.stack([
            (rng.random((h // sf, w // sf)) + 1.0).astype(np.float32) * 50
            for _ in range(n)])
        data = ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0)
        cfg = SolverConfig(inpaint_iters=32, cg_max_iter=10,
                           max_iterations=2)
        prob_a, st_a = prepare(data, cfg)
        prob_b, st_b = prepare(data, cfg, pad_to=(40, 32))
        fa, tra = srps.solve_fused(st_a, prob_a, sf, cfg)
        fb, trb = srps.solve_fused(st_b, prob_b, sf, cfg)
        assert int(fa.iteration) == int(fb.iteration)
        np.testing.assert_allclose(np.asarray(trb)[:int(fa.iteration)],
                                   np.asarray(tra)[:int(fa.iteration)],
                                   rtol=1e-4)
        np.testing.assert_allclose(np.asarray(fb.z)[:h, :w],
                                   np.asarray(fa.z), rtol=1e-3, atol=1e-3)
        assert float(np.abs(np.asarray(fb.z)[h:]).max()) == 0.0


class TestBatchRoutes:
    """The three ways to solve a batch agree: lockstep (one vmapped
    program), stream (the solo program per lane) and solo solves; stream
    lanes are bit-identical to solo."""

    @pytest.mark.parametrize("geometry", ["same", "mixed"])
    @pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
    @pytest.mark.parametrize("sf", [2, 4])
    def test_lockstep_stream_solo_agree(self, rng, sf, jacobi, geometry):
        from srmeetsps_cuda_tpu.io.image_loader import ProblemData
        from srmeetsps_cuda_tpu.runtime.solver import _jit_solve_fused, prepare

        cfg = SolverConfig(max_iterations=2, cg_max_iter=10, inpaint_iters=8,
                           jacobi_preconditioner=jacobi)
        sizes = [(24, 16), (24, 16) if geometry == "same" else (32, 24)]
        pad_to = None if geometry == "same" else (32, 24)
        probs, states = [], []
        for h, w in sizes:
            K = np.array([[200.0, 0, w / 2 - 0.5], [0, 200.0, h / 2 - 0.5],
                          [0, 0, 1]], np.float32)
            z0 = ((rng.random((3, h // sf, w // sf)) + 1.0) * 50).astype(
                np.float32)
            data = ProblemData(I=rng.random((3, 3, h, w)).astype(np.float32),
                               K=K, mask=random_mask(rng, h, w), sf=sf, z0=z0)
            pb, st = prepare(data, cfg, pad_to=pad_to)
            probs.append(pb)
            states.append(st)
        f_st, t_st = batched.solve_batch(states, probs, sf, cfg, mode="stream")
        f_lk, t_lk = batched.solve_batch(states, probs, sf, cfg,
                                         mode="lockstep")
        for b in range(2):
            f_solo, t_solo = _jit_solve_fused(states[b], probs[b], sf, cfg)
            np.testing.assert_array_equal(np.asarray(t_st[b]),
                                          np.asarray(t_solo))
            np.testing.assert_array_equal(np.asarray(f_st[b].z),
                                          np.asarray(f_solo.z))
            n = int(f_solo.iteration)
            assert int(np.isfinite(np.asarray(t_lk[b])).sum()) == n
            np.testing.assert_allclose(np.asarray(t_lk[b])[:n],
                                       np.asarray(t_solo)[:n], rtol=1e-2)
