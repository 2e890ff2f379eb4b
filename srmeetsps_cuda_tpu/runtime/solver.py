"""Outer-loop driver: alternation, stopping rule, metrics, dumps, resume.

Mirrors the control flow of ``SRPS::execute`` (SRPS.cu:84-370) with two
execution modes:

* **stepwise** (default): one jitted outer iteration per Python step —
  reference-equivalent behaviour with per-iteration timings, energy,
  relative error, and optional MAT/npz dumps + PNG snapshots.
* **fused**: the entire solve inside one on-device ``lax.while_loop``
  (zero host round-trips; the energy trace comes back at the end). Used
  by the benchmark path.
"""

from __future__ import annotations

import json
import os
import time
from functools import partial
from typing import Optional

import jax
import numpy as np

from ..config import RuntimeConfig, SolverConfig
from ..io import writers
from ..io.image_loader import ProblemData
from ..models import srps
from ..pre import preprocess_depth


class Timer:
    """Wall-clock phase timer mirroring the reference Timer (Utilities.h:
    194-222): ``end`` blocks on device completion before reading the clock."""

    def __init__(self):
        self.t0 = 0.0
        self.elapsed = 0.0

    def start(self):
        self.t0 = time.perf_counter()
        return self

    def end(self, *block_on):
        jax.block_until_ready(block_on)
        self.elapsed = time.perf_counter() - self.t0
        return self.elapsed


def prepare(data: ProblemData, cfg: SolverConfig = SolverConfig(),
            return_zs: bool = False, pad_to=None):
    """Device-side setup: preprocessing + problem/state construction
    (SRPS.cu:100-270).

    ``pad_to=(H, W)``: zero-pad to a common grid AFTER the native-size
    preprocessing (mixed-geometry batching: different-sized objects share
    one lane-batched launch). Padding happens post-preprocess so the
    smoothing/inpainting chain never sees the pad, and all padded pixels
    are outside the mask — the masked-exact operators make the solver
    trajectory identical to the solo solve up to reduction order."""
    import jax.numpy as jnp

    h, w = data.mask.shape
    zs, z_init = preprocess_depth(data.z0, h, w, cfg)
    mask, I = data.mask, data.I
    if pad_to is not None:
        H, W = pad_to
        sf = int(data.sf)
        if H % sf or W % sf or H < h or W < w:
            raise ValueError(f"bad pad_to {pad_to} for ({h},{w}), sf={sf}")
        ph, pw = H - h, W - w
        mask = jnp.pad(jnp.asarray(mask), ((0, ph), (0, pw)))
        I = jnp.pad(jnp.asarray(I), ((0, 0), (0, 0), (0, ph), (0, pw)))
        zs = jnp.pad(jnp.asarray(zs), ((0, ph // sf), (0, pw // sf)))
        z_init = jnp.pad(jnp.asarray(z_init), ((0, ph), (0, pw)))
    # build_problem masks z0s with the LR mask itself (SRPS.cu:236-239)
    # and precomputes the z0s-derived invariants (z0t = KT^T z0s) — pass
    # the real zs; a later _replace(z0s=...) would leave z0t stale.
    prob = srps.build_problem(I, mask, data.K, data.sf, zs,
                              image_dtype=cfg.image_dtype)
    state = srps.init_state(prob, z_init)
    if return_zs:
        # zs is the *unmasked* smoothed LR grid — what the reference dumps
        # as zs_init.mat (SRPS.cu:143) before the masked gather.
        return prob, state, zs
    return prob, state


@partial(jax.jit, static_argnames=("sf", "cfg"))
def _jit_iteration(state, prob, sf, cfg):
    return srps.srps_iteration(state, prob, sf, cfg)


# Per-phase jitted calls for the stepwise mode: the reference times and
# prints lighting / albedo / depth separately each iteration
# (SRPS.cu:277-295); three XLA programs reproduce that observability.
@jax.jit
def _jit_phase_lighting(state, prob):
    return srps.estimate_lighting(prob, state.rho, state.N, state.s)


@jax.jit
def _jit_phase_albedo(s, state, prob):
    mom = srps.s_moments(prob, s)
    rho = srps.estimate_albedo(prob, mom, state.N, state.rho)
    return mom, rho


@partial(jax.jit, static_argnames=("sf", "cfg"))
def _jit_phase_depth(mom, rho, state, prob, sf, cfg):
    return srps.estimate_depth(prob, mom, rho, state.dz, state.z, sf, cfg)


@jax.jit
def _jit_phase_normals(z, prob):
    from ..ops import gradients as gradops
    from ..ops.normals import normals_from_depth

    zx = gradops.grad_x(z, prob.gm)
    zy = gradops.grad_y(z, prob.gm)
    return normals_from_depth(z, zx, zy, prob.xx, prob.yy, prob.mask,
                              prob.fx, prob.fy)


@partial(jax.jit, static_argnames=("sf", "cfg"))
def _jit_solve_fused(state, prob, sf, cfg):
    return srps.solve_fused(state, prob, sf, cfg)


@partial(jax.jit, static_argnames=("sf", "cfg"))
def _jit_solve_fused_traced(state, prob, sf, cfg):
    return srps.solve_fused_traced(state, prob, sf, cfg)


def solve(
    data: ProblemData,
    cfg: SolverConfig = SolverConfig(),
    rt: RuntimeConfig = RuntimeConfig(),
    verbose: bool = True,
):
    """End-to-end solve. Returns (final_state, metrics: list of dicts)."""
    if rt.nan_check:
        jax.config.update("jax_debug_nans", True)
    profiler_cm = None
    if rt.profile_dir:
        profiler_cm = jax.profiler.trace(rt.profile_dir)
        profiler_cm.__enter__()
    try:
        return _solve_inner(data, cfg, rt, verbose)
    finally:
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
        if rt.nan_check:
            jax.config.update("jax_debug_nans", False)


def _solve_inner(data, cfg, rt, verbose):
    prob, state, zs = prepare(data, cfg, return_zs=True)
    sf = int(data.sf)

    if rt.dump_iterations and rt.dump_format in ("mat", "mat5"):
        # Preprocessing goldens (SRPS.cu:143, 250).
        writers.dump_preprocessing(rt.dump_dir, np.asarray(zs),
                                   np.asarray(state.z), np.asarray(prob.mask),
                                   fmt=rt.dump_format)
    if rt.dump_operators:
        from ..io.sparse_dump import dump_operators

        dump_operators(rt.dump_dir, prob, sf)

    if rt.resume_from:
        ck = writers.load_checkpoint(rt.resume_from)
        state = srps.SRPSState(
            z=jax.numpy.asarray(ck["z"]),
            rho=jax.numpy.asarray(ck["rho"]),
            s=jax.numpy.asarray(ck["s"]),
            N=jax.numpy.asarray(ck["N"]),
            dz=jax.numpy.asarray(ck["dz"]),
            energy=jax.numpy.asarray(ck["energy"]),
            last_energy=jax.numpy.asarray(ck["last_energy"]),
            iteration=jax.numpy.asarray(int(ck["iteration"]), jax.numpy.int32),
            cg_iters=jax.numpy.asarray(0, jax.numpy.int32),
        )

    metrics = []

    if rt.save_visualizations:
        # Reference parity: the initialization-time normals are kept and
        # shown alongside every iteration ("Normals-Initial",
        # SRPS.cu:270,321) — dump them once up front.
        writers.save_visualizations(rt.dump_dir, state,
                                    np.asarray(prob.mask), tag="_init")

    viewer = None
    if rt.live_view:
        # Live cv::imshow windows (SRPS.cu:319-327); headless environments
        # auto-disable with a warning (io/liveview.py).
        from ..io.liveview import LiveView

        viewer = LiveView()
        viewer.set_initial(state, np.asarray(prob.mask))

    if rt.fused_outer_loop:
        per_iter_dumps = (rt.dump_iterations or rt.save_visualizations
                          or viewer is not None)
        t = Timer().start()
        if per_iter_dumps:
            # Trace-carrying variant: the reference dumps s/rho/z/N EVERY
            # outer iteration (SRPS.cu:330-333); the traces let fused mode
            # reproduce that file-for-file after the on-device solve.
            final, trace, straces = _jit_solve_fused_traced(
                state, prob, sf, cfg)
        else:
            final, trace = _jit_solve_fused(state, prob, sf, cfg)
        dt = t.end(final.z)
        trace = np.asarray(trace)
        n_it = int(final.iteration)
        for i in range(n_it):
            metrics.append({"iteration": i + 1, "energy": float(trace[i])})
        metrics.append({"total_seconds": dt, "iterations": n_it})
        if verbose:
            print(f"fused solve: {n_it} iterations in {dt:.3f}s, "
                  f"final energy {float(final.energy):.3f}")
        if per_iter_dumps:
            straces = {k: np.asarray(v) for k, v in straces.items()}
            mask = np.asarray(prob.mask)
            for i in range(n_it):
                st_i = srps.SRPSState(
                    z=straces["z"][i], rho=straces["rho"][i],
                    s=straces["s"][i], N=straces["N"][i],
                    dz=straces["dz"][i],
                    energy=trace[i],
                    last_energy=trace[i - 1] if i else np.float32(np.nan),
                    iteration=np.int32(i + 1), cg_iters=np.int32(0))
                if rt.dump_iterations:
                    # Untagged names each iteration (reference overwrite
                    # behaviour) + resumable checkpoint.
                    writers.dump_state(rt.dump_dir, st_i, mask,
                                       fmt=rt.dump_format)
                    writers.save_checkpoint(
                        f"{rt.dump_dir}/checkpoint.npz", st_i, i + 1)
                if rt.save_visualizations:
                    writers.save_visualizations(rt.dump_dir, st_i, mask,
                                                tag=f"_{i + 1:02d}")
                if viewer is not None:
                    viewer.show(st_i, mask)
        _write_outputs(final, prob, rt, metrics)
        if viewer is not None:
            viewer.finish()
        return final, metrics

    last_error = float(state.energy) if rt.resume_from else float("nan")
    iteration = int(state.iteration) + 1
    while True:
        # Per-phase execution with the reference's exact print format
        # (SRPS.cu:277-295: "%-25s: %-6.6fs" per phase, then the iteration
        # summary; the normals recompute is after the summary, untimed).
        t = Timer().start()
        s = _jit_phase_lighting(state, prob)
        t_light = t.end(s)
        if verbose:
            print(f"\n{'Lightning Estimation':<25}: {t_light:<6.6f}s")
        t = Timer().start()
        mom, rho = _jit_phase_albedo(s, state, prob)
        t_albedo = t.end(rho)
        if verbose:
            print(f"{'Albedo Estimation':<25}: {t_albedo:<6.6f}s")
        t = Timer().start()
        z, energy, cg_iters = _jit_phase_depth(mom, rho, state, prob, sf, cfg)
        t_depth = t.end(z)
        if verbose:
            print(f"{'Depth Estimation':<25}: {t_depth:<6.6f}s")

        error = float(energy)
        rel_err = abs(last_error - error) / abs(error)
        rec = {
            "iteration": iteration,
            "energy": error,
            "relative_error": rel_err,
            "cg_iterations": int(cg_iters),
            "lighting_seconds": t_light,
            "albedo_seconds": t_albedo,
            "depth_seconds": t_depth,
            "seconds": t_light + t_albedo + t_depth,
        }
        metrics.append(rec)
        if verbose:
            print(f"\nIteration {iteration:02d} summary")
            print(f"{'Error':<25}: {error:<6.3f}")
            print(f"{'Relative Error':<25}: {rel_err:<6.3f}")

        N, dz = _jit_phase_normals(z, prob)
        state = srps.SRPSState(
            z=z, rho=rho, s=s, N=N, dz=dz,
            energy=energy, last_energy=state.energy,
            iteration=state.iteration + 1, cg_iters=cg_iters)
        if rt.dump_iterations:
            writers.dump_state(rt.dump_dir, state, np.asarray(prob.mask),
                               fmt=rt.dump_format)
            writers.save_checkpoint(
                f"{rt.dump_dir}/checkpoint.npz", state, iteration)
        if rt.save_visualizations:
            writers.save_visualizations(rt.dump_dir, state,
                                        np.asarray(prob.mask), tag=f"_{iteration:02d}")
        if viewer is not None:
            viewer.show(state, np.asarray(prob.mask))
        # Stopping rule — exact reference semantics (SRPS.cu:297-301).
        stop = (error > last_error) or (rel_err < cfg.tolerance) or (
            iteration > cfg.max_iterations)
        last_error = error
        iteration += 1
        if stop:
            break

    _write_outputs(state, prob, rt, metrics)
    if viewer is not None:
        viewer.finish()
    return state, metrics


def _write_outputs(state, prob, rt: RuntimeConfig, metrics):
    if rt.metrics_jsonl:
        parent = os.path.dirname(rt.metrics_jsonl)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(rt.metrics_jsonl, "w") as f:
            for rec in metrics:
                f.write(json.dumps(rec) + "\n")
    if rt.dump_iterations or rt.save_visualizations:
        mask = np.asarray(prob.mask)
        if rt.dump_iterations:
            writers.dump_state(rt.dump_dir, state, mask, fmt=rt.dump_format,
                               tag="_final")
        if rt.save_visualizations:
            writers.save_visualizations(rt.dump_dir, state, mask, tag="_final")
