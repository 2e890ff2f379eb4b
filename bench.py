"""Benchmark harness: end-to-end SRPS solves on one GPU.

Prints ONE JSON line with solves/sec and seconds per solve for the
Mitten-geometry solve at SF=2 (one-shot and sustained, plus the --fast and
bf16 presets), the MAT-container path, SF=4, a batch of 4 and a
1080p-class grid, and the accuracy gates of the exactly-consistent
fixture. The line names the device it ran on. A run that finds no GPU
fails; a phase that fails ends the run with a non-zero exit.

Subcommands run one configuration: ``batched [B]``, ``batched-bf16 [B]``,
``batched-mixed [B]``, ``sf4``, ``1080p``, ``4k``, ``matpath``.
"""

from __future__ import annotations

import json
import os
import sys
import time

_T0 = time.time()


def _note(msg: str):
    """Progress/wall-clock note on stderr (stdout stays the one JSON
    line), so a long run shows where it spends its time."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _require_gpu():
    """Set up the compile cache and fail unless JAX's default backend is a
    GPU. Returns the device description every result line carries."""
    import jax

    from srmeetsps_cuda_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found only "
                         f"{devs[0].platform} devices")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def find_dataset():
    """The Mitten image folder, when a copy sits in ``dataset/Mitten``
    beside this script."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dataset", "Mitten")
    return here if os.path.isdir(here) else None


def synthetic_dataset(h=960, w=1280, sf=2, n=20, c=3):
    """Fallback workload with the Mitten geometry when the fixture is
    unavailable."""
    import numpy as np

    from srmeetsps_cuda_tpu.io.image_loader import ProblemData

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - h / 2) ** 2 + (xx - w / 2) ** 2) < (0.4 * min(h, w)) ** 2
            ).astype(np.float32)
    I = rng.random((n, c, h, w)).astype(np.float32)
    z0 = (rng.random((n, h // sf, w // sf)).astype(np.float32) + 1.0) * 4000.0
    K = np.array([[1216.73, 0, w / 2 - 0.5], [0, 1216.73, h / 2 - 0.5],
                  [0, 0, 1]], np.float32)
    return ProblemData(I=I, K=K, mask=mask, sf=sf, z0=z0)


def _load_mitten():
    ds = find_dataset()
    if ds:
        from srmeetsps_cuda_tpu.io.image_loader import load_image_dataset

        return load_image_dataset(ds), ds
    return synthetic_dataset(), None


def batched_metrics(B: int = 4, image_dtype: str = "float32", data=None):
    """BASELINE config 4: batched multi-object throughput. Measures BOTH
    execution forms with the sustained (async back-to-back, force-last)
    methodology so they are comparable to `sustained_solves_per_sec`:

    * streaming (parallel/batched.py::solve_batch "auto") — B async
      dispatches of the fused single-problem solve per batch.
    * lockstep — one vmapped program for all B lanes.

    Subcommand `python bench.py batched [B]`; bf16 images (halved
    image-pass memory traffic) via `python bench.py batched-bf16`."""
    import jax
    import numpy as np

    from srmeetsps_cuda_tpu.config import SolverConfig
    from srmeetsps_cuda_tpu.parallel import batched
    from srmeetsps_cuda_tpu.runtime.solver import prepare

    if data is None:
        data, _ = _load_mitten()
    cfg = SolverConfig(image_dtype=image_dtype)
    prob, st = prepare(data, cfg)
    probs_l, states_l = [prob] * B, [st] * B
    prob_b = batched.stack_problems(probs_l)
    st_b = batched.stack_states(states_l)
    sf = int(data.sf)

    def sustained(run, force, rounds=2, reps=3):
        """reps x (rounds back-to-back batch solves, then block on the
        last) -> best seconds per batch."""
        force(run())  # compile + warm
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(rounds):
                f = run()
            force(f)
            best = min(best, (time.perf_counter() - t0) / rounds)
        return best

    def run_stream():
        finals, _ = batched.solve_batched_streaming(states_l, probs_l, sf,
                                                    cfg)
        return finals

    def run_lockstep():
        final, _ = batched.solve_batched(st_b, prob_b, sf, cfg)
        return final

    dt = sustained(run_stream, jax.block_until_ready)
    dt_lk = sustained(run_lockstep, jax.block_until_ready)
    finals, _ = batched.solve_batched_streaming(states_l, probs_l, sf, cfg)
    iters = [int(np.asarray(f.iteration)) for f in finals]
    sfx = "_bf16" if image_dtype == "bfloat16" else ""
    return {
        f"batched{B}{sfx}_solves_per_sec": round(B / dt, 4),
        f"batched{B}{sfx}_seconds_per_batch": round(dt, 4),
        f"batched{B}{sfx}_iterations": iters,
        f"batched{B}{sfx}_lockstep_solves_per_sec": round(B / dt_lk, 4),
    }


def _fused_best(data, cfg, runs=3):
    """Best-of-N fused-solve wall time. Returns (dt_best, final_state)."""
    import jax

    from srmeetsps_cuda_tpu.runtime.solver import prepare, _jit_solve_fused

    sf = int(data.sf)
    prob, st = prepare(data, cfg)
    jax.block_until_ready(_jit_solve_fused(st, prob, sf, cfg))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        final, _ = jax.block_until_ready(_jit_solve_fused(st, prob, sf, cfg))
        times.append(time.perf_counter() - t0)
    return min(times), final


def _sustained(data, cfg, n=8):
    """Sustained rate: n back-to-back solves, blocking only on the last,
    so each solve's dispatch overlaps the previous one's device work."""
    import jax

    from srmeetsps_cuda_tpu.runtime.solver import prepare, _jit_solve_fused

    sf = int(data.sf)
    prob, st = prepare(data, cfg)
    jax.block_until_ready(_jit_solve_fused(st, prob, sf, cfg))  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        last, _ = _jit_solve_fused(st, prob, sf, cfg)
    jax.block_until_ready(last)
    return (time.perf_counter() - t0) / n, last


def _crop_data(data, h, w):
    import numpy as np

    from srmeetsps_cuda_tpu.io.image_loader import ProblemData

    sf = int(data.sf)
    return ProblemData(
        I=np.asarray(data.I)[:, :, :h, :w], K=data.K,
        mask=np.asarray(data.mask)[:h, :w], sf=data.sf,
        z0=np.asarray(data.z0)[:, :h // sf, :w // sf])


def batched_mixed_metrics(B: int = 4):
    """Mixed-geometry batches: B objects with DIFFERENT grid sizes pad to a
    common grid (post-preprocess, outside their masks) and solve as one
    lockstep batch. Invoke with `python bench.py batched-mixed [B]`."""
    import jax
    import numpy as np

    from srmeetsps_cuda_tpu.config import SolverConfig
    from srmeetsps_cuda_tpu.parallel import batched
    from srmeetsps_cuda_tpu.runtime.solver import prepare

    ds = find_dataset()
    if ds:
        from srmeetsps_cuda_tpu.io.image_loader import load_image_dataset

        base = load_image_dataset(ds)
    else:
        base = synthetic_dataset()
    sizes = [(960, 1280), (912, 1216), (896, 1152), (864, 1088)]
    datas = [_crop_data(base, *sizes[b % len(sizes)]) for b in range(B)]
    H = max(h for h, _ in sizes[:B])
    W = max(w for _, w in sizes[:B])
    cfg = SolverConfig()
    pairs = [prepare(d, cfg, pad_to=(H, W)) for d in datas]
    prob_b = batched.stack_problems([p for p, _ in pairs])
    st_b = batched.stack_states([s for _, s in pairs])
    sf = int(base.sf)
    jax.block_until_ready(batched.solve_batched(st_b, prob_b, sf, cfg))
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        final, _ = jax.block_until_ready(
            batched.solve_batched(st_b, prob_b, sf, cfg))
        times.append(time.perf_counter() - t0)
    dt = min(times)
    return {
        "metric": f"mitten_sf2_batched{B}_mixed_geometry",
        "value": round(B / dt, 4),
        "unit": "solves/sec",
        "seconds_per_batch": round(dt, 4),
        "sizes": sizes[:B],
        "iterations": np.asarray(final.iteration).tolist(),
    }


def _sf4_data(base=None):
    from srmeetsps_cuda_tpu.io.image_loader import ProblemData

    if base is None:
        base, _ = _load_mitten()
    if base.z0.shape[1] * 4 == base.mask.shape[0]:
        return ProblemData(I=base.I, K=base.K, mask=base.mask, sf=4,
                           z0=base.z0)
    return ProblemData(I=base.I, K=base.K, mask=base.mask, sf=4,
                       z0=base.z0[:, ::2, ::2])


def sf4_metrics(data=None):
    """BASELINE config 3: SF=4 upscaling (Mitten depth further decimated)."""
    from srmeetsps_cuda_tpu.config import SolverConfig

    dt, final = _fused_best(_sf4_data(data), SolverConfig())
    return {
        "sf4_solves_per_sec": round(1.0 / dt, 4),
        "sf4_seconds_per_solve": round(dt, 4),
        "sf4_iterations": int(final.iteration),
        "sf4_final_energy": float(final.energy),
    }


def metrics_1080p():
    """BASELINE config 5's problem size on ONE GPU (the sharded path runs
    in `chip_smoke.py --four-cards`)."""
    from srmeetsps_cuda_tpu.config import SolverConfig

    data = synthetic_dataset(h=1088, w=1920, sf=2, n=12)
    dt, final = _fused_best(data, SolverConfig())
    return {
        "1080p_solves_per_sec": round(1.0 / dt, 4),
        "1080p_seconds_per_solve": round(dt, 4),
        "1080p_iterations": int(final.iteration),
    }


def matpath_metrics(data=None, headline_energy=None):
    """BASELINE config 2: the MATLAB-container input path. The reference's
    mitten_sf2.mat blob is missing upstream (.MISSING_LARGE_BLOBS:1), so
    the bench converts the dataset to a MAT v5 file in a temporary
    directory, reloads it through the MAT loader, and solves — checking
    the trajectory lands exactly where the images path did (the two
    DataHandlers' equivalence guarantee, Utilities.cpp:159-199 vs
    :349-395)."""
    import tempfile

    from srmeetsps_cuda_tpu.config import SolverConfig
    from srmeetsps_cuda_tpu.io.mat_loader import (load_mat_dataset,
                                                  save_mat_dataset)

    if data is None:
        data, _ = _load_mitten()
    with tempfile.TemporaryDirectory() as tmp:
        mat_path = os.path.join(tmp, "mitten_sf2.mat")
        save_mat_dataset(mat_path, data, fmt="mat5")
        t0 = time.perf_counter()
        data_m = load_mat_dataset(mat_path)
        load_s = time.perf_counter() - t0
    dt, final = _fused_best(data_m, SolverConfig())
    out = {
        "matpath_solves_per_sec": round(1.0 / dt, 4),
        "matpath_seconds_per_solve": round(dt, 4),
        "matpath_load_seconds": round(load_s, 3),
        "matpath_final_energy": float(final.energy),
    }
    if headline_energy is not None:
        # Bit-identical inputs -> bit-identical solve.
        out["matpath_energy_matches"] = bool(
            float(final.energy) == float(headline_energy))
    return out


def metrics_4k():
    """4K-class grid on one GPU. Invoke with `python bench.py 4k`."""
    from srmeetsps_cuda_tpu.config import SolverConfig

    data = synthetic_dataset(h=2176, w=3840, sf=2, n=8)
    dt, final = _fused_best(data, SolverConfig())
    return {
        "metric": "4k_sf2_e2e_solve",
        "value": round(1.0 / dt, 4),
        "unit": "solves/sec",
        "seconds_per_solve": round(dt, 4),
        "iterations": int(final.iteration),
        "final_energy": float(final.energy),
    }


def accuracy_metrics():
    """Accuracy north-star for the bench line: solve the exactly-consistent
    synthetic fixture (io/synthetic.py: images rendered with the solver's
    own masked-stencil normals from a known surface, high-freq detail
    invisible to the bicubic init) and report depth RMSE and mean normal
    angular error vs ground truth. A silent numerical regression that
    preserves the energy scale would still flip ``accuracy_ok`` here."""
    import numpy as np

    from srmeetsps_cuda_tpu.config import RuntimeConfig, SolverConfig
    from srmeetsps_cuda_tpu.io.synthetic import (disc_mask,
                                                 mean_normal_error_deg,
                                                 render_consistent)
    from srmeetsps_cuda_tpu.runtime.solver import prepare, solve

    h, w = 48, 32
    mask = disc_mask(h, w)
    data, z_true, N_true = render_consistent(np.random.default_rng(42), mask)
    cfg = SolverConfig(inpaint_iters=64)
    prob, state0 = prepare(data, cfg)
    m = mask != 0
    rmse0 = float(np.sqrt(np.mean((np.asarray(state0.z) - z_true)[m] ** 2)))
    final, _ = solve(data, cfg, RuntimeConfig(), verbose=False)
    rmse = float(np.sqrt(np.mean((np.asarray(final.z) - z_true)[m] ** 2)))
    err_deg = mean_normal_error_deg(final.N, N_true, mask)
    # Trend anchor: rmse=1.009 on this fixed fixture (about the injected
    # z0 noise sigma=1.0). Gate depth on
    # an absolute band around that frozen golden so a z-only regression
    # that preserves normals still flips accuracy_ok. (rmse_init is NOT a
    # valid bound: z-RMSE against z_true is not an invariant of the
    # minimised energy — see tests/test_e2e.py — only its stability on
    # this fixed fixture is.)
    rmse_golden = 1.009
    # bf16 image-stack certification: same fixture, same gates. The bf16
    # preset only quantises the image stack I (the two roofline passes);
    # z/rho/N and all solver state stay f32, so accuracy should hold to
    # within the normals gate — this records it every round.
    final_b, _ = solve(data, SolverConfig(inpaint_iters=64,
                                          image_dtype="bfloat16"),
                       RuntimeConfig(), verbose=False)
    rmse_b = float(np.sqrt(np.mean((np.asarray(final_b.z) - z_true)[m] ** 2)))
    err_deg_b = mean_normal_error_deg(final_b.N, N_true, mask)
    return {
        "rmse": round(rmse, 5),
        "rmse_init": round(rmse0, 5),
        "rmse_golden": rmse_golden,
        "normals_err_deg": round(err_deg, 3),
        # Init is ~53 deg; 15 is the same threshold the e2e test enforces.
        "accuracy_ok": bool(err_deg < 15.0
                            and abs(rmse - rmse_golden) < 0.15),
        "bf16_rmse": round(rmse_b, 5),
        "bf16_normals_err_deg": round(err_deg_b, 3),
        "bf16_accuracy_ok": bool(err_deg_b < 15.0
                                 and abs(rmse_b - rmse_golden) < 0.25),
    }


def main():
    """Default run: ONE JSON line carrying all five BASELINE.md configs —
      1. Mitten geometry SF=2 (headline: one-shot, sustained, fast, bf16)
      2. MAT-container path (matpath_*)
      3. SF=4 (sf4_*)
      4. batched B=4 (batched4_*)
      5. 1080p-class grid (1080p_*)
    plus the accuracy gates."""
    from srmeetsps_cuda_tpu.config import SolverConfig

    data, ds = _load_mitten()
    _note("dataset loaded")

    cfg = SolverConfig()
    dt, final = _fused_best(data, cfg, runs=5)
    _note(f"headline timed ({dt:.3f}s best)")
    dt_sus, _ = _sustained(data, cfg)
    _note(f"sustained timed ({dt_sus:.3f}s/solve)")
    # Fast preset (--fast: plain CG @ cap 40), same sustained method.
    dt_f, fin_f = _sustained(data, SolverConfig(cg_max_iter=40))
    _note(f"fast preset timed ({dt_f:.3f}s/solve)")
    # bf16 image stack (--image-dtype bfloat16): halves the bytes of the
    # two per-iteration image passes; the final energy may not walk far
    # from the f32 trajectory.
    dt_b, fin_b = _sustained(data, SolverConfig(image_dtype="bfloat16"))
    _note(f"bf16 preset timed ({dt_b:.3f}s/solve)")
    e_rel = abs(float(fin_b.energy) - float(final.energy)) / abs(
        float(final.energy))
    result = {
        "metric": "mitten_sf2_e2e_solve",
        "value": round(1.0 / dt, 4),
        "unit": "solves/sec",
        "seconds_per_solve": round(dt, 4),
        "sustained_solves_per_sec": round(1.0 / dt_sus, 4),
        "iterations": int(final.iteration),
        "final_energy": float(final.energy),
        "fast_sustained_solves_per_sec": round(1.0 / dt_f, 4),
        "fast_device_time_ratio": round(dt_f / dt_sus, 4),
        "fast_final_energy": float(fin_f.energy),
        "bf16_sustained_solves_per_sec": round(1.0 / dt_b, 4),
        "bf16_device_time_ratio": round(dt_b / dt_sus, 4),
        "bf16_final_energy": float(fin_b.energy),
        "bf16_energy_delta_rel": round(e_rel, 5),
        "bf16_energy_ok": bool(e_rel < 0.05),
        "dataset": ds or "synthetic",
    }
    for name, fn in (
            ("matpath", lambda: matpath_metrics(data, result["final_energy"])),
            ("sf4", lambda: sf4_metrics(data)),
            ("batched", lambda: batched_metrics(4, data=data)),
            ("1080p", metrics_1080p),
            ("accuracy", accuracy_metrics),
    ):
        result.update(fn())
        _note(f"{name} done")
    return result


if __name__ == "__main__":
    device = _require_gpu()
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    run = {
        "batched": lambda: batched_metrics(B),
        "batched-bf16": lambda: batched_metrics(B, image_dtype="bfloat16"),
        "batched-mixed": lambda: batched_mixed_metrics(B),
        "sf4": sf4_metrics,
        "1080p": metrics_1080p,
        "4k": metrics_4k,
        "matpath": matpath_metrics,
    }.get(mode, main)
    print(json.dumps({**run(), "device": device}))
