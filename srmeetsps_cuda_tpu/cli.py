"""Command-line interface, matching the reference binary's surface
(Main.cpp:9-44):

  --dstype {matlab,images}   dataset type (default: matlab)
  --dsloc PATH               path to .mat file or image folder (required)
  --device N                 selects the JAX device index
  --blockx N / --blocky N    accepted for parity; no effect (XLA owns the
                             launch geometry)

plus extensions (solver constants, dumps, fused mode, batches, sharding).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from .config import RuntimeConfig, SolverConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="srmeetsps",
        description="Depth Super-Resolution Meets Uncalibrated Photometric "
        "Stereo — matrix-free JAX solver",
    )
    # Reference-parity flags (Main.cpp:10-17).
    p.add_argument("--dstype", "-t", choices=["matlab", "images"], default="matlab")
    p.add_argument("--dsloc", "-d",
                   help="path to dataset mat file or image folder; a "
                        "comma-separated list runs a batched multi-object "
                        "solve (see --batch-mode)")
    p.add_argument("--device", "-g", type=int, default=0,
                   help="JAX device index to run on")
    p.add_argument("--blockx", "-x", type=int, default=256,
                   help="block dimension x (parity flag; no effect)")
    p.add_argument("--blocky", "-y", type=int, default=4,
                   help="block dimension y (parity flag; no effect)")
    # Solver constants (defaults = reference hard-coded values).
    p.add_argument("--tolerance", type=float, default=5e-3)
    p.add_argument("--max-iterations", type=int, default=10)
    p.add_argument("--cg-tol", type=float, default=1e-9)
    p.add_argument("--cg-max-iter", type=int, default=100)
    p.add_argument("--lambda", dest="lam", type=float, default=1.0)
    p.add_argument("--jacobi", action="store_true",
                   help="Jacobi-preconditioned depth CG (faster; the "
                   "reference uses plain CG)")
    p.add_argument("--fast", action="store_true",
                   help="fast preset: plain CG at cap 40 — the same "
                        "recurrence as the reference, only the iteration "
                        "cap changes. Explicit --cg-max-iter still "
                        "overrides")
    # Runtime.
    p.add_argument("--fused", action="store_true", default=None,
                   help="run the whole outer loop on-device (no per-iteration "
                   "host sync; the default on a GPU backend)")
    p.add_argument("--dump", action="store_true",
                   help="dump s/rho/z/N each iteration (reference behaviour)")
    p.add_argument("--dump-dir", default=".")
    p.add_argument("--dump-format", choices=["mat", "mat5", "npz"],
                   default="mat",
                   help="mat = MAT 7.3 HDF5 container (reference parity, "
                        "Utilities.cpp MAT_FT_MAT73); mat5 = scipy v5")
    p.add_argument("--viz", action="store_true",
                   help="save PNG visualizations (replaces cv::imshow)")
    p.add_argument("--show", action="store_true",
                   help="live preview windows per outer iteration "
                        "(reference cv::imshow parity: Normals-Initial / "
                        "Normals-Current-Iteration / Albedo, SRPS.cu:319-"
                        "327); needs a GUI cv2, auto-disables headless")
    p.add_argument("--dump-operators", action="store_true",
                   help="dump D/Dx/Dy/KT as ii/jj/kk triplet MAT files "
                   "(reference sparse golden channel)")
    p.add_argument("--metrics-jsonl", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--stepwise", dest="fused", action="store_false",
                   help="force one host-synced outer iteration per step "
                        "(per-phase timings; the default on CPU)")
    p.add_argument("--batch-mode", choices=["auto", "stream", "lockstep"],
                   default="auto",
                   help="multi-object (comma --dsloc) execution form: "
                        "stream = one fused solve per lane (lanes "
                        "bit-identical to solo runs); lockstep = one "
                        "vmapped program for all lanes; auto = stream")
    p.add_argument("--cg-variant", choices=["std", "cgs"], default="std",
                   help="depth-CG recurrence of --sharded: std = standard "
                        "CG (default); cgs = Chronopoulos-Gear single-"
                        "reduction CG (one fused psum per iteration, "
                        "reorders rounding)")
    p.add_argument("--image-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="image stack dtype; bfloat16 halves the memory "
                        "traffic of the per-iteration image passes")
    p.add_argument("--sharded", type=int, default=0, metavar="N",
                   help="grid-shard the solve over N devices (1D row-band "
                   "mesh, manual halo-exchange CG; 0 = off)")
    p.add_argument("--serve", action="store_true",
                   help="resident-program serving loop: read one dataset "
                        "location per line from stdin, keep the compiled "
                        "solve live across requests (same-geometry "
                        "requests skip recompilation), print one JSON "
                        "result line per request ('quit' to stop)")
    p.add_argument("--nan-check", action="store_true",
                   help="raise on the first NaN-producing op (jax_debug_nans)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the solve")
    return p


def resolve_auto_flags(args, backend: str):
    """Route the default invocation to the backend's path.

    The reference binary runs its one optimized path by default
    (Main.cpp:34-35); here a bare ``python -m srmeetsps_cuda_tpu --dsloc
    <path>`` on a GPU backend runs the fully on-device fused outer loop,
    and on CPU the stepwise loop with per-phase timings. ``--fused`` /
    ``--stepwise`` force either (tri-state: None = backend default)."""
    if args.fused is None:
        args.fused = backend == "gpu"
    return args


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.dsloc and not args.serve:
        parser.print_help()
        return 0
    if args.cg_variant != "std" and not args.sharded:
        parser.error("--cg-variant cgs applies only to --sharded N")
    if args.cg_variant == "cgs" and args.jacobi:
        parser.error("--cg-variant cgs has no Jacobi-preconditioned form")

    import jax

    devs = jax.devices()
    if not 0 <= args.device < len(devs):
        parser.error(f"--device {args.device}: {len(devs)} device(s) "
                     f"visible ({devs[0].platform})")
    if args.sharded > len(devs):
        parser.error(f"--sharded {args.sharded}: only {len(devs)} "
                     f"device(s) visible ({devs[0].platform})")
    jax.config.update("jax_default_device", devs[args.device])
    args = resolve_auto_flags(args, jax.default_backend())

    def _load(loc):
        if args.dstype == "matlab":
            from .io.mat_loader import load_mat_dataset

            return load_mat_dataset(loc)
        from .io.image_loader import load_image_dataset

        return load_image_dataset(loc)

    if args.fast:
        # Preset only where the user did not explicitly choose.
        if args.cg_max_iter == 100:
            args.cg_max_iter = 40
    cfg = SolverConfig(
        tolerance=args.tolerance,
        max_iterations=args.max_iterations,
        cg_tol=args.cg_tol,
        cg_max_iter=args.cg_max_iter,
        lam=args.lam,
        jacobi_preconditioner=args.jacobi,
        cg_variant=args.cg_variant,
        image_dtype=args.image_dtype,
    )
    rt = RuntimeConfig(
        dump_iterations=args.dump,
        dump_dir=args.dump_dir,
        dump_format=args.dump_format,
        save_visualizations=args.viz,
        live_view=args.show,
        metrics_jsonl=args.metrics_jsonl,
        resume_from=args.resume_from,
        dump_operators=args.dump_operators,
        fused_outer_loop=args.fused,
        nan_check=args.nan_check,
        profile_dir=args.profile_dir,
        batch_mode=args.batch_mode,
    )

    if args.serve:
        return _run_serve(_load, cfg, rt)

    # Comma-separated --dsloc = batched multi-object solve
    # (parallel/batched.py).
    locs = [s for s in args.dsloc.split(",") if s]
    datas = [_load(loc) for loc in locs]
    data = datas[0]

    if len(datas) > 1:
        _run_batched(datas, locs, cfg, rt)
    elif args.sharded:
        _run_sharded(data, cfg, args.sharded, rt)
    else:
        from .runtime.solver import solve

        solve(data, cfg, rt, verbose=True)
    print("Done!")
    return 0


def run(argv=None) -> int:
    """Console entry point: :func:`main` with the persistent compilation
    cache enabled (runtime/compile_cache.py)."""
    from .runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    return main(argv)


def _run_serve(load_fn, cfg, rt) -> int:
    """Resident-program serving loop: one dataset location per stdin
    line; the jitted fused solve stays live across requests, so every
    same-geometry request skips compilation entirely
    (the reference is one-solve-per-process, Main.cpp:9-44 — this removes
    that ceiling). A comma-separated line runs a batched solve
    (mixed geometries auto-pad to a common grid). Emits one JSON line per
    request; 'quit'/'exit' or EOF stops."""
    import json
    import sys
    import time

    import jax
    import numpy as np

    from .runtime.solver import Timer, _jit_solve_fused, prepare

    print(json.dumps({"serving": True,
                      "platform": jax.devices()[0].platform}), flush=True)
    for line in sys.stdin:
        req = line.strip()
        if not req:
            continue
        if req in ("quit", "exit"):
            break
        try:
            t0 = time.perf_counter()
            locs = [s for s in req.split(",") if s]
            datas = [load_fn(loc) for loc in locs]
            sf = int(datas[0].sf)
            if len(datas) == 1:
                prob, st = prepare(datas[0], cfg)
                t = Timer().start()
                final, trace = _jit_solve_fused(st, prob, sf, cfg)
                dt_solve = t.end(final.z)
                out = {"dsloc": req, "iterations": int(final.iteration),
                       "final_energy": float(final.energy)}
            else:
                from .models import srps  # noqa: F401 (import check)
                from .parallel import batched

                shapes = [tuple(d.mask.shape) for d in datas]
                pad_to = None
                if len(set(shapes)) != 1:
                    H = max(h for h, _ in shapes)
                    W = max(w for _, w in shapes)
                    H += (-H) % sf
                    W += (-W) % sf
                    pad_to = (H, W)
                pairs = [prepare(d, cfg, pad_to=pad_to) for d in datas]
                t = Timer().start()
                finals, traces = batched.solve_batch(
                    [s for _, s in pairs], [p for p, _ in pairs], sf, cfg,
                    mode=rt.batch_mode)
                dt_solve = t.end(finals)
                trs = [np.asarray(tr) for tr in traces]
                out = {"dsloc": req, "batch": len(datas),
                       "iterations": [int(np.isfinite(tr).sum())
                                      for tr in trs],
                       "final_energy": [float(np.asarray(f.energy))
                                        for f in finals]}
            out["solve_seconds"] = round(dt_solve, 4)
            out["total_seconds"] = round(time.perf_counter() - t0, 4)
            print(json.dumps(out), flush=True)
        except Exception as e:  # keep serving on bad requests
            print(json.dumps({"dsloc": req, "error": str(e)[:300]}),
                  flush=True)
    return 0


def _run_batched(datas, locs, cfg, rt):
    """Batched solve of several datasets (one per --dsloc entry,
    comma-separated); outputs land in per-object subdirectories."""
    import os

    import numpy as np

    from .io import writers
    from .models import srps
    from .parallel import batched
    from .runtime.solver import prepare

    sfs = {int(d.sf) for d in datas}
    stacks = {tuple(d.I.shape[:2]) for d in datas}  # (n images, c channels)
    if len(sfs) != 1 or len(stacks) != 1:
        raise SystemExit(
            f"batched solve needs matching sf and image counts: "
            f"sf={sorted(sfs)}, (n,c)={sorted(stacks)}")
    if rt.resume_from:
        raise SystemExit("--resume-from is not supported in batched "
                         "(comma --dsloc) mode; run objects separately")
    sf = sfs.pop()
    shapes = [tuple(d.mask.shape) for d in datas]
    pad_to = None
    if len(set(shapes)) != 1:
        # Mixed-geometry batching: zero-pad every object (post-preprocess,
        # outside its mask) to the common grid so all lanes share one
        # compiled program.
        H = max(h for h, _ in shapes)
        W = max(w for _, w in shapes)
        H += (-H) % sf
        W += (-W) % sf
        pad_to = (H, W)
        print(f"mixed geometry {sorted(set(shapes))}: padding all lanes "
              f"to {pad_to}")
    probs, states = [], []
    for d in datas:
        pb, st = prepare(d, cfg, pad_to=pad_to)
        probs.append(pb)
        states.append(st)
    profiler_cm = None
    if rt.profile_dir:
        import jax

        profiler_cm = jax.profiler.trace(rt.profile_dir)
        profiler_cm.__enter__()
    try:
        finals, traces = batched.solve_batch(states, probs, sf, cfg,
                                             mode=rt.batch_mode)
        traces = [np.asarray(tr) for tr in traces]
    finally:
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
    final_energies = [float(np.asarray(f.energy)) for f in finals]
    # Output names: dataset basename, deduped with the lane index when two
    # --dsloc entries share a basename (they'd otherwise overwrite each
    # other's dumps).
    names = [os.path.basename(os.path.normpath(loc)) or f"obj{b}"
             for b, loc in enumerate(locs)]
    names = [n if names.count(n) == 1 else f"{n}_{b}"
             for b, n in enumerate(names)]
    metrics = []
    for b, loc in enumerate(locs):
        name = names[b]
        n_it = int(np.isfinite(traces[b]).sum())
        # Report the energy of the state actually written (the last
        # iterate), not the trajectory minimum — the stopping rule allows
        # a final energy increase (reference semantics).
        print(f"[{name}] {n_it} iterations, final energy "
              f"{final_energies[b]:.3f}")
        for i in range(n_it):
            metrics.append({"object": name, "iteration": i + 1,
                            "energy": float(traces[b][i])})
        metrics.append({"object": name, "iterations": n_it,
                        "final_energy": final_energies[b]})
        if rt.dump_iterations or rt.save_visualizations:
            sub = os.path.join(rt.dump_dir, name)
            os.makedirs(sub, exist_ok=True)
            st_b = srps.SRPSState(*[np.asarray(x) for x in finals[b]])
            mask = np.asarray(probs[b].mask)
            if pad_to is not None:
                # Crop the grid-shaped fields back to the object's native
                # extent for dumps/viz (s/energy/counters are not grids).
                h0, w0 = shapes[b]
                crop = lambda a: np.asarray(a)[..., :h0, :w0]
                st_b = st_b._replace(z=crop(st_b.z), rho=crop(st_b.rho),
                                     N=crop(st_b.N), dz=crop(st_b.dz))
                mask = mask[:h0, :w0]
            if rt.dump_iterations:
                writers.dump_state(sub, st_b, mask, fmt=rt.dump_format,
                                   tag="_final")
            if rt.save_visualizations:
                writers.save_visualizations(sub, st_b, mask, tag="_final")
    if rt.metrics_jsonl:
        import json

        parent = os.path.dirname(rt.metrics_jsonl)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(rt.metrics_jsonl, "w") as f:
            for rec in metrics:
                f.write(json.dumps(rec) + "\n")


def _run_sharded(data, cfg, n_devices: int, rt=None):
    """Grid-sharded fused solve over a 1D row-band mesh."""
    import os
    from functools import partial

    import jax
    import numpy as np

    from .io import writers
    from .parallel.sharded import (make_mesh_1d, shard_pytree_rows,
                                   solve_fused_sharded)
    from .runtime.solver import Timer, prepare

    mesh = make_mesh_1d(n_devices)
    prob, state = prepare(data, cfg)
    h = prob.mask.shape[0]
    sf = int(data.sf)
    # Both the HR leaves (h rows) and the LR-grid leaves (h/sf rows:
    # masks, z0s) are row-sharded.
    if h % n_devices or (h // sf) % n_devices:
        raise SystemExit(
            f"--sharded: image height {h} and LR height {h // sf} must "
            f"both be divisible by {n_devices}")
    prob = shard_pytree_rows(prob, mesh)
    state = shard_pytree_rows(state, mesh)
    t = Timer().start()
    final, trace = jax.jit(partial(
        solve_fused_sharded, sf=sf, cfg=cfg, mesh=mesh))(
            state, prob)
    dt = t.end(final.z)
    trace = np.asarray(trace)
    n_it = int(final.iteration)
    metrics = []
    for i in range(n_it):
        print(f"Iteration {i + 1:02d}  Error: {float(trace[i]):.3f}")
        metrics.append({"iteration": i + 1, "energy": float(trace[i])})
    metrics.append({"total_seconds": dt, "iterations": n_it,
                    "devices": n_devices})
    print(f"sharded solve ({n_devices} devices): {n_it} iterations "
          f"in {dt:.3f}s, final energy {float(final.energy):.3f}")
    if rt is not None:
        from .runtime.solver import _write_outputs

        _write_outputs(final, prob, rt, metrics)


if __name__ == "__main__":
    sys.exit(main())
