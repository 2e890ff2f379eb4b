"""Configuration for the SRmeetsPS solver.

Mirrors the reference's configuration surface while exposing the hard-coded
solver constants as first-class options:

- outer loop: ``TOLERANCE = 5e-3``, ``MAX_ITERATIONS = 10``
  (reference ``SRPS.cu:85-86``),
- conjugate gradient: ``tol = 1e-9`` (on the *squared* residual),
  ``max_iter = 100`` (reference ``devicecalls.cu:230-231``),
- depth data weight ``lambda = 1`` (reference ``devicecalls.cu:644``),
- preprocessing: inpaint radius 16, bilateral sigma 2/2
  (reference ``SRPS.cu:133,139``),
- CLI keys ``dstype/dsloc/device/blockx/blocky`` (reference ``Main.cpp:10-17``);
  ``blockx/blocky`` are accepted for CLI parity but have no effect (XLA owns
  the launch geometry); ``device`` selects the JAX device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver constants. Defaults match the reference binary exactly."""

    # Outer alternating-optimization loop (SRPS.cu:85-86, 297-301).
    tolerance: float = 5e-3
    max_iterations: int = 10

    # Conjugate gradient (devicecalls.cu:230-231). ``cg_tol`` is compared
    # against the squared residual norm, as in the reference
    # (``while (r1 > tol*tol && k <= max_iter)``).
    cg_tol: float = 1e-9
    cg_max_iter: int = 100

    # Depth estimation data-term weight (devicecalls.cu:644).
    lam: float = 1.0

    # Preprocessing of the low-resolution depth (SRPS.cu:129-149).
    inpaint_radius: int = 16
    bilateral_sigma_color: float = 2.0
    bilateral_sigma_space: float = 2.0
    # Iterations for the JAX diffusion-based inpainting substitute for
    # cv::INPAINT_TELEA. None = derived from the radius as
    # 2 * inpaint_radius**2 (diffusion closes a hole of radius r in O(r^2)
    # sweeps; 512 at the reference radius 16). Set explicitly to override.
    inpaint_iters: Optional[int] = None

    # Jacobi (diagonal) preconditioning of the depth CG system. The
    # reference uses plain CG; Jacobi typically cuts iterations ~2x and is
    # the default for the fast path. Set False for trajectory parity.
    jacobi_preconditioner: bool = False

    # Compute dtype for the heavy image reductions ("float32" | "bfloat16").
    # bfloat16 halves the device-memory traffic of the two per-iteration
    # passes over I at a small accuracy cost; accumulation is always float32.
    image_dtype: str = "float32"

    # Depth-CG recurrence on the row-sharded path (``--sharded``): "std" =
    # standard CG (two reductions per iteration); "cgs" = Chronopoulos-Gear
    # single-reduction CG (one fused psum per iteration, reorders rounding).
    # The single-device solve always runs standard CG.
    cg_variant: str = "std"


@dataclasses.dataclass(frozen=True)
class Preferences:
    """CLI-level preferences, mirroring the reference ``Preferences`` struct
    (Utilities.h:224-230, Main.cpp:5-7). ``block_x/block_y/device_id`` are
    retained for interface parity; the block sizes are advisory only."""

    block_x: int = 256
    block_y: int = 4
    device_id: int = 0


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Run-level options for the outer solver driver."""

    # Dump s/rho/z/N every outer iteration (reference SRPS.cu:330-333).
    dump_iterations: bool = False
    dump_dir: str = "."
    dump_format: str = "mat"  # "mat" (MAT 7.3 HDF5) | "mat5" | "npz"
    # Save PNG visualizations (replaces the reference's cv::imshow windows).
    save_visualizations: bool = False
    # Live cv::imshow windows per outer iteration (SRPS.cu:319-327);
    # requires a GUI-capable cv2 — auto-disables headless (io/liveview.py).
    live_view: bool = False
    # Structured per-iteration metrics as JSONL (path or None).
    metrics_jsonl: Optional[str] = None
    # Resume from a checkpoint dumped by a previous run.
    resume_from: Optional[str] = None
    # Dump the designed-out sparse operators (D/Dx/Dy/KT) as ii/jj/kk
    # triplet MAT files (the reference's WRITE_MAT_FROM_DEVICE_SPARSE
    # channel, Utilities.cpp:85-122) for MATLAB diffing.
    dump_operators: bool = False
    # Debug-NaN mode: makes XLA raise on the first NaN-producing op
    # (jax_debug_nans) — the JAX analog of running under a sanitizer.
    nan_check: bool = False
    # Capture a jax.profiler trace of the solve into this directory.
    profile_dir: Optional[str] = None
    # Multi-object batch execution form (parallel/batched.py::solve_batch):
    # "stream" = per-lane dispatch of the fused single-problem solve;
    # "lockstep" = one vmapped program for all lanes; "auto" = stream.
    batch_mode: str = "auto"
    # Run the whole outer loop on-device inside one lax.while_loop (no
    # per-iteration host sync). Iteration metrics are then only available
    # as a trace after the solve.
    fused_outer_loop: bool = False


DEFAULT_SOLVER = SolverConfig()
DEFAULT_PREFS = Preferences()
