"""Grid-sharded solve over a device mesh (BASELINE.json config 5).

The scaling axis of this workload is *pixels* (SURVEY.md section 5): the
masked HR grid is partitioned over a device mesh with axes

  ('data', 'x', 'y'):  data = object batch (DP), x/y = spatial grid (the
                       SP/CP analog for an image-grid workload).

All model code is pure dense-grid math, so sharding is expressed entirely
through ``NamedSharding`` annotations under ``jit`` — the XLA SPMD
partitioner inserts the halo exchanges for the +/-1-pixel gradient
stencils and the ``psum``-style reductions for the CG dot products
automatically; no communication code appears in the model. The manual
``shard_map`` + ``ppermute`` halo CG (parallel/shard_cg.py) behind
``--sharded`` is the hand-scheduled alternative.

Sharding layout:
  I (n, c, h, w)      -> P(None, None, 'x', 'y')
  mask/z/rho/N fields -> P(..., 'x', 'y') on the trailing two dims
  s (n, c, 4), Grams  -> replicated
  LR fields (h/sf, ..)-> P('x', 'y')  (tile-aligned: shard sizes are kept
                         multiples of sf so box-resampling never crosses
                         shard boundaries)
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SolverConfig
from ..models import srps


def make_mesh(n_devices: Optional[int] = None, data: int = 1) -> Mesh:
    """Build a ('data', 'x', 'y') mesh from the available devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    spatial = n_devices // data
    # Split the spatial factor as squarely as possible.
    x = 1
    for f in range(int(np.sqrt(spatial)), 0, -1):
        if spatial % f == 0:
            x = f
            break
    y = spatial // x
    arr = np.array(devs).reshape(data, x, y)
    return Mesh(arr, ("data", "x", "y"))


def _spec_for(leaf, mesh: Mesh, batched: bool) -> P:
    """Trailing-2-dims spatial sharding; leading batch dim -> 'data'."""
    nd = leaf.ndim
    spec = [None] * nd
    if nd >= 2:
        spec[-2] = "x"
        spec[-1] = "y"
    if batched and nd >= 3:
        spec[0] = "data"
    return P(*spec)


def _small_leaves(leaf) -> bool:
    # s (n,c,4), Gram matrices, scalars: replicate.
    return leaf.ndim < 2 or leaf.shape[-1] < 8


def _is_image_stack(path) -> bool:
    """The pixel-flattened image stack I (c, n, h*w) needs its own spec:
    its pixel axis is the LAST dim (contiguous row-major blocks == row
    bands when h divides the shard count), and its other dims (c, n) are
    tiny/non-divisible."""
    return bool(path) and getattr(path[-1], "name", None) == "I"


def shard_pytree(tree, mesh: Mesh, batched: bool = False):
    """Apply NamedShardings to every leaf of a problem/state pytree."""

    def place(path, leaf):
        leaf = jnp.asarray(leaf)
        if _is_image_stack(path):
            spec = [None] * leaf.ndim
            spec[-1] = ("x", "y")
            if batched:
                spec[0] = "data"
            spec = P(*spec)
        elif _small_leaves(leaf):
            spec = P("data") if (batched and leaf.ndim >= 1) else P()
        else:
            spec = _spec_for(leaf, mesh, batched)
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(place, tree)


def solve_sharded(
    state: srps.SRPSState,
    prob: srps.SRPSProblem,
    sf: int,
    cfg: SolverConfig,
    mesh: Mesh,
) -> Tuple[srps.SRPSState, jax.Array]:
    """Fused on-device solve with grid sharding. The inputs must already be
    placed with :func:`shard_pytree`; outputs keep their shardings."""
    fn = jax.jit(partial(srps.solve_fused, sf=sf, cfg=cfg))
    return fn(state, prob)


def step_sharded(state, prob, sf: int, cfg: SolverConfig):
    fn = jax.jit(partial(srps.srps_iteration, sf=sf, cfg=cfg))
    return fn(state, prob)


# ---------------------------------------------------------------------------
# 1D row-band sharding with the manual halo-exchange CG (product path for
# parallel/shard_cg.py; the depth solve communicates 2 halo refreshes +
# 2 scalar psums per CG iteration instead of whatever GSPMD chooses).
# ---------------------------------------------------------------------------


def make_mesh_1d(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), (axis,))


def shard_pytree_rows(tree, mesh: Mesh, axis: str = "x"):
    """Row-band placement: (…, h, w) leaves sharded over `axis` on the
    second-to-last dim; the flat image stack on its pixel (last) dim —
    contiguous pixel blocks ARE row bands; small leaves replicated."""

    def place(path, leaf):
        leaf = jnp.asarray(leaf)
        if _is_image_stack(path):
            spec = P(*([None] * (leaf.ndim - 1) + [axis]))
        elif _small_leaves(leaf):
            spec = P()
        else:
            spec = P(*([None] * (leaf.ndim - 2) + [axis, None]))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map_with_path(place, tree)


def estimate_depth_sharded(prob, mom, rho, dz, z, sf: int,
                           cfg: SolverConfig, mesh: Mesh, axis: str = "x"):
    """Depth solve routed through the manual shard_map halo-exchange CG.
    The operators are built under GSPMD; only the CG hot loop is
    hand-scheduled. ``cfg.cg_variant`` picks standard CG ("std") or the
    single-reduction Chronopoulos-Gear recurrence ("cgs"); Jacobi PCG
    follows the single-device preconditioned recurrence."""
    from . import shard_cg

    lam = cfg.lam
    op = srps.build_depth_operator(prob, mom, rho, dz, lam)
    rhs = srps.depth_rhs(op, prob, sf, lam)
    b_res = rhs - srps.depth_matvec(z, op, prob, sf, lam)
    kw = dict(sf=sf, lam=lam, tol=cfg.cg_tol, max_iter=cfg.cg_max_iter)
    if cfg.jacobi_preconditioner:
        if cfg.cg_variant == "cgs":
            raise ValueError("cg_variant='cgs' has no preconditioned "
                             "recurrence; use 'std' with Jacobi")
        invd = 1.0 / srps.depth_diag(op, prob, sf, lam)
        x, k, _ = shard_cg.cg_sharded_jacobi(
            mesh, axis, z, b_res, invd, op, prob.gm, prob.mask, prob.masks,
            **kw)
    else:
        cg_fn = (shard_cg.cg_sharded_cgs if cfg.cg_variant == "cgs"
                 else shard_cg.cg_sharded)
        x, k, _ = cg_fn(mesh, axis, z, b_res, op, prob.gm, prob.mask,
                        prob.masks, **kw)
    z_new = x * prob.mask
    energy = srps.depth_energy(z_new, op, prob, sf, lam)
    return z_new, energy, k


def srps_iteration_sharded(state, prob, sf: int, cfg: SolverConfig,
                           mesh: Mesh, axis: str = "x"):
    """One outer iteration with the depth CG on the manual sharded path.
    Lighting/albedo/moments/normals are plain GSPMD jnp."""
    from ..ops import gradients as gradops
    from ..ops.normals import normals_from_depth

    s = srps.estimate_lighting(prob, state.rho, state.N, state.s)
    mom = srps.s_moments(prob, s)
    rho = srps.estimate_albedo(prob, mom, state.N, state.rho)
    z, energy, cg_iters = estimate_depth_sharded(
        prob, mom, rho, state.dz, state.z, sf, cfg, mesh, axis)
    zx = gradops.grad_x(z, prob.gm)
    zy = gradops.grad_y(z, prob.gm)
    N, dz = normals_from_depth(z, zx, zy, prob.xx, prob.yy, prob.mask,
                               prob.fx, prob.fy)
    return srps.SRPSState(
        z=z, rho=rho, s=s, N=N, dz=dz, energy=energy,
        last_energy=state.energy, iteration=state.iteration + 1,
        cg_iters=cg_iters)


def solve_fused_sharded(state, prob, sf: int, cfg: SolverConfig,
                        mesh: Mesh, axis: str = "x"):
    """Whole outer loop on-device over the 1D row-band mesh (the sharded
    analog of srps.solve_fused). Inputs should be placed with
    :func:`shard_pytree_rows`."""
    trace_len = cfg.max_iterations + 2

    def cond(carry):
        st, _ = carry
        return ~srps.should_stop(st, cfg) | (st.iteration == 0)

    def body(carry):
        st, trace = carry
        st = srps_iteration_sharded(st, prob, sf, cfg, mesh, axis)
        trace = trace.at[st.iteration - 1].set(st.energy)
        return st, trace

    trace0 = jnp.full((trace_len,), jnp.nan, jnp.float32)
    return jax.lax.while_loop(cond, body, (state, trace0))


# ---------------------------------------------------------------------------
# Multi-chip dry run (driver hook)
# ---------------------------------------------------------------------------


def dryrun(n_devices: int, batch: Optional[int] = None) -> None:
    """Create an n-device mesh, jit the FULL solve step under real DP + SP
    shardings, and execute one step on tiny shapes."""
    from ..pre import preprocess_depth

    devs = jax.devices()
    assert len(devs) >= n_devices, f"need {n_devices} devices, have {len(devs)}"
    if batch is None:
        batch = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, data=batch)

    # Tiny problem sized so each spatial shard is a multiple of sf.
    sx, sy = mesh.shape["x"], mesh.shape["y"]
    sf, n, c = 2, 2, 3
    h = max(16, 2 * sf * sx)
    w = max(16, 2 * sf * sy)
    h += (-h) % (sf * sx)
    w += (-w) % (sf * sy)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - h / 2) ** 2 + (xx - w / 2) ** 2) < (0.45 * min(h, w)) ** 2
            ).astype(np.float32)
    K = [[300.0, 0, w / 2 - 0.5], [0, 300.0, h / 2 - 0.5], [0, 0, 1]]
    cfg = SolverConfig(max_iterations=2)

    probs, states = [], []
    for b in range(batch):
        I = rng.random((n, c, h, w)).astype(np.float32)
        z0 = (rng.random((n, h // sf, w // sf)).astype(np.float32) + 1.0) * 50.0
        zs, z_init = preprocess_depth(z0, h, w, cfg)
        pb = srps.build_problem(I, mask, K, sf, zs)
        probs.append(pb)
        states.append(srps.init_state(pb, z_init))

    from .batched import stack_problems, stack_states

    prob_b = stack_problems(probs)
    state_b = stack_states(states)
    prob_b = shard_pytree(prob_b, mesh, batched=True)
    state_b = shard_pytree(state_b, mesh, batched=True)

    step = jax.vmap(lambda st, pb: srps.srps_iteration(st, pb, sf, cfg))
    out = jax.jit(step)(state_b, prob_b)
    jax.block_until_ready(out)
    assert np.all(np.isfinite(np.asarray(out.energy))), "non-finite energy"

    # Also exercise the manual 1D row-band path (shard_map halo-exchange
    # CG + psum dots) — the product path behind --sharded.
    mesh1 = make_mesh_1d(n_devices)
    h1 = max(8 * n_devices, 2 * sf * n_devices)
    h1 += (-h1) % (8 * n_devices)
    w1 = 16
    mask1 = np.ones((h1, w1), np.float32)
    I1 = rng.random((n, c, h1, w1)).astype(np.float32)
    z01 = (rng.random((n, h1 // sf, w1 // sf)).astype(np.float32) + 1.0) * 50.0
    zs1, zi1 = preprocess_depth(z01, h1, w1, cfg)
    K1 = [[300.0, 0, w1 / 2 - 0.5], [0, 300.0, h1 / 2 - 0.5], [0, 0, 1]]
    pb1 = srps.build_problem(I1, mask1, K1, sf, zs1)
    st1 = srps.init_state(pb1, zi1)
    pb1 = shard_pytree_rows(pb1, mesh1)
    st1 = shard_pytree_rows(st1, mesh1)
    st1_out, trace1 = jax.jit(
        partial(solve_fused_sharded, sf=sf, cfg=cfg, mesh=mesh1))(st1, pb1)
    jax.block_until_ready(st1_out)
    assert np.isfinite(float(st1_out.energy)), "non-finite sharded-1d energy"

    # And the single-reduction (Chronopoulos-Gear) sharded CG variant —
    # one fused psum pair per iteration.
    cfg_cgs = SolverConfig(max_iterations=2, cg_variant="cgs")
    st2_out, _ = jax.jit(
        partial(solve_fused_sharded, sf=sf, cfg=cfg_cgs, mesh=mesh1))(st1, pb1)
    jax.block_until_ready(st2_out)
    assert np.isfinite(float(st2_out.energy)), "non-finite cgs-sharded energy"

    # Jacobi-preconditioned sharded CG: one fused (rz, rr) psum + one
    # <p,w> psum per iteration.
    cfg_j = SolverConfig(max_iterations=2, jacobi_preconditioner=True,
                         cg_max_iter=10)
    stj_out, _ = jax.jit(
        partial(solve_fused_sharded, sf=sf, cfg=cfg_j, mesh=mesh1))(st1, pb1)
    jax.block_until_ready(stj_out)
    assert np.isfinite(float(stj_out.energy)), (
        "non-finite jacobi-sharded energy")
