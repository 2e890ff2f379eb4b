"""Matrix-free conjugate gradient as a fully on-device ``lax.while_loop``.

The reference CG (devicecalls.cu:229-279) performs **three blocking
host<->device scalar transfers per iteration** (cublasSdot results drive
alpha/beta on the host). Here the whole loop — matvec, axpys and the dot
products — stays inside one compiled ``while_loop``: zero host round-trips,
with the reductions fused by XLA (and turned into ``psum`` collectives when
the operands are sharded over a mesh).

Semantics match the reference exactly:
  - warm start: the caller passes the residualised rhs ``b - M x0`` and the
    current iterate ``x0``; CG accumulates a correction onto ``x0``
    (devicecalls.cu:405,424,758),
  - stop when the *squared* residual norm drops to ``tol`` (reference
    compares ``r1 > tol*tol`` with tol=1e-9) or after ``max_iter`` + 1
    iterations (the reference's ``k <= max_iter`` with post-increment
    admits one extra iteration; we reproduce it).

An optional diagonal (Jacobi) preconditioner is supported — the reference
ships a *dead* ILU0-PCG (devicecalls.cu:285-374) that is never called; we do
not replicate dead code (SURVEY.md section 7 "quirks NOT to replicate") but
provide Jacobi as the data-parallel preconditioner.
"""

from __future__ import annotations


from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

HI = jax.lax.Precision.HIGHEST


class CGResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array  # int32 — number of iterations executed
    residual_sq: jax.Array  # final squared residual norm


def vdot(x, y):
    """f32 dot product of two arrays, summed row by row and then over the
    rows. XLA's CPU ``dot`` of two long vectors accumulates sequentially
    (relative error ~1e-3 at 1.2M elements); two levels keep each
    sequential run to one row or one column of row sums."""
    x, y = x.astype(jnp.float32), y.astype(jnp.float32)
    if x.ndim < 2:
        return jnp.vdot(x, y, precision=HI)
    rows = jnp.einsum("...w,...w->...", x, y, precision=HI).ravel()
    return jnp.vdot(rows, jnp.ones_like(rows), precision=HI)


def _tree_vdot(a, b):
    """Masked-exact dot product over a pytree of arrays (float32 accum)."""
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    return sum(vdot(x, y) for x, y in zip(leaves_a, leaves_b))


def conjugate_gradient(
    matvec: Callable,
    b_residual,
    x0,
    *,
    tol: float = 1e-9,
    max_iter: int = 100,
    precond: Optional[Callable] = None,
    dot: Callable = _tree_vdot,
    matvec_dot: Optional[Callable] = None,
) -> CGResult:
    """Solve ``M (x - x0) = b_residual`` and return ``x``.

    Args:
      matvec: closure computing ``M v`` (M symmetric positive definite).
      b_residual: residualised rhs ``b - M x0`` (pytree like ``x0``).
      x0: warm-start iterate.
      tol: compared against the *squared* residual (reference convention).
      max_iter: reference-style cap (runs at most ``max_iter + 1`` iters).
      precond: optional closure ``z = P^{-1} r``.
      dot: inner product (swap for a ``psum``-reducing version under
        ``shard_map``).
      matvec_dot: optional closure returning ``(M p, <p, M p>)`` in one
        call (a fused kernel); by default ``matvec`` then ``dot``.
    """
    tol_sq = jnp.asarray(tol, jnp.float32) ** 2
    if matvec_dot is None:
        def matvec_dot(p):
            w = matvec(p)
            return w, dot(p, w)

    if precond is None:
        def body(state):
            x, r, p, r0, r1, k = state
            k = k + 1
            beta = jnp.where(k == 1, 0.0, r1 / jnp.where(r0 == 0, 1.0, r0))
            p = jax.tree_util.tree_map(lambda ri, pi: ri + beta * pi, r, p)
            w, pw = matvec_dot(p)
            alpha = r1 / jnp.where(pw == 0, 1.0, pw)
            x = jax.tree_util.tree_map(lambda xi, pi: xi + alpha * pi, x, p)
            r = jax.tree_util.tree_map(lambda ri, wi: ri - alpha * wi, r, w)
            return x, r, p, r1, dot(r, r), k

        def cond(state):
            _, _, _, _, r1, k = state
            return (r1 > tol_sq) & (k <= max_iter)

        r = b_residual
        p = jax.tree_util.tree_map(jnp.zeros_like, r)
        r1 = dot(r, r)
        state = (x0, r, p, jnp.float32(0.0), r1, jnp.int32(0))
        x, r, _, _, r1, k = jax.lax.while_loop(cond, body, state)
        return CGResult(x, k, r1)

    # Preconditioned variant: standard PCG with rz = <r, P^-1 r>.
    def pbody(state):
        x, r, z, p, rz0, rz1, rr, k = state
        k = k + 1
        beta = jnp.where(k == 1, 0.0, rz1 / jnp.where(rz0 == 0, 1.0, rz0))
        p = jax.tree_util.tree_map(lambda zi, pi: zi + beta * pi, z, p)
        w, pw = matvec_dot(p)
        alpha = rz1 / jnp.where(pw == 0, 1.0, pw)
        x = jax.tree_util.tree_map(lambda xi, pi: xi + alpha * pi, x, p)
        r = jax.tree_util.tree_map(lambda ri, wi: ri - alpha * wi, r, w)
        z = precond(r)
        return x, r, z, p, rz1, dot(r, z), dot(r, r), k

    def pcond(state):
        _, _, _, _, _, _, rr, k = state
        return (rr > tol_sq) & (k <= max_iter)

    r = b_residual
    z = precond(r)
    p = jax.tree_util.tree_map(jnp.zeros_like, z)
    state = (x0, r, z, p, jnp.float32(0.0), dot(r, z), dot(r, r), jnp.int32(0))
    x, r, _, _, _, _, rr, k = jax.lax.while_loop(pcond, pbody, state)
    return CGResult(x, k, rr)
