"""Manual shard_map grid-sharded CG with explicit halo exchange.

The GSPMD path (parallel/sharded.py) lets the XLA partitioner insert halo
exchanges for the +/-1 stencils automatically. This module is the
hand-scheduled alternative (BASELINE.json config 5: "1080p depth SR with
grid-sharded PCG (halo-exchange matvec over mesh)"), tuned to the minimum
possible communication:

  - the HR grid is partitioned over a 1D mesh axis in row bands (band
    heights multiples of sf, so the box-resample term never crosses a
    shard boundary; x-direction stencils are band-local by construction),
  - the static coefficient fields' one-row halos are exchanged ONCE per
    solve (a single stacked ppermute pair),
  - per CG iteration the only communication is ONE exchange of v's
    two-row halos (2 ppermutes) — the matvec is then evaluated on the
    one-row-extended domain so the transpose stencil needs no second
    exchange — plus 2 psums for the dot products.

Numerics mirror models.srps.depth_matvec / solve.cg exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import grid as gridops
from ..solve.cg import vdot as _vdot


def _halo_rows(v, k: int, axis_name: str):
    """Exchange k-row halos along the sharded row axis.

    Returns (top, bottom): k rows from the band above / below (zeros at
    the global boundary). 2 ppermutes.
    """
    n = lax.axis_size(axis_name)
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i, i - 1) for i in range(1, n)]
    top = lax.ppermute(v[-k:, :], axis_name, down)
    bottom = lax.ppermute(v[:k, :], axis_name, up)
    return top, bottom


def _grad_x_rows(v, fwd_x, bwd_x):
    """Dx on arbitrary row extent (within-row stencil)."""
    left = jnp.concatenate([v[:, 1:], jnp.zeros_like(v[:, :1])], 1)
    right = jnp.concatenate([jnp.zeros_like(v[:, :1]), v[:, :-1]], 1)
    return fwd_x * (left - v) + bwd_x * (v - right)


def _grad_x_t_rows(y, fwd_x, bwd_x):
    fy = fwd_x * y
    by = bwd_x * y
    fy_r = jnp.concatenate([jnp.zeros_like(fy[:, :1]), fy[:, :-1]], 1)
    by_l = jnp.concatenate([by[:, 1:], jnp.zeros_like(by[:, :1])], 1)
    return fy_r - fy + by - by_l


_FIELD_NAMES = ("P11", "P12", "P13", "P22", "P23", "P33",
                "fwd_x", "bwd_x", "fwd_y", "bwd_y")


def _extend_fields(P11, P12, P13, P22, P23, P33, fwd_x, bwd_x, fwd_y, bwd_y,
                   axis_name: str):
    """One-time static-field halo extension: stack the 10 coefficient
    fields so a SINGLE ppermute pair fetches every field's 1-row halo,
    then return a name->(h_b+2, w) dict for :func:`matvec_band`."""
    F = jnp.stack([P11, P12, P13, P22, P23, P33,
                   fwd_x, bwd_x, fwd_y, bwd_y])
    Fm = jnp.moveaxis(F, 0, 1)  # (h_b, 10, w): rows leading for halos
    topF, botF = _halo_rows(Fm.reshape(Fm.shape[0], -1), 1, axis_name)
    Fm_ext = jnp.concatenate(
        [topF.reshape(1, *Fm.shape[1:]), Fm,
         botF.reshape(1, *Fm.shape[1:])], 0)
    F_ext = jnp.moveaxis(Fm_ext, 1, 0)  # (10, h_b+2, w)
    return {k: F_ext[i] for i, k in enumerate(_FIELD_NAMES)}


def matvec_band(v, Fx, axis_name: str, sf: int, lam: float,
                masks_local, mask_local):
    """M v on one row band. Fx: dict of 1-row-extended fields (rows -1..h).

    v is the local band (h_b, w); communication: one 2-row halo exchange.
    """
    top2, bot2 = _halo_rows(v, 2, axis_name)
    v_ext = jnp.concatenate([top2, v, bot2], 0)  # rows -2 .. h+1
    pe = v_ext[1:-1]  # rows -1 .. h

    g_e = _grad_x_rows(pe, Fx["fwd_x"], Fx["bwd_x"])
    h_e = Fx["fwd_y"] * (v_ext[2:] - pe) + Fx["bwd_y"] * (pe - v_ext[:-2])

    t1_e = Fx["P11"] * g_e + Fx["P12"] * h_e - Fx["P13"] * pe
    t2_e = Fx["P12"] * g_e + Fx["P22"] * h_e - Fx["P23"] * pe
    t3_c = (Fx["P13"] * g_e + Fx["P23"] * h_e - Fx["P33"] * pe)[1:-1]

    dxt = _grad_x_t_rows(t1_e[1:-1], Fx["fwd_x"][1:-1], Fx["bwd_x"][1:-1])
    fy_e = Fx["fwd_y"] * t2_e
    by_e = Fx["bwd_y"] * t2_e
    hb = v.shape[0]
    # (Dy^T t2)(i) = fy(i-1) - fy(i) + by(i) - by(i+1), i = 0..hb-1;
    # fy_e index i+1 corresponds to row i.
    dyt = fy_e[0:hb] - fy_e[1:hb + 1] + by_e[1:hb + 1] - by_e[2:hb + 2]

    ata = dxt + dyt - t3_c
    kt = gridops.resample_masked(v, masks_local, sf)
    ktt = gridops.resample_masked_t(kt, mask_local, masks_local, sf)
    return ktt + lam * ata


def cg_sharded_cgs(
    mesh: Mesh,
    axis_name: str,
    x0, b_residual, op, gm, mask, masks,
    *, sf: int, lam: float, tol: float = 1e-9, max_iter: int = 100,
):
    """Chronopoulos-Gear single-reduction CG over row-band shards.

    Same contract as :func:`cg_sharded`, but the two data-dependent psums
    of standard CG (<p,Mp> must complete before the axpy that produces
    <r,r>) collapse into ONE fused psum of the (gamma, delta) pair per
    iteration — the latency win the CGS recurrence exists for at
    multi-chip scale. Per iteration: 1 two-row halo exchange of r
    (2 ppermutes) + 1 psum of a length-2 vector. Opt-in
    (``cg_variant='cgs'``): the alpha recurrence reorders rounding
    vs standard CG.
    """
    tol_sq = jnp.float32(tol) ** 2

    def body_fn(x0_l, b_l, P11, P12, P13, P22, P23, P33,
                fwd_x, bwd_x, fwd_y, bwd_y, mask_l, masks_l):
        Fx = _extend_fields(P11, P12, P13, P22, P23, P33,
                            fwd_x, bwd_x, fwd_y, bwd_y, axis_name)

        mv = functools.partial(
            matvec_band, Fx=Fx, axis_name=axis_name, sf=sf, lam=lam,
            masks_local=masks_l, mask_local=mask_l)

        def gd(r, w):
            # ONE fused collective for both CG scalars.
            return lax.psum(
                jnp.stack([_vdot(r, r), _vdot(w, r)]), axis_name)

        r = b_l
        w = mv(r)
        gamma_delta = gd(r, w)

        def cond(c):
            x, r, w, p, s, g_old, a_old, gdv, k = c
            return (gdv[0] > tol_sq) & (k <= max_iter)

        def body(c):
            x, r, w, p, s, g_old, a_old, gdv, k = c
            gamma, delta = gdv[0], gdv[1]
            k = k + 1
            beta = jnp.where(k == 1, 0.0,
                             gamma / jnp.where(g_old == 0.0, 1.0, g_old))
            denom = delta - beta * gamma / a_old
            alpha = gamma / jnp.where(denom == 0.0, 1.0, denom)
            p = r + beta * p
            s = w + beta * s
            x = x + alpha * p
            r = r - alpha * s
            w = mv(r)
            return x, r, w, p, s, gamma, alpha, gd(r, w), k

        x, r, w, p, s, _, _, gdv, k = lax.while_loop(
            cond, body,
            (x0_l, r, w, jnp.zeros_like(r), jnp.zeros_like(r),
             jnp.float32(1.0), jnp.float32(1.0), gamma_delta, jnp.int32(0)))
        return x, k, gdv[0]

    spec = P(axis_name, None)
    fn = jax.shard_map(
        body_fn, mesh=mesh,
        in_specs=(spec,) * 14,
        out_specs=(spec, P(), P()),
        check_vma=False,
    )
    return fn(x0, b_residual, op.P11, op.P12, op.P13, op.P22, op.P23,
              op.P33, gm.fwd_x, gm.bwd_x, gm.fwd_y, gm.bwd_y, mask, masks)


def cg_sharded_jacobi(
    mesh: Mesh,
    axis_name: str,
    x0, b_residual, invd, op, gm, mask, masks,
    *, sf: int, lam: float, tol: float = 1e-9, max_iter: int = 100,
):
    """Jacobi-preconditioned CG over row-band shards (``--sharded N
    --jacobi``).

    Identical recurrence and stopping semantics to the single-chip
    preconditioned ``solve.cg.conjugate_gradient`` (rz-driven beta/alpha,
    plain <r,r> stopping, the reference ``k <= max_iter`` quirk) — the
    trajectory matches the single-chip jacobi solve up to f32 reduction
    order. ``invd`` = 1 / diag(M), sharded like x0.

    Communication per iteration: 1 two-row halo exchange of p inside the
    matvec (2 ppermutes) + 1 psum of <p,w> + 1 fused psum of the
    (<r,z>, <r,r>) pair — z = invd*r is local, so both post-update dots
    share one collective.
    """
    tol_sq = jnp.float32(tol) ** 2

    def body_fn(x0_l, b_l, invd_l, P11, P12, P13, P22, P23, P33,
                fwd_x, bwd_x, fwd_y, bwd_y, mask_l, masks_l):
        Fx = _extend_fields(P11, P12, P13, P22, P23, P33,
                            fwd_x, bwd_x, fwd_y, bwd_y, axis_name)

        pdot = lambda a, b: lax.psum(_vdot(a, b), axis_name)
        mv = functools.partial(
            matvec_band, Fx=Fx, axis_name=axis_name, sf=sf, lam=lam,
            masks_local=masks_l, mask_local=mask_l)

        def rz_rr(r, z):
            # z is elementwise-local: ONE fused collective for both dots.
            return lax.psum(
                jnp.stack([_vdot(r, z), _vdot(r, r)]), axis_name)

        def cond(c):
            x, r, z, p, rz0, rz1, rr, k = c
            return (rr > tol_sq) & (k <= max_iter)

        def body(c):
            x, r, z, p, rz0, rz1, rr, k = c
            k = k + 1
            beta = jnp.where(k == 1, 0.0,
                             rz1 / jnp.where(rz0 == 0, 1.0, rz0))
            p = z + beta * p
            w = mv(p)
            pw = pdot(p, w)
            alpha = rz1 / jnp.where(pw == 0, 1.0, pw)
            x = x + alpha * p
            r = r - alpha * w
            z = invd_l * r
            pair = rz_rr(r, z)
            return x, r, z, p, rz1, pair[0], pair[1], k

        r = b_l
        z = invd_l * r
        pair0 = rz_rr(r, z)
        x, r, z, p, rz0, rz1, rr, k = lax.while_loop(
            cond, body,
            (x0_l, r, z, jnp.zeros_like(r), jnp.float32(0.0),
             pair0[0], pair0[1], jnp.int32(0)))
        return x, k, rr

    spec = P(axis_name, None)
    fn = jax.shard_map(
        body_fn, mesh=mesh,
        in_specs=(spec,) * 15,
        out_specs=(spec, P(), P()),
        check_vma=False,
    )
    return fn(x0, b_residual, invd, op.P11, op.P12, op.P13, op.P22,
              op.P23, op.P33, gm.fwd_x, gm.bwd_x, gm.fwd_y, gm.bwd_y,
              mask, masks)


def cg_sharded(
    mesh: Mesh,
    axis_name: str,
    x0, b_residual, op, gm, mask, masks,
    *, sf: int, lam: float, tol: float = 1e-9, max_iter: int = 100,
):
    """Warm-started reference-semantics CG over row-band shards.

    All (h, w) args sharded P(axis_name, None); (h / n_shards) % sf == 0.
    Returns (x, iterations, final squared residual).
    """
    tol_sq = jnp.float32(tol) ** 2

    def body_fn(x0_l, b_l, P11, P12, P13, P22, P23, P33,
                fwd_x, bwd_x, fwd_y, bwd_y, mask_l, masks_l):
        Fx = _extend_fields(P11, P12, P13, P22, P23, P33,
                            fwd_x, bwd_x, fwd_y, bwd_y, axis_name)

        pdot = lambda a, b: lax.psum(_vdot(a, b), axis_name)
        mv = functools.partial(
            matvec_band, Fx=Fx, axis_name=axis_name, sf=sf, lam=lam,
            masks_local=masks_l, mask_local=mask_l)

        def cond(c):
            x, r, p, r0, r1, k = c
            return (r1 > tol_sq) & (k <= max_iter)

        def body(c):
            x, r, p, r0, r1, k = c
            k = k + 1
            beta = jnp.where(k == 1, 0.0, r1 / jnp.where(r0 == 0, 1.0, r0))
            p = r + beta * p
            w = mv(p)
            pw = pdot(p, w)
            alpha = r1 / jnp.where(pw == 0, 1.0, pw)
            x = x + alpha * p
            r = r - alpha * w
            return x, r, p, r1, pdot(r, r), k

        r1 = pdot(b_l, b_l)
        x, r, p, r0, r1, k = lax.while_loop(
            cond, body,
            (x0_l, b_l, jnp.zeros_like(b_l), jnp.float32(0.0), r1,
             jnp.int32(0)))
        return x, k, r1

    spec = P(axis_name, None)
    fn = jax.shard_map(
        body_fn, mesh=mesh,
        in_specs=(spec,) * 14,
        out_specs=(spec, P(), P()),
        check_vma=False,
    )
    return fn(x0, b_residual, op.P11, op.P12, op.P13, op.P22, op.P23,
              op.P33, gm.fwd_x, gm.bwd_x, gm.fwd_y, gm.bwd_y, mask, masks)
