"""Depth-CG matvec fused with its dot product, for NVIDIA GPUs.

One Pallas kernel on the Triton route computes ``w = M p`` (the same
operator as ``models.srps.depth_matvec``) and, per program, the partial sum
of ``<p, w>``; XLA adds the partials. The CG iteration then reads ``p`` and
writes ``w`` once for both, where the plain XLA version makes separate
fusions for the matvec and the dot.

Each program covers a ``BH x BW`` tile (powers of two) and reads ``p`` and
the coefficient planes at the offsets the stencil and the sf x sf box
resample need through masked loads from device memory, so a neighbour may
lie in another tile; out-of-grid neighbours read as zero, which is the
zero-padding of the jnp shifts. The plain reference is
``models.srps.depth_matvec``; tests run this kernel in interpret mode
against it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BH, BW = 16, 64


def _kernel(v_ref, p11_ref, p12_ref, p13_ref, p22_ref, p23_ref, p33_ref,
            fx_ref, bx_ref, fy_ref, by_ref, ktw_ref, out_ref, part_ref, *,
            H, W, sf, lam):
    r = jnp.broadcast_to(pl.program_id(0) * BH + jnp.arange(BH)[:, None],
                         (BH, BW))
    c = jnp.broadcast_to(pl.program_id(1) * BW + jnp.arange(BW)[None, :],
                         (BH, BW))

    def ld(ref, di=0, dj=0, rows=None, cols=None):
        rr = r + di if rows is None else rows
        cc = c + dj if cols is None else cols
        m = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        return plgpu.load(ref.at[rr, cc], mask=m, other=0.0)

    vs = {}

    def v(di, dj):
        if (di, dj) not in vs:
            vs[(di, dj)] = ld(v_ref, di, dj)
        return vs[(di, dj)]

    # ops/gradients.py stencils, evaluated at offset (di, dj).
    def g(di, dj):
        return (ld(fx_ref, di, dj) * (v(di, dj + 1) - v(di, dj))
                + ld(bx_ref, di, dj) * (v(di, dj) - v(di, dj - 1)))

    def h(di, dj):
        return (ld(fy_ref, di, dj) * (v(di + 1, dj) - v(di, dj))
                + ld(by_ref, di, dj) * (v(di, dj) - v(di - 1, dj)))

    def t1(di, dj):
        return (ld(p11_ref, di, dj) * g(di, dj) + ld(p12_ref, di, dj)
                * h(di, dj) - ld(p13_ref, di, dj) * v(di, dj))

    def t2(di, dj):
        return (ld(p12_ref, di, dj) * g(di, dj) + ld(p22_ref, di, dj)
                * h(di, dj) - ld(p23_ref, di, dj) * v(di, dj))

    t3 = (ld(p13_ref) * g(0, 0) + ld(p23_ref) * h(0, 0)
          - ld(p33_ref) * v(0, 0))
    t1c, t2c = t1(0, 0), t2(0, 0)
    # Dx^T t1 + Dy^T t2 - t3
    gxt = (ld(fx_ref, 0, -1) * t1(0, -1) - ld(fx_ref) * t1c
           + ld(bx_ref) * t1c - ld(bx_ref, 0, 1) * t1(0, 1))
    gyt = (ld(fy_ref, -1, 0) * t2(-1, 0) - ld(fy_ref) * t2c
           + ld(by_ref) * t2c - ld(by_ref, 1, 0) * t2(1, 0))
    ata = gxt + gyt - t3
    # KT^T KT v = diag(KT^T KT) * (sum of v over the pixel's sf x sf tile)
    r0, c0 = r - r % sf, c - c % sf
    tile = sum(ld(v_ref, rows=r0 + a, cols=c0 + b)
               for a in range(sf) for b in range(sf))
    mv = ld(ktw_ref) * tile + lam * ata
    inside = (r < H) & (c < W)
    plgpu.store(out_ref.at[r, c], mv, mask=inside)
    part_ref[pl.program_id(0), pl.program_id(1)] = jnp.sum(
        jnp.where(inside, v(0, 0) * mv, 0.0))


def depth_matvec_dot(v, op, prob, sf: int, lam: float,
                     interpret: bool = False):
    """``(M v, <v, M v>)`` for the operator of ``models.srps.depth_matvec``.
    ``op``: a ``DepthOperator``; ``prob``: the ``SRPSProblem`` (its
    gradient masks and ``ktw``)."""
    H, W = v.shape
    grid = (pl.cdiv(H, BH), pl.cdiv(W, BW))
    gm = prob.gm
    out, part = pl.pallas_call(
        functools.partial(_kernel, H=H, W=W, sf=sf, lam=lam),
        grid=grid,
        out_shape=(jax.ShapeDtypeStruct((H, W), jnp.float32),
                   jax.ShapeDtypeStruct(grid, jnp.float32)),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend=None if interpret else "triton",
        interpret=interpret,
        name="depth_matvec_dot",
    )(v, op.P11, op.P12, op.P13, op.P22, op.P23, op.P33, gm.fwd_x, gm.bwd_x,
      gm.fwd_y, gm.bwd_y, prob.ktw)
    return out, jnp.sum(part)
