"""SRmeetsPS model: the three alternating least-squares estimators.

This is a ground-up matrix-free redesign of the reference solver
(SRPS.cu:276-335 + devicecalls.cu), exploiting structure the CUDA version
leaves on the table:

* **Lighting** (devicecalls.cu:408-444): the reference solves each of the
  ``n*c`` 4x4 normal-equation systems with sparse CG, incl. 16 device-pointer
  round-trips per system. Here: fused multiply-and-reduce passes build all
  Gram matrices / right-hand sides at once, then one closed-form batched
  4x4 inverse. Note
  ``A^T A`` is per-channel only (independent of the image index), so just
  ``c`` Gram matrices are formed.

* **Albedo** (devicecalls.cu:497-548): the reference expands per-image
  shading into a ``(npix*n) x npix`` sparse matrix and runs CG — but that
  operator is *diagonal* per pixel, so the normal equations have the
  closed-form per-pixel solution ``rho = sum_i sh_i I_i / sum_i sh_i^2``
  (CG's converged fixed point). Both sums collapse onto the lighting Gram
  ``G_c = sum_i s s^T`` and the correlation images ``J = sum_i s_k I_i`` —
  no ``(n, h, w)`` intermediate at all.

* **Depth** (devicecalls.cu:636-786): the reference materialises the
  ``(npix*n*c) x npix`` sparse operator ``A = [diag(A1)Dx + diag(A2)Dy -
  diag(A3)]`` and its explicit ``A^T A`` via spgemm chains, then runs CG
  with SpMV over ~5*n*c*npix nonzeros per iteration. Because the row blocks
  share the two stencils ``Dx, Dy``, the normal matrix collapses to

      A^T A = Dx' P11 Dx + Dx' P12 Dy + Dy' P12 Dx + Dy' P22 Dy
            - Dx' P13 - P13 Dx - Dy' P23 - P23 Dy + P33

  with six precomputable per-pixel Gram coefficient fields ``P..`` (sums
  over channels x images of products of ``A1, A2, A3``), which themselves
  reduce to the tiny per-channel lighting Gram ``G_c`` and closed-form
  combinations with ``xx, yy`` — the ``(c, n, h, w)`` coefficient tensors
  are never materialised. Each CG iteration is then O(npix): two 2-point
  stencils, a handful of fused elementwise ops, and one box resample —
  instead of the reference's giant SpMV. The rhs and the energy use the
  same collapse (correlation fields ``QB1..QB3`` and scalar moments).

All state lives on dense ``(h, w)`` grids, zeroed outside the mask, so every
reduction is masked-exact and all shapes are static for XLA.
"""

from __future__ import annotations


from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SolverConfig
from ..ops import gradients as gradops
from ..ops import grid as gridops
from ..ops.gradients import GradientMasks
from ..ops.normals import normals_from_depth
from ..solve.cg import conjugate_gradient, vdot

HI = lax.Precision.HIGHEST


class SRPSProblem(NamedTuple):
    """Static problem data (device arrays). Shapes: I (c, n, h*w) —
    channel-major AND pixel-flattened so the per-channel image
    contractions (s_moments J, lighting ATb) lower to c-batched matmuls
    with no per-iteration relayout of the image stack; mask (h,w); masks
    (h/sf, w/sf); z0s like masks; xx/yy (h,w); SI2 (c,h,w); z0t/ktw (h,w)
    precomputed outer-iteration invariants (KT^T z0s and the KT^T KT
    weight field), built once here rather than inside the solve's while
    loop. ``build_problem`` takes (n,c,h,w) input (the loader layout) and
    transposes/flattens once."""

    I: jax.Array
    mask: jax.Array
    masks: jax.Array
    z0s: jax.Array
    xx: jax.Array
    yy: jax.Array
    fx: jax.Array
    fy: jax.Array
    gm: GradientMasks
    SI2: jax.Array  # sum_i I^2, per channel — energy constant term
    z0t: jax.Array  # KT^T z0s (h,w) — depth rhs term, solve-invariant
    ktw: jax.Array  # mask * up(masks) / sf^4 — diag(KT^T KT) (h,w)


class SRPSState(NamedTuple):
    """Optimisation state. z (h,w); rho (c,h,w); s (n,c,4); N (4,h,w);
    dz (h,w); energy/last_energy scalars; iteration counter."""

    z: jax.Array
    rho: jax.Array
    s: jax.Array
    N: jax.Array
    dz: jax.Array
    energy: jax.Array
    last_energy: jax.Array
    iteration: jax.Array
    cg_iters: jax.Array


# ---------------------------------------------------------------------------
# Problem / state construction
# ---------------------------------------------------------------------------


def build_problem(I, mask, K, sf: int, z0s, image_dtype: str = "float32") -> SRPSProblem:
    """Assemble the device-side problem container.

    Args:
      I: (n, c, h, w) images (will be zeroed outside the mask — the
         reference gathers only masked pixels, SRPS.cu:222-234).
      mask: (h, w) binary HR mask.
      K: (3, 3) intrinsics (fx=K[0,0], fy=K[1,1], cx=K[0,2], cy=K[1,2]).
      sf: integer scale factor.
      z0s: (h/sf, w/sf) preprocessed LR depth (masked).
      image_dtype: "float32" (default) or "bfloat16" — bf16 halves the
        memory traffic of the two per-iteration passes over I (reductions
        still accumulate in f32) at a small accuracy cost.
    """
    # Binarize with the reference's imask predicate (mask != 0). Note the
    # reference is internally inconsistent for non-binary (anti-aliased)
    # masks: imask uses != 0 (SRPS.cu:152-156) while the masked gathers'
    # copy_if uses an is-one predicate (devicecalls.cuh:19-24) and the LR
    # mask is D @ raw-mask thresholded at < 1 (SRPS.cu:110-111). We
    # binarize first, which makes the two predicates agree; for genuinely
    # binary masks (all shipped datasets) the behaviours are identical.
    mask = (jnp.asarray(mask) != 0).astype(jnp.float32)
    h, w = mask.shape
    I = jnp.transpose(jnp.asarray(I, jnp.float32), (1, 0, 2, 3)) * mask
    if image_dtype == "bfloat16":
        I = I.astype(jnp.bfloat16)
    masks = gridops.lr_mask(mask, sf)
    xx, yy = gridops.meshgrid_camera(h, w, float(K[0][2]), float(K[1][2]))
    xx = xx * mask
    yy = yy * mask
    SI2 = jnp.einsum(
        "cnhw->chw", (I * I).astype(jnp.float32))
    z0s = jnp.asarray(z0s, jnp.float32) * masks
    c_, n_ = I.shape[:2]
    return SRPSProblem(
        I=I.reshape(c_, n_, h * w),
        mask=mask,
        masks=masks,
        z0s=z0s,
        xx=xx,
        yy=yy,
        fx=jnp.float32(K[0][0]),
        fy=jnp.float32(K[1][1]),
        gm=GradientMasks.from_mask(mask),
        SI2=SI2,
        z0t=gridops.resample_masked_t(z0s, mask, masks, sf),
        ktw=gridops.make_ktw(mask, masks, sf),
    )


def init_state(prob: SRPSProblem, z_init) -> SRPSState:
    """Initial state mirroring SRPS.cu:206-270: s = [0,0,-1,0] per
    (image, channel), rho = 0.5 on the mask, normals from the initial z."""
    h, w = prob.mask.shape
    c, n = prob.I.shape[:2]
    s = jnp.zeros((n, c, 4), jnp.float32).at[:, :, 2].set(-1.0)
    rho = jnp.broadcast_to(0.5 * prob.mask, (c, h, w))
    z = jnp.asarray(z_init, jnp.float32) * prob.mask
    zx = gradops.grad_x(z, prob.gm)
    zy = gradops.grad_y(z, prob.gm)
    N, dz = normals_from_depth(z, zx, zy, prob.xx, prob.yy, prob.mask, prob.fx, prob.fy)
    return SRPSState(
        z=z,
        rho=rho,
        s=s,
        N=N,
        dz=dz,
        energy=jnp.float32(jnp.nan),
        last_energy=jnp.float32(jnp.nan),
        iteration=jnp.int32(0),
        cg_iters=jnp.int32(0),
    )


# ---------------------------------------------------------------------------
# Lighting estimation
# ---------------------------------------------------------------------------


def estimate_lighting(prob: SRPSProblem, rho, N, s_prev=None) -> jax.Array:
    """Per-(image, channel) first-order SH lighting least squares.

    Minimises ||diag(rho_c) N s - I_ic||^2 over masked pixels. The
    reference's warm-started exact-tolerance CG on the 4x4 normal equations
    converges to the same solution (devicecalls.cu:408-444). For a
    degenerate channel (e.g. rho driven to 0 everywhere: ATA singular) the
    reference's CG sees a zero residual at the warm start and never updates
    s — so when the direct solve produces non-finite values, ``s_prev`` is
    kept instead.
    """
    h, w = prob.mask.shape
    c = prob.I.shape[0]
    # Work in flat pixel space, on the image stack's own (c, n, h*w)
    # layout; the flat forms are shared (CSE) with estimate_albedo inside
    # the jitted outer iteration.
    rf = rho.reshape(c, h * w)
    Nf = N.reshape(4, h * w)
    # ATA[c,a,b] = sum_p rho_c^2 N_a N_b — ten unique masked reductions,
    # unrolled over the tiny (a, b) axes so XLA fuses them into one pass
    # over rho/N (materialising T = rho*N costs an extra 2x c x npix
    # round-trip).
    R2 = rf * rf  # (c,P)
    ata = {}
    for a in range(4):
        for b in range(a, 4):
            ata[(a, b)] = jnp.sum(R2 * (Nf[a] * Nf[b])[None, :], axis=-1)
    ATA = jnp.stack([
        jnp.stack([ata[(min(a, b), max(a, b))] for b in range(4)], axis=-1)
        for a in range(4)
    ], axis=-2)  # (c,4,4)
    # ATb[c,n,a] = <rho_c N_a, I_cn>: a multiply-and-reduce over the
    # pixels, which XLA fuses into one pass over the image stack. As a
    # (4,P)@(P,n) matmul it is a GEMM with a 1.2M-long contraction, which
    # cuBLAS runs in ~36 ms at f32 precision (960x1280, H100) and sums
    # less accurately than a tree reduction.
    T = rf[:, None, :] * Nf[None]  # (c,4,P) masked
    ATb = jnp.sum(T[:, None] * prob.I[:, :, None].astype(jnp.float32),
                  axis=-1)  # (c,n,4)
    # Closed-form 4x4 solve (adjugate/Cramer): the cofactor expansion is
    # ~60 elementwise ops on (c,)-vectors that fuse into one kernel, where
    # a batched jnp.linalg.solve would launch an LU per matrix. A singular
    # ATA (degenerate channel) yields det=0 -> inf/nan, caught by the
    # s_prev retention below.
    inv = _inv4(ATA)  # (c,4,4)
    sol = jnp.einsum("cab,cnb->nca", inv, ATb, precision=HI)
    if s_prev is None:
        return sol
    ok = jnp.all(jnp.isfinite(sol), axis=-1, keepdims=True)
    return jnp.where(ok, sol, s_prev)


def _inv4(A):
    """Batched explicit 4x4 inverse via the 2x2-minor Laplace expansion
    (adjugate / det); elementwise over leading batch dims."""
    a = [[A[..., i, j] for j in range(4)] for i in range(4)]
    s0 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    s1 = a[0][0] * a[1][2] - a[0][2] * a[1][0]
    s2 = a[0][0] * a[1][3] - a[0][3] * a[1][0]
    s3 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    s4 = a[0][1] * a[1][3] - a[0][3] * a[1][1]
    s5 = a[0][2] * a[1][3] - a[0][3] * a[1][2]
    c5 = a[2][2] * a[3][3] - a[2][3] * a[3][2]
    c4 = a[2][1] * a[3][3] - a[2][3] * a[3][1]
    c3 = a[2][1] * a[3][2] - a[2][2] * a[3][1]
    c2 = a[2][0] * a[3][3] - a[2][3] * a[3][0]
    c1 = a[2][0] * a[3][2] - a[2][2] * a[3][0]
    c0 = a[2][0] * a[3][1] - a[2][1] * a[3][0]
    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    r = 1.0 / det
    adj = [
        [a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3,
         -a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3,
         a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3,
         -a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3],
        [-a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1,
         a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1,
         -a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1,
         a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1],
        [a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0,
         -a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0,
         a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0,
         -a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0],
        [-a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0,
         a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0,
         -a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0,
         a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0],
    ]
    return jnp.stack(
        [jnp.stack([adj[i][j] * r for j in range(4)], axis=-1)
         for i in range(4)], axis=-2)


# ---------------------------------------------------------------------------
# Shared s-moment computation (feeds albedo AND depth)
# ---------------------------------------------------------------------------


class SMoments(NamedTuple):
    G: jax.Array  # (c, 4, 4)   sum_i s_ic s_ic^T
    J: jax.Array  # (c, 4, h, w) sum_i s[i,c,k] * I[i,c]


def s_moments(prob: SRPSProblem, s) -> SMoments:
    h, w = prob.mask.shape
    c = prob.I.shape[0]
    G = jnp.einsum("nck,ncl->ckl", s, s, precision=HI)
    # c-batched (4,n)@(n,P) matmul on the pre-flattened channel-major
    # layout — one streaming pass over I — then one reshape of the
    # (c,4,P) result to image space, so every consumer's J[i, k] read is
    # a contiguous plane.
    sx = jnp.moveaxis(s, 0, 1)  # (n,c,k) -> (c,n,k)
    # s stays f32 even under the bf16 image preset: quantising the tiny s
    # operand buys no bandwidth (it is (x,n,4)) but compounds the image
    # quantisation. The mixed f32 x bf16 dot keeps the halved I-stream
    # reads (the convert fuses into the dot's operand read, as in the
    # lighting ATb pass).
    J = jnp.einsum(
        "cnk,cnp->ckp", sx, prob.I,
        precision=HI, preferred_element_type=jnp.float32,
    ).reshape(c, 4, h, w)
    return SMoments(G, J)


# ---------------------------------------------------------------------------
# Albedo estimation
# ---------------------------------------------------------------------------


def estimate_albedo(prob: SRPSProblem, mom: SMoments, N, rho_prev) -> jax.Array:
    """Closed-form per-pixel albedo (the diagonal normal equations'
    exact solution; devicecalls.cu:497-548). Where no image constrains a
    pixel (zero diagonal) the previous albedo is kept — matching CG's
    zero-correction behaviour on a zero row."""
    # num_c = sum_k N_k J_ck, den_c = sum_kl G_ckl N_k N_l — k/l are tiny
    # static axes, so unroll into elementwise sums XLA fuses into a single
    # pass (einsums with (h, w) free dims lower to transposing dots).
    # J's (c,4,h,w) layout makes every J[i, k] read a contiguous plane.
    c = mom.J.shape[0]
    num = jnp.stack([
        sum(N[k] * mom.J[i, k] for k in range(4)) for i in range(c)])
    NN = {(k, l): N[k] * N[l] for k in range(4) for l in range(k, 4)}
    den = jnp.stack([
        sum((1.0 if k == l else 2.0) * mom.G[i, k, l] * NN[(k, l)]
            for k in range(4) for l in range(k, 4))
        for i in range(c)])
    rho = jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), rho_prev)
    return rho * prob.mask


# ---------------------------------------------------------------------------
# Depth estimation
# ---------------------------------------------------------------------------


class DepthOperator(NamedTuple):
    """Per-outer-iteration collapsed coefficient fields (all (h, w))."""

    P11: jax.Array
    P12: jax.Array
    P13: jax.Array
    P22: jax.Array
    P23: jax.Array
    P33: jax.Array
    QB1: jax.Array
    QB2: jax.Array
    QB3: jax.Array
    const: jax.Array  # scalar: sum B^2


def build_depth_operator(
    prob: SRPSProblem, mom: SMoments, rho, dz, lam: float
) -> DepthOperator:
    """Collapse sum over (c, i) of the per-row coefficients into Gram fields.

    With u1 = fx s1 - xx s3, u2 = fy s2 - yy s3, u3 = s3 and
    A_k = (rho_c/dz) u_k (devicecalls.cu:583-599), all pairwise sums over
    images reduce to the s-Gram G_c; the I-correlations reduce to J.
    """
    fx, fy, xx, yy = prob.fx, prob.fy, prob.xx, prob.yy
    G = mom.G
    w1 = rho / dz  # (c,h,w)
    w2 = w1 * w1
    w1r = w1 * rho  # rho^2 / dz

    # The per-channel scalar Gram entries G_c[k,l] factor OUT of every sum
    # over channels, so each P/QB field is an elementwise combination of
    # xx/yy with a handful of channel-contracted moment *fields*:
    #   A_kl = sum_c w2_c G_c[k,l]      (for the quadratic P fields)
    #   D_k3 = sum_c (w1 rho)_c G_c[k,3] (for the rho*s4 part of QB)
    #   B_k  = sum_c w1_c J_kc           (for the I-correlation part of QB)
    # c is tiny (1 or 3) and static, so the contractions are unrolled into
    # scalar-weighted elementwise sums that XLA fuses into single passes —
    # einsum forms with (h, w) as free/batch dims ("chw,ck->khw",
    # "chw,ckhw->khw") would lower to transposing dot_generals instead.
    c = w1.shape[0]
    h, w = prob.mask.shape
    A00 = sum(w2[i] * G[i, 0, 0] for i in range(c))
    A01 = sum(w2[i] * G[i, 0, 1] for i in range(c))
    A02 = sum(w2[i] * G[i, 0, 2] for i in range(c))
    A11 = sum(w2[i] * G[i, 1, 1] for i in range(c))
    A12 = sum(w2[i] * G[i, 1, 2] for i in range(c))
    A22 = sum(w2[i] * G[i, 2, 2] for i in range(c))
    D03 = sum(w1r[i] * G[i, 0, 3] for i in range(c))
    D13 = sum(w1r[i] * G[i, 1, 3] for i in range(c))
    D23 = sum(w1r[i] * G[i, 2, 3] for i in range(c))
    B0 = sum(w1[i] * mom.J[i, 0] for i in range(c))
    B1 = sum(w1[i] * mom.J[i, 1] for i in range(c))
    B2 = sum(w1[i] * mom.J[i, 2] for i in range(c))

    P11 = fx * fx * A00 - 2.0 * fx * xx * A02 + xx * xx * A22
    P22 = fy * fy * A11 - 2.0 * fy * yy * A12 + yy * yy * A22
    P33 = A22
    P12 = fx * fy * A01 - fx * yy * A02 - fy * xx * A12 + xx * yy * A22
    P13 = fx * A02 - xx * A22
    P23 = fy * A12 - yy * A22

    QB3 = B2 - D23
    QB1 = fx * (B0 - D03) - xx * QB3
    QB2 = fy * (B1 - D13) - yy * QB3
    const = (jnp.sum(prob.SI2) - 2.0 * jnp.sum(rho * mom.J[:, 3])
             + jnp.vdot(jnp.sum(rho * rho, axis=(1, 2)), G[:, 3, 3],
                        precision=HI))

    return DepthOperator(P11, P12, P13, P22, P23, P33, QB1, QB2, QB3, const)


def depth_matvec(v, op: DepthOperator, prob: SRPSProblem, sf: int, lam: float):
    """``M v = KT^T KT v + lam * A^T A v`` — O(npix), fully fused."""
    gm = prob.gm
    g = gradops.grad_x(v, gm)
    h = gradops.grad_y(v, gm)
    t1 = op.P11 * g + op.P12 * h - op.P13 * v
    t2 = op.P12 * g + op.P22 * h - op.P23 * v
    t3 = op.P13 * g + op.P23 * h - op.P33 * v
    ata = gradops.grad_x_t(t1, gm) + gradops.grad_y_t(t2, gm) - t3
    kt = gridops.resample_masked(v, prob.masks, sf)
    ktt = gridops.resample_masked_t(kt, prob.mask, prob.masks, sf)
    return ktt + lam * ata


def depth_matvec_dot(v, op: DepthOperator, prob: SRPSProblem, sf: int,
                     lam: float):
    """``(M v, <v, M v>)``: on a GPU one Pallas kernel
    (solve/matvec_gpu.py), elsewhere :func:`depth_matvec` and a dot. The
    branch is chosen where the program is lowered."""
    from ..solve.matvec_gpu import depth_matvec_dot as gpu_kernel

    def plain(v, op, prob):
        w = depth_matvec(v, op, prob, sf, lam)
        return w, vdot(v, w)

    return lax.platform_dependent(
        v, op, prob, default=plain,
        cuda=lambda v, op, prob: gpu_kernel(v, op, prob, sf, lam))


def depth_rhs(op: DepthOperator, prob: SRPSProblem, sf: int, lam: float):
    """``rhs = KT^T z0s + lam * A^T B`` (devicecalls.cu:743-745)."""
    atb = (
        gradops.grad_x_t(op.QB1, prob.gm)
        + gradops.grad_y_t(op.QB2, prob.gm)
        - op.QB3
    )
    return prob.z0t + lam * atb


def depth_diag(op: DepthOperator, prob: SRPSProblem, sf: int, lam: float):
    """Diagonal of M, for Jacobi preconditioning."""
    gm = prob.gm
    sigx = gm.bwd_x - gm.fwd_x  # Dx(p,p)
    sigy = gm.bwd_y - gm.fwd_y
    from ..ops.gradients import _shift_left, _shift_right, _shift_up, _shift_down

    dxx = (
        op.P11 * (gm.fwd_x + gm.bwd_x)
        + _shift_right(op.P11 * gm.fwd_x)
        + _shift_left(op.P11 * gm.bwd_x)
    )
    dyy = (
        op.P22 * (gm.fwd_y + gm.bwd_y)
        + _shift_down(op.P22 * gm.fwd_y)
        + _shift_up(op.P22 * gm.bwd_y)
    )
    cross = 2.0 * op.P12 * sigx * sigy
    lin = -2.0 * op.P13 * sigx - 2.0 * op.P23 * sigy
    ata_diag = dxx + dyy + cross + lin + op.P33
    d = prob.ktw + lam * ata_diag  # ktw IS diag(KT^T KT) on the HR grid
    return jnp.where(d > 0, d, 1.0)


def estimate_depth(
    prob: SRPSProblem,
    mom: SMoments,
    rho,
    dz,
    z,
    sf: int,
    cfg: SolverConfig,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Warm-started CG depth solve + energy (devicecalls.cu:636-786).

    Returns (z_new, energy, cg_iterations).
    """
    lam = cfg.lam
    op = build_depth_operator(prob, mom, rho, dz, lam)
    matvec = partial(depth_matvec, op=op, prob=prob, sf=sf, lam=lam)
    b_res = depth_rhs(op, prob, sf, lam) - matvec(z)
    precond = None
    if cfg.jacobi_preconditioner:
        diag = depth_diag(op, prob, sf, lam)
        precond = lambda r: r / diag
    res = conjugate_gradient(
        matvec, b_res, z, tol=cfg.cg_tol, max_iter=cfg.cg_max_iter,
        precond=precond,
        matvec_dot=partial(depth_matvec_dot, op=op, prob=prob, sf=sf,
                           lam=lam))
    z_new = res.x * prob.mask
    energy = depth_energy(z_new, op, prob, sf, lam)
    return z_new, energy, res.iterations


def depth_energy(z_new, op: DepthOperator, prob: SRPSProblem, sf: int,
                 lam: float):
    """|| KT z - z0s ||^2 + lam || A z - B ||^2 via the Gram-field collapse
    (devicecalls.cu:762-767 computes the same quantity with two SpMVs)."""
    g = gradops.grad_x(z_new, prob.gm)
    h = gradops.grad_y(z_new, prob.gm)
    e_data = (
        jnp.sum(op.P11 * g * g + op.P22 * h * h + op.P33 * z_new * z_new)
        + 2.0 * jnp.sum(op.P12 * g * h - op.P13 * g * z_new - op.P23 * h * z_new)
        - 2.0 * jnp.sum(op.QB1 * g + op.QB2 * h - op.QB3 * z_new)
        + op.const
    )
    r1 = gridops.resample_masked(z_new, prob.masks, sf) - prob.z0s
    return jnp.sum(r1 * r1) + lam * e_data


# ---------------------------------------------------------------------------
# One outer iteration
# ---------------------------------------------------------------------------


def srps_iteration(state: SRPSState, prob: SRPSProblem, sf: int, cfg: SolverConfig) -> SRPSState:
    """Lighting -> albedo -> depth -> normals (SRPS.cu:276-335 body)."""
    s = estimate_lighting(prob, state.rho, state.N, state.s)
    mom = s_moments(prob, s)
    rho = estimate_albedo(prob, mom, state.N, state.rho)
    z, energy, cg_iters = estimate_depth(prob, mom, rho, state.dz, state.z, sf, cfg)
    zx = gradops.grad_x(z, prob.gm)
    zy = gradops.grad_y(z, prob.gm)
    N, dz = normals_from_depth(z, zx, zy, prob.xx, prob.yy, prob.mask, prob.fx, prob.fy)
    return SRPSState(
        z=z,
        rho=rho,
        s=s,
        N=N,
        dz=dz,
        energy=energy,
        last_energy=state.energy,
        iteration=state.iteration + 1,
        cg_iters=cg_iters,
    )


def should_stop(state: SRPSState, cfg: SolverConfig) -> jax.Array:
    """Stopping rule with the reference's exact NaN semantics
    (SRPS.cu:297-301): stop on energy increase, relative tolerance, or
    iteration cap; first iteration never stops (NaN comparisons false)."""
    err, last = state.energy, state.last_energy
    rel = jnp.abs(last - err) / jnp.abs(err)
    inc = err > last  # false when last is NaN
    tol = rel < cfg.tolerance  # false when rel is NaN
    cap = state.iteration > cfg.max_iterations
    return inc | tol | cap


def solve_fused(
    state: SRPSState, prob: SRPSProblem, sf: int, cfg: SolverConfig
) -> Tuple[SRPSState, jax.Array]:
    """Whole outer loop inside one on-device ``lax.while_loop`` — zero host
    synchronisation for the entire solve. Returns the final state and the
    per-iteration energy trace (NaN-padded, length max_iterations + 2)."""
    trace_len = cfg.max_iterations + 2

    def cond(carry):
        st, _ = carry
        return ~should_stop(st, cfg) | (st.iteration == 0)

    def body(carry):
        st, trace = carry
        st = srps_iteration(st, prob, sf, cfg)
        trace = trace.at[st.iteration - 1].set(st.energy)
        return st, trace

    trace0 = jnp.full((trace_len,), jnp.nan, jnp.float32)
    # First iteration always runs (NaN energies make should_stop false).
    final, trace = lax.while_loop(cond, body, (state, trace0))
    return final, trace


def solve_fused_traced(
    state: SRPSState, prob: SRPSProblem, sf: int, cfg: SolverConfig
) -> Tuple[SRPSState, jax.Array, dict]:
    """:func:`solve_fused` variant that additionally records the full
    per-iteration state (s, rho, z, N, dz) in preallocated on-device
    traces, so ``--fused --dump`` can reproduce the reference's
    every-iteration dump channel (SRPS.cu:330-333) without leaving the
    on-device while_loop. Costs ~(max_iterations + 2) x state-size of
    device memory —
    only used when per-iteration dumps were requested."""
    trace_len = cfg.max_iterations + 2
    h, w = prob.mask.shape
    c, n = prob.I.shape[:2]
    straces0 = {
        "s": jnp.zeros((trace_len, n, c, 4), jnp.float32),
        "rho": jnp.zeros((trace_len, c, h, w), jnp.float32),
        "z": jnp.zeros((trace_len, h, w), jnp.float32),
        "N": jnp.zeros((trace_len, 4, h, w), jnp.float32),
        "dz": jnp.zeros((trace_len, h, w), jnp.float32),
    }

    def cond(carry):
        st, _, _ = carry
        return ~should_stop(st, cfg) | (st.iteration == 0)

    def body(carry):
        st, trace, straces = carry
        st = srps_iteration(st, prob, sf, cfg)
        i = st.iteration - 1
        trace = trace.at[i].set(st.energy)
        straces = {
            "s": straces["s"].at[i].set(st.s),
            "rho": straces["rho"].at[i].set(st.rho),
            "z": straces["z"].at[i].set(st.z),
            "N": straces["N"].at[i].set(st.N),
            "dz": straces["dz"].at[i].set(st.dz),
        }
        return st, trace, straces

    trace0 = jnp.full((trace_len,), jnp.nan, jnp.float32)
    final, trace, straces = lax.while_loop(
        cond, body, (state, trace0, straces0))
    return final, trace, straces
