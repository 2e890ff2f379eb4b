"""NumPy oracle: a literal port of the reference's *semantics* for testing.

This module mirrors the reference's sparse-matrix constructions and dense
math in plain NumPy/SciPy (column-major index space, explicit COO), so the
framework's dense-grid operators can be validated against the exact
masked-matrix behaviour (SURVEY.md section 4). Test-only code — never on the
product path.

File/line citations refer to /root/reference/SRmeetsPS-GPU/.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def downsampling_matrix(h: int, w: int, sf: int) -> sp.csr_matrix:
    """Literal mirror of DataHandler::initializeDownsamplingMatrix
    (Utilities.cpp:201-220), column-major index space."""
    n_row = (h * w) // (sf * sf)
    n_col = h * w
    spp = sf * sf
    rows = np.repeat(np.arange(n_row), spp)
    cols = np.zeros(n_row * spp, dtype=np.int64)
    hl = h // sf
    for i in range(n_row):
        for j in range(sf):
            for k in range(sf):
                cols[i * spp + j * sf + k] = (i // hl) * h * sf + (i % hl) * sf + j * h + k
    vals = np.full(n_row * spp, 1.0 / (sf * sf), dtype=np.float32)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_row, n_col))


def make_gradient(mask_cm: np.ndarray, h: int, w: int):
    """Literal mirror of make_gradient (SRPS.cu:23-71).

    Args:
      mask_cm: flat column-major HR mask (length h*w), nonzero = masked.

    Returns (Dx, Dy) as csr over masked-index space, plus imask and
    index_in_masked_matrix.
    """
    imask = np.flatnonzero(mask_cm != 0)
    idx_in_masked = np.zeros(h * w, dtype=np.int64)
    idx_in_masked[imask] = np.arange(len(imask))
    npix = len(imask)

    ic_b, ir_b, ic_t, ir_t = [], [], [], []
    ic_r, ir_r, ic_l, ir_l = [], [], [], []
    for j in range(w):
        for i in range(h):
            p = i + j * h
            if mask_cm[p] == 0:
                continue
            if i + 1 < h and mask_cm[p + 1] != 0:
                ic_b.append(idx_in_masked[p]); ir_b.append(idx_in_masked[p + 1])
            elif i - 1 >= 0 and mask_cm[p - 1] != 0:
                ic_t.append(idx_in_masked[p]); ir_t.append(idx_in_masked[p - 1])
            if j + 1 < w and mask_cm[p + h] != 0:
                ic_r.append(idx_in_masked[p]); ir_r.append(idx_in_masked[p + h])
            elif j - 1 >= 0 and mask_cm[p - h] != 0:
                ic_l.append(idx_in_masked[p]); ir_l.append(idx_in_masked[p - h])

    def build(ic, ir, k1, k2):
        rows = np.concatenate([ic, ic]).astype(np.int64) if ic else np.zeros(0, np.int64)
        cols = np.concatenate([ir, ic]).astype(np.int64) if ic else np.zeros(0, np.int64)
        vals = np.concatenate(
            [np.full(len(ic), k1, np.float32), np.full(len(ic), k2, np.float32)]
        )
        return sp.csr_matrix((vals, (rows, cols)), shape=(npix, npix))

    Dx = build(ic_r, ir_r, 1, -1) + build(ic_l, ir_l, -1, 1)
    Dy = build(ic_b, ir_b, 1, -1) + build(ic_t, ir_t, -1, 1)
    return Dx, Dy, imask, idx_in_masked


def lr_mask_and_KT(mask_cm: np.ndarray, h: int, w: int, sf: int):
    """Mirror of SRPS.cu:103-193: LR mask via D@mask with <1 -> 0, then the
    masked resample matrix KT (rows: masked LR pixels, cols: masked HR
    pixels, values 1/sf^2)."""
    D = downsampling_matrix(h, w, sf)
    masks = np.asarray(D @ mask_cm.astype(np.float32)).ravel()
    masks[masks < 1.0] = 0.0
    imask = np.flatnonzero(mask_cm != 0)
    imasks = np.flatnonzero(masks != 0)
    pos_in_imask = {v: k for k, v in enumerate(imask)}
    pos_in_imasks = {v: k for k, v in enumerate(imasks)}
    Dc = D.tocoo()
    rows, cols, vals = [], [], []
    for r, c in zip(Dc.row, Dc.col):
        if r in pos_in_imasks and c in pos_in_imask:
            rows.append(pos_in_imasks[r])
            cols.append(pos_in_imask[c])
            vals.append(1.0 / (sf * sf))
    KT = sp.csr_matrix(
        (np.array(vals, np.float32), (rows, cols)), shape=(len(imasks), len(imask))
    )
    return masks, imasks, KT


def normals(z, zx, zy, xx, yy, fx, fy):
    """Mirror of cuda_based_normal_init (devicecalls.cu:171-223) on packed
    masked vectors."""
    n1 = fx * zx
    n2 = fy * zy
    n3 = -z - xx * zx - yy * zy
    dz = np.maximum(1e-10, np.sqrt(n1 * n1 + n2 * n2 + n3 * n3))
    N = np.stack([n1 / dz, n2 / dz, n3 / dz, np.ones_like(z)], axis=0)
    return N, dz


def lighting_solve(rho, N, I_pack, s_prev):
    """Mirror of cuda_based_lightning_estimation (devicecalls.cu:408-444).

    Args:
      rho: (c, npix); N: (4, npix); I_pack: (n, c, npix); s_prev: (n, c, 4).
    Returns the converged normal-equation solution per (image, channel) —
    the reference's warm-started exact-tolerance CG reaches the same point.
    """
    n, c, npix = I_pack.shape
    s = np.array(s_prev, dtype=np.float64)
    for i in range(n):
        for j in range(c):
            A = (rho[j][None, :] * N).T  # (npix, 4)
            ATA = A.T @ A
            ATb = A.T @ I_pack[i, j]
            s[i, j] = np.linalg.solve(ATA, ATb)
    return s


def albedo_solve(N, s, I_pack, rho_prev):
    """Mirror of cuda_based_albedo_estimation (devicecalls.cu:497-548).

    The diagonal-expansion A makes A^T A diagonal; the converged CG result
    is the per-pixel closed form (previous rho where the diagonal is 0).
    """
    n, c, npix = I_pack.shape
    rho = np.array(rho_prev, dtype=np.float64)
    for j in range(c):
        shading = s[:, j, :] @ N  # (n, npix)
        den = np.sum(shading**2, axis=0)
        num = np.sum(shading * I_pack[:, j, :], axis=0)
        rho[j] = np.where(den > 0, num / np.where(den > 0, den, 1.0), rho_prev[j])
    return rho


def depth_system(rho, dz, s, xx, yy, fx, fy, Dx, Dy, KT, z0s_pack, I_pack, lam=1.0):
    """Mirror of cuda_based_depth_estimation's system construction
    (devicecalls.cu:636-758): returns (M, rhs, A, B) with
    M = KT^T KT + lam A^T A and rhs = KT^T z0s + lam A^T B.
    A rows are ordered channel-major then image-major like the reference's
    per-channel stacking (c outer, i inner)."""
    n, c, npix = I_pack.shape
    blocks = []
    B_rows = []
    for ch in range(c):
        for i in range(n):
            a1 = (rho[ch] / dz) * (fx * s[i, ch, 0] - xx * s[i, ch, 2])
            a2 = (rho[ch] / dz) * (fy * s[i, ch, 1] - yy * s[i, ch, 2])
            a3 = (rho[ch] / dz) * s[i, ch, 2]
            Ab = sp.diags(a1) @ Dx + sp.diags(a2) @ Dy - sp.diags(a3)
            blocks.append(Ab)
            B_rows.append(I_pack[i, ch] - rho[ch] * s[i, ch, 3])
    A = sp.vstack(blocks).tocsr()
    B = np.concatenate(B_rows)
    M = (KT.T @ KT + lam * (A.T @ A)).tocsr()
    rhs = KT.T @ z0s_pack + lam * (A.T @ B)
    return M, rhs, A, B


def depth_energy(z, A, B, KT, z0s_pack, lam=1.0):
    """Mirror of the energy computation (devicecalls.cu:762-767)."""
    r1 = KT @ z - z0s_pack
    r2 = A @ z - B
    return float(np.sum(r1 * r1) + lam * np.sum(r2 * r2))


def cg(M, b, x0, tol=1e-9, max_iter=100, dtype=np.float64):
    """Mirror of cuda_based_conjugate_gradient (devicecalls.cu:229-279),
    including the warm-start residualisation convention: solves M x = b
    starting from x0 (the caller residualises b).

    dtype=float32 mirrors the reference's actual arithmetic (all cuBLAS/
    cuSPARSE S-routines); float64 gives the mathematical trajectory."""
    M = M.astype(dtype)
    x = np.array(x0, dtype=dtype)
    r = np.array(b, dtype=dtype)
    p = np.zeros_like(r)
    r1 = float(r @ r)
    r0 = 0.0
    k = 0
    while r1 > tol * tol and k <= max_iter:
        k += 1
        if k == 1:
            p = r.copy()
        else:
            p = (r + dtype(r1 / r0) * p).astype(dtype)
        w = M @ p
        alpha = dtype(r1 / float(p @ w))
        x = (x + alpha * p).astype(dtype)
        r = (r - alpha * w).astype(dtype)
        r0, r1 = r1, float(r @ r)
    return x, k


def pcg_jacobi(M, b, x0, tol=1e-9, max_iter=100):
    """Jacobi-preconditioned CG with solve/cg.py's recurrence (rz-driven
    beta/alpha, plain <r,r> stopping, the reference's ``k <= max_iter``),
    in float64; the diagonal's zero entries are replaced by 1."""
    d = M.diagonal().astype(np.float64)
    d = np.where(d > 0, d, 1.0)
    M = M.astype(np.float64)
    x = np.array(x0, dtype=np.float64)
    r = np.array(b, dtype=np.float64)
    z = r / d
    p = np.zeros_like(r)
    rz0, rz1, rr = 0.0, float(r @ z), float(r @ r)
    k = 0
    while rr > tol * tol and k <= max_iter:
        k += 1
        beta = 0.0 if k == 1 else rz1 / (rz0 if rz0 != 0 else 1.0)
        p = z + beta * p
        w = M @ p
        pw = float(p @ w)
        alpha = rz1 / (pw if pw != 0 else 1.0)
        x = x + alpha * p
        r = r - alpha * w
        z = r / d
        rz0, rz1, rr = rz1, float(r @ z), float(r @ r)
    return x, k
