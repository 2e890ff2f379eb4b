"""Operator-level parity tests vs the NumPy/SciPy oracle (literal mirror of
the reference's COO constructions)."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import random_mask
from srmeetsps_cuda_tpu.ops import grid, gradients, normals
import oracle


def pack_cm(arr2d, mask):
    """Dense (h,w) -> packed masked vector in column-major scan order."""
    return grid.masked_select_colmajor(arr2d, mask)


class TestDownsample:
    def test_matches_sparse_D(self, rng):
        h, w, sf = 16, 24, 2
        x = rng.random((h, w)).astype(np.float32)
        D = oracle.downsampling_matrix(h, w, sf)
        want = np.asarray(D @ x.T.ravel()).reshape(w // sf, h // sf).T
        got = np.asarray(grid.box_downsample(jnp.asarray(x), sf))
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_sf4(self, rng):
        h, w, sf = 32, 16, 4
        x = rng.random((h, w)).astype(np.float32)
        D = oracle.downsampling_matrix(h, w, sf)
        want = np.asarray(D @ x.T.ravel()).reshape(w // sf, h // sf).T
        got = np.asarray(grid.box_downsample(jnp.asarray(x), sf))
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_adjoint(self, rng):
        h, w, sf = 16, 24, 2
        x = rng.random((h, w)).astype(np.float32)
        u = rng.random((h // sf, w // sf)).astype(np.float32)
        lhs = float(jnp.vdot(grid.box_downsample(jnp.asarray(x), sf), u))
        rhs = float(jnp.vdot(x, grid.box_upsample_adjoint(jnp.asarray(u), sf)))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-6)


class TestLRMaskAndKT:
    def test_lr_mask(self, rng):
        h, w, sf = 24, 16, 2
        mask = random_mask(rng, h, w)
        masks_o, _, _ = oracle.lr_mask_and_KT(mask.T.ravel(), h, w, sf)
        got = np.asarray(grid.lr_mask(jnp.asarray(mask), sf))
        want = masks_o.reshape(w // sf, h // sf).T
        np.testing.assert_array_equal(got, (want != 0).astype(np.float32))

    def test_KT_matvec(self, rng):
        h, w, sf = 24, 16, 2
        mask = random_mask(rng, h, w)
        masks_o, imasks, KT = oracle.lr_mask_and_KT(mask.T.ravel(), h, w, sf)
        z = rng.random((h, w)).astype(np.float32) * mask
        z_pack = pack_cm(z, mask)
        want_pack = KT @ z_pack
        masks2d = np.asarray(grid.lr_mask(jnp.asarray(mask), sf))
        got2d = np.asarray(grid.resample_masked(jnp.asarray(z), jnp.asarray(masks2d), sf))
        got_pack = pack_cm(got2d, masks2d)
        np.testing.assert_allclose(got_pack, want_pack, rtol=1e-5, atol=1e-7)

    def test_KT_transpose_matvec(self, rng):
        h, w, sf = 24, 16, 2
        mask = random_mask(rng, h, w)
        _, imasks, KT = oracle.lr_mask_and_KT(mask.T.ravel(), h, w, sf)
        masks2d = np.asarray(grid.lr_mask(jnp.asarray(mask), sf))
        u = rng.random(masks2d.shape).astype(np.float32) * masks2d
        u_pack = pack_cm(u, masks2d)
        want_pack = KT.T @ u_pack
        got2d = np.asarray(
            grid.resample_masked_t(jnp.asarray(u), jnp.asarray(mask), jnp.asarray(masks2d), sf)
        )
        got_pack = pack_cm(got2d, mask)
        np.testing.assert_allclose(got_pack, want_pack, rtol=1e-5, atol=1e-7)


class TestKtw:
    @pytest.mark.parametrize("mask_kind", ["blob", "random", "full"])
    @pytest.mark.parametrize("sf", [1, 2, 4])
    def test_make_ktw_is_diag_KTtKT(self, rng, sf, mask_kind):
        """ops.grid.make_ktw == diag(KT^T KT) of the oracle's explicit KT,
        on the HR grid (zero off the mask and under dropped LR pixels)."""
        h, w = 24, 16
        mask = (np.ones((h, w), np.float32) if mask_kind == "full"
                else random_mask(rng, h, w, blob=(mask_kind == "blob")))
        _, _, KT = oracle.lr_mask_and_KT(mask.T.ravel(), h, w, sf)
        masks2d = grid.lr_mask(jnp.asarray(mask), sf)
        got = np.asarray(grid.make_ktw(jnp.asarray(mask), masks2d, sf))
        want = np.asarray((KT.T @ KT).diagonal()).ravel()
        np.testing.assert_allclose(pack_cm(got, mask), want, rtol=1e-6)
        assert np.all(got[mask == 0] == 0)


class TestGradients:
    def _setup(self, rng, h=24, w=16):
        mask = random_mask(rng, h, w)
        Dx, Dy, imask, _ = oracle.make_gradient(mask.T.ravel(), h, w)
        gm = gradients.GradientMasks.from_mask(jnp.asarray(mask))
        z = rng.standard_normal((h, w)).astype(np.float32) * mask
        return mask, Dx, Dy, gm, z

    def test_grad_x(self, rng):
        mask, Dx, Dy, gm, z = self._setup(rng)
        want = Dx @ pack_cm(z, mask)
        got = pack_cm(np.asarray(gradients.grad_x(jnp.asarray(z), gm)), mask)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_grad_y(self, rng):
        mask, Dx, Dy, gm, z = self._setup(rng)
        want = Dy @ pack_cm(z, mask)
        got = pack_cm(np.asarray(gradients.grad_y(jnp.asarray(z), gm)), mask)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_grad_x_transpose(self, rng):
        mask, Dx, Dy, gm, z = self._setup(rng)
        y = np.random.default_rng(1).standard_normal(z.shape).astype(np.float32) * mask
        want = Dx.T @ pack_cm(y, mask)
        got = pack_cm(np.asarray(gradients.grad_x_t(jnp.asarray(y), gm)), mask)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_grad_y_transpose(self, rng):
        mask, Dx, Dy, gm, z = self._setup(rng)
        y = np.random.default_rng(2).standard_normal(z.shape).astype(np.float32) * mask
        want = Dy.T @ pack_cm(y, mask)
        got = pack_cm(np.asarray(gradients.grad_y_t(jnp.asarray(y), gm)), mask)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_adjoint_identity(self, rng):
        """<Dx z, y> == <z, Dx^T y> on random data (support inside mask)."""
        mask, _, _, gm, z = self._setup(rng)
        y = np.random.default_rng(3).standard_normal(z.shape).astype(np.float32) * mask
        lhs = float(jnp.vdot(gradients.grad_x(jnp.asarray(z), gm), y))
        rhs = float(jnp.vdot(z, gradients.grad_x_t(jnp.asarray(y), gm)))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-5)
        lhs = float(jnp.vdot(gradients.grad_y(jnp.asarray(z), gm), y))
        rhs = float(jnp.vdot(z, gradients.grad_y_t(jnp.asarray(y), gm)))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-5)

    def test_output_support_in_mask(self, rng):
        mask, _, _, gm, z = self._setup(rng)
        zfull = np.random.default_rng(4).standard_normal(z.shape).astype(np.float32)
        for op in (gradients.grad_x, gradients.grad_y, gradients.grad_x_t, gradients.grad_y_t):
            out = np.asarray(op(jnp.asarray(zfull * mask), gm))
            assert np.all(out[mask == 0] == 0)


class TestMeshgridNormals:
    def test_meshgrid(self):
        xx, yy = grid.meshgrid_camera(4, 5, cx=2.0, cy=1.5)
        assert np.asarray(xx)[0, 3] == 3 - 2.0
        assert np.asarray(yy)[2, 0] == 2 - 1.5

    def test_normals_vs_oracle(self, rng):
        h, w = 24, 16
        mask = random_mask(rng, h, w)
        gm = gradients.GradientMasks.from_mask(jnp.asarray(mask))
        z = (rng.random((h, w)).astype(np.float32) + 0.5) * mask
        xx, yy = grid.meshgrid_camera(h, w, cx=7.5, cy=11.5)
        zx = gradients.grad_x(jnp.asarray(z), gm)
        zy = gradients.grad_y(jnp.asarray(z), gm)
        N, dz = normals.normals_from_depth(jnp.asarray(z), zx, zy, xx * mask, yy * mask,
                                           jnp.asarray(mask), 530.0, 532.0)
        want_N, want_dz = oracle.normals(
            pack_cm(z, mask), pack_cm(np.asarray(zx), mask), pack_cm(np.asarray(zy), mask),
            pack_cm(np.asarray(xx), mask), pack_cm(np.asarray(yy), mask), 530.0, 532.0)
        got_N = np.stack([pack_cm(np.asarray(N[k]), mask) for k in range(4)])
        np.testing.assert_allclose(got_N, want_N, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pack_cm(np.asarray(dz), mask), want_dz, rtol=1e-5)


class TestMeanAcrossFrames:
    def test_quirky_mean(self, rng):
        z0 = rng.random((5, 8, 6)).astype(np.float32)
        z0[z0 < 0.3] = 0.0
        mean, flags = grid.mean_across_frames(jnp.asarray(z0))
        want_mean = z0.sum(axis=0) / 5.0  # divide by n even with missing
        want_flags = np.any(z0 == 0, axis=0)
        np.testing.assert_allclose(np.asarray(mean), want_mean, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(flags), want_flags)
