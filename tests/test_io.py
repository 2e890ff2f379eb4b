"""Loader / writer / CLI-surface tests."""

import os

import numpy as np
import pytest

from srmeetsps_cuda_tpu.io import writers
from srmeetsps_cuda_tpu.io.image_loader import load_image_dataset, ProblemData
from srmeetsps_cuda_tpu.io.mat_loader import load_mat_dataset


@pytest.fixture
def image_dataset(tmp_path, rng):
    """Synthesise a tiny image-folder dataset in the reference layout."""
    from PIL import Image

    h, w, sf, n = 16, 24, 2, 3
    (tmp_path / "RGB").mkdir()
    (tmp_path / "Depth").mkdir()
    rgbs, depths = [], []
    for i in range(n):
        a = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        rgbs.append(a)
        Image.fromarray(a).save(tmp_path / "RGB" / f"I_{i+1}.png")
        d = rng.integers(0, 65535, (h // sf, w // sf), dtype=np.uint16)
        depths.append(d)
        Image.fromarray(d, mode="I;16").save(tmp_path / "Depth" / f"z0_{i+1}.png")
    m = (rng.random((h, w)) > 0.3).astype(np.uint8) * 255
    Image.fromarray(m).save(tmp_path / "mask.png")
    with open(tmp_path / "K.txt", "w") as f:
        f.write("500.5,0,11.5\n0,501.5,7.5\n0,0,1\n")
        f.write("2,100,4000\n")
    return tmp_path, rgbs, depths, m, h, w, sf, n


class TestImageLoader:
    def test_roundtrip(self, image_dataset):
        path, rgbs, depths, m, h, w, sf, n = image_dataset
        data = load_image_dataset(str(path))
        assert data.I.shape == (n, 3, h, w)
        assert data.sf == sf
        assert data.z0.shape == (n, h // sf, w // sf)
        # lexicographic file order = insertion order here (n < 10)
        np.testing.assert_allclose(
            data.I[0], np.moveaxis(rgbs[0], -1, 0) / 255.0, atol=1e-6)
        # 16-bit depth mapping: min_z + png/65535 * (max_z - min_z)
        np.testing.assert_allclose(
            data.z0[1], 100 + depths[1] / 65535.0 * 3900.0, rtol=1e-6)
        np.testing.assert_allclose(data.mask, m / 255.0, atol=1e-6)
        np.testing.assert_allclose(data.K[0, 0], 500.5)
        np.testing.assert_allclose(data.K[1, 2], 7.5)

    def test_native_loader_matches_pil_if_built(self, image_dataset):
        from srmeetsps_cuda_tpu.io import native_loader

        path, rgbs, depths, *_ = image_dataset
        a = native_loader.decode_png(str(path / "RGB" / "I_1.png"))
        if a is None:
            pytest.skip("native loader not built")
        np.testing.assert_array_equal(a, rgbs[0])
        d = native_loader.decode_png(str(path / "Depth" / "z0_1.png"))
        np.testing.assert_array_equal(d, depths[0])


class TestMatLoader:
    def test_v5_roundtrip(self, tmp_path, rng):
        import scipy.io as sio

        h, w, c, n, sf = 12, 16, 3, 2, 2
        I = rng.random((h, w, c, n))
        K = np.array([[400.0, 0, 7.5], [0, 401.0, 5.5], [0, 0, 1]])
        mask = (rng.random((h, w)) > 0.4).astype(np.uint8)
        z0 = rng.random((h // sf, w // sf, n))
        p = tmp_path / "ds.mat"
        sio.savemat(p, {"I": I, "K": K, "mask": mask, "sf": 2.0, "z0": z0})
        data = load_mat_dataset(str(p))
        assert data.I.shape == (n, c, h, w)
        np.testing.assert_allclose(data.I[1, 2], I[:, :, 2, 1], rtol=1e-6)
        np.testing.assert_allclose(data.z0[0], z0[:, :, 0], rtol=1e-6)
        assert data.sf == 2
        np.testing.assert_allclose(data.mask, mask)

    def test_v73_roundtrip(self, tmp_path, rng):
        h5py = pytest.importorskip("h5py")
        h, w, c, n, sf = 12, 16, 3, 2, 2
        I = rng.random((h, w, c, n))
        mask = (rng.random((h, w)) > 0.4).astype(np.uint8)
        z0 = rng.random((h // sf, w // sf, n))
        p = tmp_path / "ds73.mat"
        # MATLAB v7.3 = HDF5 with column-major data => store transposed.
        with h5py.File(p, "w") as f:
            f["I"] = I.T
            f["K"] = np.array([[400.0, 0, 7.5], [0, 401.0, 5.5], [0, 0, 1]]).T
            f["mask"] = mask.T
            f["sf"] = np.array([[2.0]])
            f["z0"] = z0.T
        data = load_mat_dataset(str(p))
        assert data.I.shape == (n, c, h, w)
        np.testing.assert_allclose(data.I[1, 2], I[:, :, 2, 1], rtol=1e-6)
        np.testing.assert_allclose(data.z0[1], z0[:, :, 1], rtol=1e-6)


class TestWriters:
    def test_dump_and_checkpoint_roundtrip(self, tmp_path, small_problem):
        import jax.numpy as jnp

        from srmeetsps_cuda_tpu.models import srps

        p = small_problem
        K = [[p["fx"], 0, p["cx"]], [0, p["fy"], p["cy"]], [0, 0, 1]]
        prob = srps.build_problem(p["I"], p["mask"], K, p["sf"],
                                  np.zeros((p["h"] // 2, p["w"] // 2), np.float32))
        st = srps.init_state(prob, p["z"])
        writers.dump_state(str(tmp_path), st, p["mask"], fmt="npz", tag="_t")
        d = np.load(tmp_path / "state_t.npz")
        npix = int((p["mask"] != 0).sum())
        assert d["z"].shape == (npix,)
        assert d["rho"].shape == (p["c"], npix)
        writers.dump_state(str(tmp_path), st, p["mask"], fmt="mat", tag="_t")
        m = writers.load_mat_any(tmp_path / "z_t.mat")
        assert m["x"].shape == (npix, 1)

        writers.save_checkpoint(str(tmp_path / "ck.npz"), st, 3)
        ck = writers.load_checkpoint(str(tmp_path / "ck.npz"))
        np.testing.assert_array_equal(ck["z"], np.asarray(st.z))
        assert int(ck["iteration"]) == 3

    def test_visualizations(self, tmp_path, small_problem):
        from srmeetsps_cuda_tpu.models import srps

        p = small_problem
        K = [[p["fx"], 0, p["cx"]], [0, p["fy"], p["cy"]], [0, 0, 1]]
        prob = srps.build_problem(p["I"], p["mask"], K, p["sf"],
                                  np.zeros((p["h"] // 2, p["w"] // 2), np.float32))
        st = srps.init_state(prob, p["z"])
        writers.save_visualizations(str(tmp_path), st, p["mask"], tag="_v")
        for f in ["normals_v.png", "albedo_v.png", "depth_v.png"]:
            assert (tmp_path / f).exists()


class TestEndToEndSmall:
    def test_solve_on_synthetic_dataset(self, image_dataset):
        from srmeetsps_cuda_tpu.config import RuntimeConfig, SolverConfig
        from srmeetsps_cuda_tpu.runtime.solver import solve

        path, *_ = image_dataset
        data = load_image_dataset(str(path))
        cfg = SolverConfig(max_iterations=2, inpaint_iters=32)
        st, metrics = solve(data, cfg, RuntimeConfig(), verbose=False)
        assert np.isfinite(float(st.energy))
        assert len(metrics) >= 1
        assert metrics[0]["energy"] > 0


def test_mat73_without_h5py_names_it(monkeypatch, tmp_path):
    """h5py is optional: a MAT v7.3 request without it fails with a message
    that names the package."""
    import builtins

    from srmeetsps_cuda_tpu.io import writers

    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        writers.save_mat73(str(tmp_path / "x.mat"), {"x": np.zeros(3)})
