"""End-to-end CLI tests: both dataset types through the real entry point.

The reference binary's surface is `srmeetsps --dstype matlab|images
--dsloc <path>` (Main.cpp:9-44); these tests drive our `cli.main`
in-process on tiny synthesized datasets and check the full pipeline
(load -> preprocess -> solve -> dumps/metrics) runs and emits healthy
outputs.
"""

import json
import os

import numpy as np
import pytest

from conftest import random_mask
from srmeetsps_cuda_tpu import cli


def _synth_arrays(rng, h=24, w=16, sf=2, n=3, c=3):
    mask = random_mask(rng, h, w)
    yy, xx = np.mgrid[0:h, 0:w]
    z_true = (60 + 4 * np.sin(xx / 3.0) + 3 * np.cos(yy / 4.0)).astype(
        np.float32)
    I = np.empty((n, c, h, w), np.float32)
    for i in range(n):
        light = rng.standard_normal(3) * 0.2 + np.array([0.1, 0.1, 0.8])
        shade = (light[0] * np.sin(xx / 3.0) + light[1] * np.cos(yy / 4.0)
                 + light[2])
        for ch in range(c):
            I[i, ch] = np.clip(0.25 * (ch + 1) * shade, 0, 1)
    z0 = np.stack([z_true[::sf, ::sf]
                   + 0.05 * rng.standard_normal((h // sf, w // sf))
                   for _ in range(n)]).astype(np.float32)
    K = np.array([[200.0, 0, w / 2 - 0.5], [0, 200.0, h / 2 - 0.5],
                  [0, 0, 1]], np.float32)
    return I, mask, K, z0, sf


def _write_mat(path, I, mask, K, z0, sf):
    import scipy.io as sio

    # MATLAB conventions: I (h, w, c, n), z0 (h/sf, w/sf, m), mask uint8.
    sio.savemat(path, {
        "I": np.moveaxis(I, (0, 1, 2, 3), (3, 2, 0, 1)).astype(np.float64),
        "K": K.astype(np.float64),
        "mask": (mask != 0).astype(np.uint8),
        "sf": float(sf),
        "z0": np.moveaxis(z0, 0, -1).astype(np.float64),
    })


def _write_images(folder, I, mask, K, z0, sf):
    from PIL import Image

    os.makedirs(os.path.join(folder, "RGB"))
    os.makedirs(os.path.join(folder, "Depth"))
    min_z, max_z = 0.0, float(z0.max() * 1.5)
    for i in range(I.shape[0]):
        rgb = (np.moveaxis(I[i], 0, -1) * 255).astype(np.uint8)
        Image.fromarray(rgb).save(os.path.join(folder, "RGB", f"{i:02d}.png"))
        d16 = ((z0[i] - min_z) / (max_z - min_z) * 65535).astype(np.uint16)
        Image.fromarray(d16).save(
            os.path.join(folder, "Depth", f"{i:02d}.png"))
    Image.fromarray((mask * 255).astype(np.uint8)).save(
        os.path.join(folder, "mask.png"))
    with open(os.path.join(folder, "K.txt"), "w") as f:
        for r in range(3):
            f.write(",".join(str(float(v)) for v in K[r]) + "\n")
        f.write(f"{sf},{min_z},{max_z}\n")


def _run_and_check(args, out_dir):
    rc = cli.main(args)
    assert rc == 0
    d = np.load(os.path.join(out_dir, "state_final.npz"))
    assert np.all(np.isfinite(d["z"]))
    assert np.all(np.isfinite(d["rho"]))
    lines = [json.loads(ln) for ln in
             open(os.path.join(out_dir, "metrics.jsonl"))]
    es = [ln["energy"] for ln in lines if "energy" in ln]
    assert len(es) >= 1 and all(np.isfinite(es))
    return es


def test_cli_matlab_dataset(rng, tmp_path):
    I, mask, K, z0, sf = _synth_arrays(rng)
    mat = str(tmp_path / "ds.mat")
    _write_mat(mat, I, mask, K, z0, sf)
    out = str(tmp_path / "out")
    es = _run_and_check(
        ["--dstype", "matlab", "--dsloc", mat, "--max-iterations", "2",
         "--cg-max-iter", "20", "--dump", "--dump-dir", out,
         "--dump-format", "npz",
         "--metrics-jsonl", os.path.join(out, "metrics.jsonl")], out)
    assert es[-1] <= es[0] * 1.5  # sane trajectory on a tiny fixture


def test_cli_images_dataset(rng, tmp_path):
    I, mask, K, z0, sf = _synth_arrays(rng)
    folder = str(tmp_path / "ds")
    os.makedirs(folder)
    _write_images(folder, I, mask, K, z0, sf)
    out = str(tmp_path / "out")
    _run_and_check(
        ["--dstype", "images", "--dsloc", folder, "--max-iterations", "2",
         "--cg-max-iter", "20", "--fused", "--dump", "--dump-dir", out,
         "--dump-format", "npz",
         "--metrics-jsonl", os.path.join(out, "metrics.jsonl")], out)


def test_cli_fast_preset(rng, tmp_path):
    """--fast = plain CG @ cap 40 (r5 re-tune); the preset must not
    override explicit --cg-max-iter and must produce a sane trajectory."""
    I, mask, K, z0, sf = _synth_arrays(rng)
    mat = str(tmp_path / "ds.mat")
    _write_mat(mat, I, mask, K, z0, sf)
    out = str(tmp_path / "out")
    es = _run_and_check(
        ["--dstype", "matlab", "--dsloc", mat, "--max-iterations", "2",
         "--fast", "--dump", "--dump-dir", out, "--dump-format", "npz",
         "--metrics-jsonl", os.path.join(out, "metrics.jsonl")], out)
    assert es[-1] <= es[0] * 1.5

    # Explicit cap wins over the preset's 40 (observable via cg_iterations
    # in the metrics: cap 3 admits at most 4 iterations, reference quirk).
    out2 = str(tmp_path / "out2")
    cli.main(["--dstype", "matlab", "--dsloc", mat, "--max-iterations", "1",
              "--fast", "--cg-max-iter", "3", "--dump-dir", out2,
              "--metrics-jsonl", os.path.join(out2, "metrics.jsonl")])
    with open(os.path.join(out2, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    cg_iters = [r["cg_iterations"] for r in recs if "cg_iterations" in r]
    assert cg_iters and all(k <= 4 for k in cg_iters)


def test_cli_batched_multi_dataset(rng, tmp_path):
    """Comma-separated --dsloc solves several objects in lockstep and
    writes per-object output subdirectories."""
    locs = []
    for b in range(2):
        I, mask, K, z0, sf = _synth_arrays(np.random.default_rng(b))
        folder = str(tmp_path / f"obj{b}")
        os.makedirs(folder)
        _write_images(folder, I, mask, K, z0, sf)
        locs.append(folder)
    out = str(tmp_path / "out")
    rc = cli.main(["--dstype", "images", "--dsloc", ",".join(locs),
                   "--max-iterations", "2", "--cg-max-iter", "15",
                   "--dump", "--dump-dir", out, "--dump-format", "npz"])
    assert rc == 0
    for b in range(2):
        d = np.load(os.path.join(out, f"obj{b}", "state_final.npz"))
        assert np.all(np.isfinite(d["z"]))


def test_cli_sharded_writes_outputs(rng, tmp_path):
    """--sharded must honour the output flags (dumps + metrics)."""
    I, mask, K, z0, sf = _synth_arrays(rng, h=64, w=32)
    folder = str(tmp_path / "ds")
    os.makedirs(folder)
    _write_images(folder, I, mask, K, z0, sf)
    out = str(tmp_path / "out")
    rc = cli.main(["--dstype", "images", "--dsloc", folder,
                   "--sharded", "8", "--max-iterations", "2",
                   "--cg-max-iter", "15", "--dump", "--dump-dir", out,
                   "--dump-format", "npz",
                   "--metrics-jsonl", os.path.join(out, "metrics.jsonl")])
    assert rc == 0
    d = np.load(os.path.join(out, "state_final.npz"))
    assert np.all(np.isfinite(d["z"]))
    lines = [json.loads(ln) for ln in
             open(os.path.join(out, "metrics.jsonl"))]
    assert any("energy" in ln for ln in lines)


def test_cli_help_exit_zero(capsys):
    assert cli.main([]) == 0
    assert "dstype" in capsys.readouterr().out


def test_cli_resume_roundtrip(rng, tmp_path):
    """--resume-from continues the iteration count (reference is
    write-only; resume is a framework extension)."""
    I, mask, K, z0, sf = _synth_arrays(rng)
    folder = str(tmp_path / "ds")
    os.makedirs(folder)
    _write_images(folder, I, mask, K, z0, sf)
    out = str(tmp_path / "out")
    cli.main(["--dstype", "images", "--dsloc", folder,
              "--max-iterations", "2", "--cg-max-iter", "10",
              "--dump", "--dump-dir", out, "--dump-format", "npz"])
    ck = np.load(os.path.join(out, "checkpoint.npz"))
    it0 = int(ck["iteration"])
    assert it0 >= 1
    out2 = str(tmp_path / "out2")
    cli.main(["--dstype", "images", "--dsloc", folder,
              "--max-iterations", "4", "--cg-max-iter", "10",
              "--resume-from", out, "--dump", "--dump-dir", out2,
              "--dump-format", "npz"])
    ck2 = np.load(os.path.join(out2, "checkpoint.npz"))
    assert int(ck2["iteration"]) > it0


def test_cli_fused_per_iteration_dumps(rng, tmp_path):
    """--fused --dump --viz must produce the SAME per-iteration artifact
    set as stepwise mode (reference dumps every iteration,
    SRPS.cu:330-333): per-iteration viz PNGs, overwritten state dumps, and
    a resumable checkpoint."""
    I, mask, K, z0, sf = _synth_arrays(rng)
    folder = str(tmp_path / "ds")
    os.makedirs(folder)
    _write_images(folder, I, mask, K, z0, sf)
    out = str(tmp_path / "out")
    rc = cli.main(
        ["--dstype", "images", "--dsloc", folder, "--max-iterations", "2",
         "--cg-max-iter", "15", "--fused", "--dump", "--viz",
         "--dump-dir", out, "--dump-format", "npz"])
    assert rc == 0
    # At least 2 per-iteration viz snapshots + the final set.
    for i in (1, 2):
        for kind in ("normals", "albedo", "depth"):
            assert os.path.exists(os.path.join(out, f"{kind}_{i:02d}.png")), (
                kind, i)
    assert os.path.exists(os.path.join(out, "checkpoint.npz"))
    ck = np.load(os.path.join(out, "checkpoint.npz"))
    assert int(ck["iteration"]) >= 2
    d = np.load(os.path.join(out, "state.npz"))
    assert np.all(np.isfinite(d["z"]))
    # The per-iteration state dump must equal the final state (overwrite
    # semantics: last write is the final iterate).
    df = np.load(os.path.join(out, "state_final.npz"))
    np.testing.assert_array_equal(d["z"], df["z"])


def test_cli_batched_mixed_geometry(rng, tmp_path):
    """Different-sized objects auto-pad to a common grid and solve as one
    batch; dumps come back cropped to each object's native grid."""
    locs, shapes = [], [(24, 16), (32, 24)]
    for b, (h, w) in enumerate(shapes):
        I, mask, K, z0, sf = _synth_arrays(np.random.default_rng(b), h=h,
                                           w=w)
        folder = str(tmp_path / f"obj{b}")
        os.makedirs(folder)
        _write_images(folder, I, mask, K, z0, sf)
        locs.append(folder)
    out = str(tmp_path / "out")
    rc = cli.main(["--dstype", "images", "--dsloc", ",".join(locs),
                   "--max-iterations", "2", "--cg-max-iter", "15",
                   "--dump", "--dump-dir", out, "--dump-format", "npz"])
    assert rc == 0
    for b, (h, w) in enumerate(shapes):
        d = np.load(os.path.join(out, f"obj{b}", "state_final.npz"))
        assert np.all(np.isfinite(d["z"]))
        assert d["rho"].shape[0] == 3  # channels survived the crop


def test_cli_serve_loop(rng, tmp_path, monkeypatch, capsys):
    """--serve keeps a resident program and answers one JSON line per
    stdin request (single + quit)."""
    import io

    I, mask, K, z0, sf = _synth_arrays(rng)
    folder = str(tmp_path / "ds")
    os.makedirs(folder)
    _write_images(folder, I, mask, K, z0, sf)
    import sys

    monkeypatch.setattr(
        sys, "stdin", io.StringIO(f"{folder}\n{folder},{folder}\nquit\n"))
    rc = cli.main(["--dstype", "images", "--serve", "--max-iterations", "2",
                   "--cg-max-iter", "10"])
    assert rc == 0
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines() if l.startswith("{")]
    assert lines[0]["serving"] is True
    assert lines[1]["iterations"] >= 1
    assert np.isfinite(lines[1]["final_energy"])
    assert lines[2]["batch"] == 2
    assert all(np.isfinite(e) for e in lines[2]["final_energy"])


def test_cli_gpu_auto_routing():
    """A bare invocation on a GPU backend resolves to the fused on-device
    outer loop (the reference binary runs its optimized path by default,
    Main.cpp:34-35); CPU keeps the stepwise loop; explicit --fused /
    --stepwise win over the backend default."""
    parser = cli.build_parser()

    for backend, expect in [("gpu", True), ("cpu", False)]:
        args = parser.parse_args(["--dsloc", "x"])
        args = cli.resolve_auto_flags(args, backend)
        assert args.fused is expect, backend

    args = parser.parse_args(["--dsloc", "x", "--stepwise"])
    assert cli.resolve_auto_flags(args, "gpu").fused is False

    args = parser.parse_args(["--dsloc", "x", "--fused"])
    assert cli.resolve_auto_flags(args, "cpu").fused is True


@pytest.mark.parametrize("argv,message", [
    (["--device", "99"], "--device 99"),
    (["--sharded", "99"], "--sharded 99"),
    (["--cg-variant", "cgs"], "only to --sharded"),
    (["--cg-variant", "cgs", "--sharded", "2", "--jacobi"], "Jacobi"),
])
def test_cli_usage_errors(argv, message, capsys):
    """Requests the program cannot honour are usage errors (exit 2),
    never silently replaced by something else."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--dsloc", "unused.mat", *argv])
    assert e.value.code == 2
    assert message in capsys.readouterr().err
