"""chip_smoke.py on the CPU: it refuses to run without a GPU, its
``--four-cards`` option selects only the sharded phase, its datasets are
fixed by the seed, and every phase runs here at a small geometry with the
CPU standing in for the card."""

import os
import shutil
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

import chip_smoke
from srmeetsps_cuda_tpu.io.synthetic import disc_mask, render_consistent

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(h=96, w=128, sf=2, n=20, c=3, f=1216.73 / 10)


def _run_script(cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run_script(ROOT, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_exits_nonzero_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_script(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_four_cards_selects_only_its_phase():
    assert chip_smoke.phases_for(
        chip_smoke.parse_args(["--four-cards"])) == ("sharded",)
    main = chip_smoke.phases_for(chip_smoke.parse_args([]))
    assert "sharded" not in main and "fused" in main
    for name in main + ("sharded",):
        assert hasattr(chip_smoke.Smoke, "phase_" + name.replace("-", "_"))


@pytest.mark.parametrize("seed", [0, 7])
def test_renderer_is_deterministic_per_seed(seed):
    mask = disc_mask(32, 48)
    a, za, na = render_consistent(np.random.default_rng(seed), mask, n=3)
    b, zb, nb = render_consistent(np.random.default_rng(seed), mask, n=3)
    c, _, _ = render_consistent(np.random.default_rng(seed + 1), mask, n=3)
    for x, y in ((a.I, b.I), (a.z0, b.z0), (za, zb), (na, nb)):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a.I, c.I)


@pytest.fixture(scope="module")
def smoke():
    devs = jax.devices()
    with tempfile.TemporaryDirectory() as work:
        s = chip_smoke.Smoke(SMALL, 0, work, devs[0], devs[1])
        s.setup()
        s.phase_fused()
        yield s


@pytest.mark.parametrize("phase", chip_smoke.MAIN_PHASES
                         + chip_smoke.FOUR_CARD_PHASES)
def test_phase_runs_on_cpu(smoke, phase):
    out = getattr(smoke, "phase_" + phase.replace("-", "_"))()
    assert isinstance(out, dict) and out
