"""On-card checks (marker `gpu`): the CPU-run suite can never see a
device precision bug, so these run chip_smoke.py's phases against the
environment's real backend in subprocesses. They skip, with a reason,
where no NVIDIA GPU is found; the decision is made inside the `gpu`
fixture. On a GPU host:

    python -m pytest tests/test_gpu_e2e.py -q -m gpu
"""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


def _device_env():
    env = dict(os.environ)
    # The suite forces the CPU backend; a child picks the real one.
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def gpu():
    """The environment for a child on the card; skips without a GPU."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    env = _device_env()
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0 or proc.stdout.strip() != "gpu":
        pytest.skip(f"JAX finds no GPU ({proc.stdout.strip()!r})")
    return env


def _run_cli(sim_dir, out_dir, env):
    cmd = [sys.executable, "-m", "floria_tpu.cli",
           *chip_smoke._cli_argv(sim_dir, out_dir)]
    proc = subprocess.run(cmd, cwd=_REPO, env=env, capture_output=True,
                          text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_gpu_outputs_match_cpu(gpu, small_sim, tmp_path):
    """One small contig end to end on the card and on the CPU backend;
    every output file byte-identical with paths normalised."""
    _cfg, _truth, sim_dir = small_sim
    cpu_out = str(tmp_path / "cpu")
    gpu_out = str(tmp_path / "gpu")
    _run_cli(sim_dir, cpu_out, dict(gpu, JAX_PLATFORMS="cpu"))
    _run_cli(sim_dir, gpu_out, gpu)
    assert chip_smoke.compare_outputs(cpu_out, gpu_out) == []


def test_device_matmul_exactness_contract(gpu):
    """chip_smoke's precision phase: the 13-bit plane einsum and the
    24-bit one-hot permutation are exact at EXACT_MATMUL_PRECISION, and
    rank-select indices are exact past 2048 slots."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import chip_smoke; chip_smoke.precision_probe(); print('OK')"],
        cwd=_REPO, env=gpu, capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")
