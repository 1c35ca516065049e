"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
exercised without accelerator hardware. Must be set before jax is imported
anywhere.
"""

import os

# Force the CPU backend (also through jax.config below, in case jax was
# imported before this file) before any backend initialization happens.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys

# Repo root on the path so tests can import bench.py's workload builder.
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from floria_tpu.sim.simulate import SimConfig, simulate  # noqa: E402


@pytest.fixture(scope="session")
def small_sim(tmp_path_factory):
    """A small 2-strain long-read community used across tests."""
    out = tmp_path_factory.mktemp("sim_small")
    cfg = SimConfig(contig_len=30_000, num_strains=2, num_snps=120,
                    coverage_per_strain=10.0, read_length=4_000,
                    read_length_sd=500.0, error_rate=0.01, seed=3)
    truth = simulate(cfg, str(out))
    return cfg, truth, str(out)


@pytest.fixture(autouse=True)
def _mmap_pressure_guard():
    """Keep the pytest process under vm.max_map_count (65530 default).

    Every XLA:CPU jitted executable holds ~8 small mmaps (JIT code +
    data + guard pages) and jit caches accumulate for the whole pytest
    process; the full suite compiles thousands of shape variants, and
    once the map count hits the sysctl limit further mmaps fail and
    LLVM SEGFAULTS mid-compile (observed deterministically at ~124
    tests). Dropping the compiled-function caches when pressure builds
    trades a few recompiles for survival. Production pipelines compile
    ~2 orders of magnitude fewer variants and never get near the limit.
    """
    yield
    try:
        with open("/proc/self/maps") as fh:
            n = sum(1 for _ in fh)
        if n > 40_000:
            jax.clear_caches()
    except OSError:  # pragma: no cover - /proc-less platforms
        pass
