"""AOT-export cache (floria_tpu/aotcache.py): the machine-local traced-
program cache must be numerically invisible — exported-module dispatch
(both the export-writing first process and the blob-reading later
process) bit-identical to the plain jit path — and robust to corrupt
blobs."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from floria_tpu import aotcache
from floria_tpu.phase import local as pl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chain_args(seed=0):
    rng = np.random.RandomState(seed)
    B, R, S = 8, 64, 32
    dev_a = jax.device_put(rng.randint(-1, 2, (B, R, S)).astype(np.int8))
    dev_q = jax.device_put(
        rng.randint(0, 40, (B, R, S)).astype(np.uint8))
    idx = jnp.asarray(rng.randint(0, B, 8).astype(np.int32))
    nreads = np.full(8, 50, np.int32)
    eps = np.full(8, 0.02, np.float32)
    return dev_a, dev_q, idx, nreads, eps


@pytest.fixture
def aot_env(tmp_path, monkeypatch):
    monkeypatch.setenv("FLORIA_CPU_CACHE", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path / "aot"))
    monkeypatch.delenv("FLORIA_AOT", raising=False)
    aotcache.reset()
    yield str(tmp_path / "aot")
    aotcache.reset()


def _assert_tree_equal(a, b, msg):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), msg


def test_aot_chain_bit_equal_and_blob_roundtrip(aot_env):
    """Export path AND deserialize path both bit-equal to plain jit,
    for every sweep-chain ploidy shape."""
    args = _chain_args()
    for ploidy in (1, 2, 3):
        key = (ploidy, 10, 0, 2)
        fn = pl._sweep_chain_fn(*key)
        ref = jax.block_until_ready(fn(*args))
        out = jax.block_until_ready(
            aotcache.call("sweep_chain", key, fn, args))
        _assert_tree_equal(ref, out, f"export path diverged p={ploidy}")
    blobs = sorted(f for f in os.listdir(aot_env)
                   if f.startswith("aotexp_") and f.endswith(".bin"))
    assert len(blobs) == 3
    mtimes = {b: os.path.getmtime(os.path.join(aot_env, b))
              for b in blobs}
    # Fresh "process": drop the memo so the next call must read blobs.
    aotcache.reset()
    for ploidy in (1, 2, 3):
        key = (ploidy, 10, 0, 2)
        fn = pl._sweep_chain_fn(*key)
        ref = jax.block_until_ready(fn(*args))
        out = jax.block_until_ready(
            aotcache.call("sweep_chain", key, fn, args))
        _assert_tree_equal(ref, out, f"blob path diverged p={ploidy}")
    # The blobs were read, not rewritten.
    assert {b: os.path.getmtime(os.path.join(aot_env, b))
            for b in blobs} == mtimes


def test_aot_corrupt_blob_rebuilt(aot_env):
    args = _chain_args(1)
    key = (2, 10, 0, 2)
    fn = pl._sweep_chain_fn(*key)
    ref = jax.block_until_ready(fn(*args))
    jax.block_until_ready(aotcache.call("sweep_chain", key, fn, args))
    blobs = [f for f in os.listdir(aot_env) if f.startswith("aotexp_") and f.endswith(".bin")]
    assert len(blobs) == 1
    with open(os.path.join(aot_env, blobs[0]), "wb") as fh:
        fh.write(b"not a stablehlo module")
    aotcache.reset()
    out = jax.block_until_ready(
        aotcache.call("sweep_chain", key, fn, args))
    _assert_tree_equal(ref, out, "rebuild after corrupt blob diverged")
    # The corrupt blob was replaced with a readable one.
    with open(os.path.join(aot_env, blobs[0]), "rb") as fh:
        assert fh.read() != b"not a stablehlo module"


def test_aot_disabled_by_env(aot_env, monkeypatch):
    monkeypatch.setenv("FLORIA_AOT", "0")
    args = _chain_args(2)
    key = (2, 10, 0, 2)
    fn = pl._sweep_chain_fn(*key)
    jax.block_until_ready(aotcache.call("sweep_chain", key, fn, args))
    assert not os.path.exists(aot_env) or not [
        f for f in os.listdir(aot_env) if f.startswith("aotexp_") and f.endswith(".bin")]


def _run_cli(sim, out, env_extra, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # One device (pytest's env forces 8): the AOT cache serves the
    # production single-device dispatch path.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-m", "floria_tpu.cli",
         "-b", sim + "/sim.bam", "-v", sim + "/sim.vcf",
         "-r", sim + "/sim.fa", "-o", out,
         "-e", "0.02", "-l", "4000", "--snp-count-filter", "10",
         "-p", "3", "--overwrite"],
        capture_output=True, text=True, env=env, cwd=REPO,
        timeout=timeout)
    assert r.returncode == 0, r.stderr[-2000:]


def _collect(out):
    got = {}
    for root, _dirs, files in os.walk(out):
        for f in files:
            if f.endswith((".vartigs", ".haplosets", ".tsv")):
                p = os.path.join(root, f)
                with open(p) as fh:
                    got[os.path.relpath(p, out)] = fh.read().replace(
                        out, "OUT")
    return got


def test_aot_cli_byte_identical(small_sim, tmp_path):
    """Whole-pipeline A/B: AOT disabled vs export-writing run vs
    blob-reading run — all outputs byte-identical."""
    cfg, truth, sim = small_sim
    cache = str(tmp_path / "aotcache")
    base = str(tmp_path / "base")
    _run_cli(sim, base, {"FLORIA_AOT": "0"})
    ref = _collect(base)
    assert ref
    for label in ("write", "read"):
        out = str(tmp_path / f"aot_{label}")
        _run_cli(sim, out, {"FLORIA_CPU_CACHE": "1",
                            "JAX_COMPILATION_CACHE_DIR": cache})
        assert _collect(out) == ref, f"AOT {label} run diverged"
    assert [f for f in os.listdir(cache) if f.startswith("aotexp_") and f.endswith(".bin")]
