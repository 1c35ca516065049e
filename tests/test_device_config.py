"""Backend-keyed configuration: the beam state impl that impl="auto"
picks, and where the persistent compile cache lives."""

import json
import os
import subprocess
import sys

import jax
import pytest

from floria_tpu.kernels import beam

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,R,forced,want", [
    ("cpu", 320, "", "hist"),
    ("gpu", 320, "", "counts"),
    ("gpu", beam._R_CHUNK + 1, "", "counts"),    # any block length
    ("rocm", 320, "", "hist"),                   # unmeasured backend
    ("cpu", 320, "counts", "counts"),
    ("cpu", 320, "planes", "planes"),
    ("gpu", beam._R_CHUNK + 1, "planes", "hist"),
])
def test_auto_impl_follows_backend(monkeypatch, backend, R, forced, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setenv("FLORIA_BEAM_IMPL", forced)
    assert beam.resolve_impl("auto", R) == want


def test_explicit_planes_guards_long_blocks():
    assert beam.resolve_impl("planes", beam._R_CHUNK + 1) == "hist"
    assert beam.resolve_impl("counts", beam._R_CHUNK + 1) == "counts"


_PROBE = """
import json, jax, floria_tpu
from floria_tpu import aotcache
print(json.dumps({"jax": jax.config.jax_compilation_cache_dir,
                  "pkg": floria_tpu.cache_dir(),
                  "aot": aotcache._cache_dir()}))
"""


def _cache_config(tmp_path, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "FLORIA_CPU_CACHE")}
    env.update(JAX_PLATFORMS="cpu", **env_over)
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(tmp_path),
                          env=dict(env, PYTHONPATH=_REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cache_dir_honours_env_var(tmp_path):
    want = str(tmp_path / "xla")
    got = _cache_config(tmp_path, FLORIA_CPU_CACHE="1",
                        JAX_COMPILATION_CACHE_DIR=want)
    assert got == {"jax": want, "pkg": want, "aot": want}


def test_cache_dir_defaults_inside_checkout(tmp_path):
    want = os.path.join(_REPO, ".jax_cache")
    got = _cache_config(tmp_path, FLORIA_CPU_CACHE="1")
    assert got == {"jax": want, "pkg": want, "aot": want}
    with open(os.path.join(_REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_cpu_backend_sets_no_cache_without_opt_in(tmp_path):
    got = _cache_config(tmp_path)
    assert got["jax"] is None


@pytest.mark.parametrize("visible,devs,pid,want", [
    (None, ["/dev/nvidia0", "/dev/nvidia1", "/dev/nvidia2",
            "/dev/nvidia3"], 6, [2]),
    ("3,5", [], 1, [1]),
    (None, [], 0, None),                   # no GPU: no restriction
])
def test_each_process_takes_one_local_gpu(monkeypatch, visible, devs, pid,
                                          want):
    from floria_tpu.parallel import multihost

    monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(multihost.glob, "glob", lambda pat: devs)
    assert multihost._local_device_ids(pid) == want


def test_local_device_ids_env_wins(monkeypatch):
    from floria_tpu.parallel import multihost

    monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", "0,1")
    assert multihost._local_device_ids(3) is None
