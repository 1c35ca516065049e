"""floria_tpu — accelerator-native metagenomic strain haplotype phasing.

A from-scratch JAX/XLA framework with the capabilities of the
reference tool floria (strain-level haplotype phasing of metagenomes from
BAM + VCF + FASTA): read fragments become dense read×SNP allele tensors,
local phasing runs as batched beam-search/UPEM device kernels, and the
global strain resolution (hap-graph, LP flow, widest paths) runs on host.
Work scales across devices by sharding SNP blocks over a jax.sharding.Mesh.
"""

__version__ = "0.1.0"

import os as _os

# Fixed fallback for the persistent caches: inside the checkout (listed
# in .gitignore), so a cache key that includes the path keeps hitting.
_DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """THE directory of every persistent cache this package keeps: the
    XLA compilation cache, the AOT-export blobs (aotcache.py) and the
    BAM range / VCF SNP-count sidecars. $JAX_COMPILATION_CACHE_DIR when
    set (JAX reads that variable itself), else _DEFAULT_CACHE_DIR."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _DEFAULT_CACHE_DIR)


def _enable_compilation_cache() -> None:
    """Persist XLA compilations across runs: the phasing kernel compiles
    one variant per (ploidy, read-bucket, site-bucket) shape, which is
    seconds each but adds up on first contact with a new workload."""
    # CPU executables are machine-feature sensitive (reload warns about
    # SIGILL risk), so the CPU backend caches only when opted in
    # (FLORIA_CPU_CACHE=1 — safe when the cache never leaves the
    # machine, e.g. the multi-process scaling bench, where per-rank
    # recompiles would masquerade as scaling loss).
    if ("cpu" in _os.environ.get("JAX_PLATFORMS", "").lower()
            and _os.environ.get("FLORIA_CPU_CACHE") != "1"):
        return
    try:
        import jax

        if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", cache_dir())
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          0.5)
    except Exception:  # pragma: no cover - cache is best-effort
        pass


def _enable_x64() -> None:
    """Globally enable 64-bit JAX types: the beam/UPEM kernels carry
    exact integer weight-quanta in f64 (kernels/beam.py _require_x64;
    VALIDATION.md "Exact arithmetic"). Process-global because scoped
    jax.enable_x64() contexts cannot cross an outer non-x64 jit trace
    (e.g. a harness jitting entry() itself). All hot-path arrays pin
    their dtypes explicitly, so nothing silently widens."""
    try:
        import jax

        jax.config.update("jax_enable_x64", True)
    except Exception:  # pragma: no cover - jax always present in prod
        pass


def _disable_thp() -> None:
    """Opt this process out of transparent huge pages.

    On the target VMs a 2 MB huge-page first-touch fault costs ~5 ms
    (host lazily backs guest memory at ~360 MB/s through them) while 4 KB
    faults run at ~2 GB/s — measured 12x faster first-touch for the big
    ingest buffers (decoded BAM, payload buffers, site arrays). Host
    tensors here are transfer staging, not compute, so THP's TLB upside
    is irrelevant. prctl(PR_SET_THP_DISABLE=41, 1) scopes the opt-out to
    this process only; failure is harmless.
    """
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(41, 1, 0, 0, 0)
    except Exception:  # pragma: no cover - best-effort
        pass


def _keep_large_allocations() -> None:
    """Serve large mallocs from the reusable heap instead of mmap.

    glibc mmaps allocations above M_MMAP_THRESHOLD and munmaps them on
    free, returning the pages to the kernel. On the target VMs guest
    pages released to the kernel lose their host backing (free-page
    reporting), so every fresh large buffer — the decoded BAM, payload
    buffers, site arrays, NW job tensors — re-pays first-touch faults
    that run as slow as ~30 MB/s, dominating whole host stages on
    repeat runs. Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD keeps those
    buffers inside the process heap where freed pages stay backed:
    measured 2-8 GB/s refills vs 30-60 MB/s without (alloc+fill 128 MB
    loop). Costs peak-RSS retention only; the VMs have >100 GB RAM.
    """
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:  # pragma: no cover - best-effort
        pass


_enable_compilation_cache()
_enable_x64()
_disable_thp()
_keep_large_allocations()

from .options import Options  # noqa: F401
