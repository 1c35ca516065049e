"""Machine-local AOT-export cache for hot jit variants.

A fresh process pays ~1-2 s per jit variant before its first dispatch:
Python tracing (~0.9 s for the fused sweep chain) plus the XLA
persistent-cache executable deserialize (~0.8 s). The reference's rayon
pool has zero per-process warm-up (parse_cmd_line.rs:153-156), so on
multi-process runs this fixed cost is pure scaling loss: the round-3
scaling capture measured cold efficiency 0.73-0.79 at 2-4 processes
against a 0.95 steady state, almost entirely per-rank trace time.

Fix: serialize the *traced* program once per machine. The first process
to hit a (function, static-args, input-avals) variant exports it with
`jax.export` and writes the StableHLO blob next to the XLA persistent
cache; every later process deserializes the blob (~2 ms) and jits the
exported call — skipping Python tracing entirely and going straight to
the XLA compile, which the persistent cache already serves. Measured on
the sweep chain (CPU backend, warm caches): 1.94 s jit first-call ->
0.68 s via the blob, outputs bit-identical (the exported module is the
same StableHLO the jit path lowers to, so XLA compiles the same
program; pinned by tests/test_aotcache.py).

Gating mirrors the XLA persistent cache (floria_tpu/__init__.py): on a
CPU backend the cache only engages when FLORIA_CPU_CACHE=1 (so the
test suite's throwaway processes don't churn the cache); FLORIA_AOT=0
kills it everywhere. Blobs live in floria_tpu.cache_dir(), keyed on
jax version, backend platform, a fingerprint of the kernel/phase
sources (stale blobs die with the code that traced them), the function
tag + static args, and the input avals. Writes are atomic (tmp + rename), failures fall back to the
plain jit path.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger("floria_tpu")

# (key) -> callable. Populated under _LOCK; callables are jit-wrapped
# exported modules (or the original fn on fallback).
_MEMO: Dict[Tuple, Callable] = {}
_LOCK = threading.Lock()
_FINGERPRINT: Optional[str] = None
_DISABLED_REASON: Optional[str] = None


def _cache_dir() -> str:
    from . import cache_dir

    return cache_dir()


def _enabled() -> bool:
    """Active exactly when the XLA persistent cache is (plus a kill
    switch): without the compile cache the blob only saves trace time
    and every throwaway test process would write blobs."""
    if os.environ.get("FLORIA_AOT") == "0":
        return False
    import jax

    if jax.default_backend() == "cpu" and os.environ.get(
            "FLORIA_CPU_CACHE") != "1":
        return False
    return True


def _code_fingerprint() -> str:
    """Hash of EVERY .py in the package: a blob traced by old code must
    not serve new code. The traced sweep-chain program bakes in more
    than kernels/ (constants.py thresholds, frag.py's phred table,
    options quantization — advisor round 4), so the fingerprint covers
    the whole package rather than tracking an include list that can go
    stale; the cost is one pass over ~50 small files, once."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        h = hashlib.sha1()
        pkg = os.path.dirname(os.path.abspath(__file__))
        files = []
        for root, dirs, names in os.walk(pkg):
            dirs.sort()
            for name in sorted(names):
                if name.endswith(".py"):
                    files.append(os.path.join(root, name))
        for path in files:
            with open(path, "rb") as fh:
                h.update(fh.read())
        _FINGERPRINT = h.hexdigest()[:16]
    return _FINGERPRINT


def _blob_key(tag: str, static_key: Tuple, args) -> Tuple[str, Tuple]:
    """(file-name hash, memo key) for one variant."""
    import jax

    avals = tuple(
        (tuple(getattr(a, "shape", ())), str(getattr(a, "dtype", "?")))
        for a in args)
    memo_key = (tag, static_key, avals)
    h = hashlib.sha1()
    h.update(repr((jax.__version__, jax.default_backend(),
                   _code_fingerprint(), memo_key)).encode())
    return h.hexdigest()[:24], memo_key


def _index_note(digest: str, memo_key: Tuple) -> None:
    """Append one human-readable line per variant resolution to
    aotexp_index.jsonl — the variant census behind cold-start cost
    (every line is one trace-or-deserialize a fresh process pays)."""
    try:
        import json

        os.makedirs(_cache_dir(), exist_ok=True)
        with open(os.path.join(_cache_dir(), "aotexp_index.jsonl"),
                  "a") as fh:
            fh.write(json.dumps(
                {"pid": os.getpid(), "digest": digest,
                 "tag": memo_key[0], "static": list(memo_key[1]),
                 "avals": [list(a[0]) + [a[1]] for a in memo_key[2]]})
                + "\n")
    except Exception:  # pragma: no cover - diagnostics only
        pass


def _build(tag: str, static_key: Tuple, fn: Callable, args) -> Callable:
    """Resolve one variant: blob hit -> jit(exported.call); miss ->
    export fn, write the blob, and still run through the exported call
    so warm and cold processes compile the identical module (one shared
    XLA persistent-cache entry, identical numerics)."""
    import jax
    from jax import export as jexport

    digest, memo_key = _blob_key(tag, static_key, args)
    path = os.path.join(_cache_dir(), f"aotexp_{digest}.bin")
    _index_note(digest, memo_key)
    exp = None
    if os.path.exists(path):
        try:
            with open(path, "rb") as fh:
                exp = jexport.deserialize(fh.read())
        except Exception as e:  # stale/corrupt blob: rebuild
            logger.debug("aotcache: dropping unreadable blob %s (%s)",
                         path, e)
            try:
                os.unlink(path)
            except OSError:
                pass
            exp = None
    if exp is None:
        exp = jexport.export(fn)(*args)
        try:
            os.makedirs(_cache_dir(), exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                fh.write(exp.serialize())
            os.replace(tmp, path)
        except Exception as e:  # pragma: no cover - cache best-effort
            logger.debug("aotcache: blob write failed for %s (%s)",
                         path, e)
    return jax.jit(exp.call)


def call(tag: str, static_key: Tuple, fn: Callable, args):
    """Dispatch fn(*args) through the machine-local AOT cache.

    fn must be a jit-wrapped function whose output depends only on args
    and static_key; args must be arrays (their shapes/dtypes key the
    variant). Any failure falls back to the plain jit path for the rest
    of the process.
    """
    global _DISABLED_REASON
    if _DISABLED_REASON is not None or not _enabled():
        return fn(*args)
    try:
        _, memo_key = _blob_key(tag, static_key, args)
    except Exception as e:  # pragma: no cover - defensive
        _DISABLED_REASON = str(e)
        logger.warning("aotcache disabled: %s", e)
        return fn(*args)
    cached = _MEMO.get(memo_key)
    if cached is None:
        with _LOCK:
            cached = _MEMO.get(memo_key)
            if cached is None:
                try:
                    cached = _build(tag, static_key, fn, args)
                except Exception as e:
                    logger.warning(
                        "aotcache: export path failed for %s%s (%s); "
                        "falling back to jit", tag, static_key, e)
                    cached = fn
                _MEMO[memo_key] = cached
    return cached(*args)


def reset() -> None:
    """Drop the in-process memo (tests)."""
    global _DISABLED_REASON
    with _LOCK:
        _MEMO.clear()
        _DISABLED_REASON = None
