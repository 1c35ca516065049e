"""Multi-host execution: contig sharding across processes.

The reference is a single shared-memory process (SURVEY.md §2.3). For
multi-process runs, floria-tpu distributes by the natural outer axis:
contigs. Each host process ingests only its share of contigs (the BAM is
scanned once per process but only assigned contigs are decoded into
fragments), phases its blocks on its local devices, and writes its own
per-contig output directories — per-contig outputs are independent, so no
output synchronization is needed beyond the shared contig_ploidy_info.tsv
(written per-host as contig_ploidy_info.<proc>.tsv and merged by rank 0
at the end).

Each process drives ONE accelerator: process i of a host takes local
card i mod (cards on the host) (_local_device_ids), so several processes
on a 4-card host never open each other's cards. Block-level sharding
across a process's visible devices happens inside phase/local.py, and
no cross-process traffic is needed during phasing at all.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import List, Optional

from ..options import Options


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """jax.distributed.initialize wrapper; no-op when single-process.
    Returns this process's index."""
    import jax

    if num_processes is None or num_processes <= 1:
        return 0
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        # Already initialized (a second run_multihost in this process,
        # or a caller that initialized before heavy imports).
        _allow_rank_cache_writes()
        return jax.process_index()
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes, process_id=process_id,
            local_device_ids=_local_device_ids(process_id))
    except RuntimeError as e:
        # Tolerate a caller that already initialized; everything else
        # is a real failure.
        if "already" not in str(e) and "once" not in str(e):
            raise
    _allow_rank_cache_writes()
    return jax.process_index()


def _local_device_ids(process_id: int) -> Optional[List[int]]:
    """The one local GPU this process drives: process_id modulo the
    GPUs on this host. Without the restriction every process would open
    every card and reserve most of its memory, so the second process on
    a card runs out. None (no restriction) when JAX_LOCAL_DEVICE_IDS
    says otherwise — jax.distributed reads it — or the host has no
    NVIDIA GPU; jax.distributed applies the ids to CUDA/ROCm only."""
    if os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        return None
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        n = len([v for v in visible.split(",") if v.strip()])
    else:
        n = len(glob.glob("/dev/nvidia[0-9]*"))
    return [process_id % n] if n else None


def _allow_rank_cache_writes() -> None:
    """Let every rank persist its XLA compilations, not just rank 0.

    jax._src.compiler._cache_write hard-gates persistent-cache writes to
    process 0 — a write-contention guard for shared network
    filesystems. Under contig sharding each rank jits ITS OWN shard's
    shape variants, which rank 0 never compiles, so with the gate every
    rank > 0 silently re-pays its full compile bill on every restart
    (measured: 35 s/rank on the 16-contig CPU scaling bench vs 7 s for
    rank 0). This framework configures machine-local cache dirs
    (floria_tpu.__init__._enable_compilation_cache), where concurrent
    writes are unique-key temp+rename files — safe — so lift the gate by
    rebinding the function's view of `distributed` to a process_id-0
    stub (the code itself is unchanged; reads were never gated).
    Best-effort: a JAX that renames these internals just keeps the
    stock rank-0-only behavior."""
    try:
        import types

        from jax._src import compiler as _compiler

        orig = _compiler._cache_write
        if getattr(orig, "_floria_rank_writes", False):
            return
        stub = types.SimpleNamespace(global_state=types.SimpleNamespace(
            process_id=0))
        patched = types.FunctionType(
            orig.__code__, {**orig.__globals__, "distributed": stub},
            orig.__name__, orig.__defaults__, orig.__closure__)
        patched._floria_rank_writes = True  # type: ignore[attr-defined]
        _compiler._cache_write = patched
        logging.getLogger(__name__).debug(
            "persistent-cache writes enabled for all ranks")
    except Exception as e:  # pragma: no cover - cache remains rank-0-only
        logging.getLogger(__name__).info(
            "rank>0 persistent-cache writes unavailable (%s): rank>0 "
            "processes will re-compile their shard's jit variants on "
            "every restart", e)


def contigs_for_process(contigs: List[str], process_id: int,
                        num_processes: int,
                        weights: Optional[List[float]] = None
                        ) -> List[str]:
    """Deterministic contig shard for one process.

    Without weights: round-robin by index (stable under any contig
    count). With per-contig work weights (SNP counts — block count and
    read count both track them): LPT greedy — contigs in descending
    weight order, each to the currently lightest shard — so one giant
    contig can't pin scaling efficiency below target on real
    metagenomes (the reference's rayon pool load-balances dynamically,
    parse_cmd_line.rs:153-156; a static shard must balance up front).
    Every process computes the identical assignment independently; ties
    break by (weight, index) and lowest process id, so the result is a
    partition regardless of float weirdness. Within a shard, original
    contig order is preserved (deterministic group batching)."""
    if weights is None:
        return [c for i, c in enumerate(contigs)
                if i % num_processes == process_id]
    if len(weights) != len(contigs):
        raise ValueError("weights/contigs length mismatch")
    order = sorted(range(len(contigs)),
                   key=lambda i: (-float(weights[i]), i))
    load = [0.0] * num_processes
    count = [0] * num_processes
    assign: List[List[int]] = [[] for _ in range(num_processes)]
    for i in order:
        p = min(range(num_processes),
                key=lambda q: (load[q], count[q], q))
        load[p] += float(weights[i])
        count[p] += 1
        assign[p].append(i)
    return [contigs[i] for i in sorted(assign[process_id])]


def run_multihost(options: Options, num_processes: int, process_id: int,
                  coordinator: Optional[str] = None) -> None:
    """Phase this process's contig shard, then merge summary TSVs on
    rank 0 after a cross-process barrier."""
    # Distributed init must precede anything that could initialize the
    # XLA backend (including transitively-imported modules).
    initialize_distributed(coordinator, num_processes, process_id)
    from ..ingest import bam as bamlib
    from ..pipeline import run
    all_contigs = bamlib.get_contigs_to_phase(options.bam_file)
    weights = None
    if num_processes > 1:
        # Work-aware sharding: per-contig SNP count (block count and
        # read count both scale with it). Every rank derives the same
        # weights from the same VCF, so the assignment is consistent.
        weights = [_contig_snp_counts(options.vcf_file).get(c, 0)
                   for c in all_contigs]
    mine = contigs_for_process(all_contigs, process_id, num_processes,
                               weights)
    options.list_to_phase = (
        [c for c in mine if c in options.list_to_phase]
        if options.list_to_phase else mine)
    # Each process appends to its OWN summary TSV from the start —
    # concurrent appends to a shared file would interleave rows.
    if num_processes > 1:
        options.ploidy_tsv = f"contig_ploidy_info.{process_id}.tsv"
    os.makedirs(options.out_dir, exist_ok=True)
    tsv_path = os.path.join(options.out_dir, options.ploidy_tsv)
    if not os.path.exists(tsv_path):
        from .. import constants

        with open(tsv_path, "w") as fh:
            fh.write(constants.CONTIG_PLOIDY_HEADER)
    run(options)
    _barrier(num_processes)
    if process_id == 0 and num_processes > 1:
        _merge_ploidy_tsvs(options, all_contigs)


def _contig_snp_counts(vcf_file: str) -> dict:
    """{contig: SNP count} for the whole VCF, cached persistently
    (mtime/size-validated sidecar under the machine-local cache dir):
    the full-VCF scan this replaces cost ~0.7 s per rank per pass on
    the 500-contig scaling config — a fixed cost that erodes steady
    multi-process efficiency."""
    import hashlib
    import json

    st = os.stat(vcf_file)
    from .. import cache_dir as _cache_dir

    cache_dir = _cache_dir()
    key = hashlib.sha1(os.path.abspath(vcf_file).encode()).hexdigest(
    )[:16]
    path = os.path.join(cache_dir, f"vcfsnps_{key}.json")
    try:
        with open(path) as fh:
            sc = json.load(fh)
        if (sc["mtime_ns"] == st.st_mtime_ns
                and sc["size"] == st.st_size):
            return sc["num_snps"]
    except (OSError, ValueError, KeyError):
        pass
    from ..ingest.vcf import read_vcf

    profile = read_vcf(vcf_file)  # unrestricted: reusable for any BAM
    counts = {c: cv.num_snps for c, cv in profile.contigs.items()}
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"mtime_ns": st.st_mtime_ns, "size": st.st_size,
                       "num_snps": counts}, fh)
        os.replace(tmp, path)
    except OSError:
        pass
    return counts


def _barrier(num_processes: int) -> None:
    """All processes must have written their TSVs before rank 0 merges.

    Uses the coordination-service barrier, not a device collective:
    sync_global_devices lazily builds the CPU backend's Gloo mesh with
    a ~30 s connect window, so rank completion skew beyond that (normal
    at hundreds of contigs per shard) kills the run. The KV-store
    barrier rides the connection jax.distributed.initialize already
    holds and tolerates hours of skew."""
    if num_processes <= 1:
        return
    import jax

    if jax.process_count() <= 1:
        return
    try:
        from jax._src import distributed

        client = distributed.global_state.client
        if client is not None:
            client.wait_at_barrier("floria_tpu_tsv_merge",
                                   6 * 3600 * 1000)
            return
    except Exception:
        pass  # fall back to the collective barrier
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("floria_tpu_tsv_merge")


def _merge_ploidy_tsvs(options: Options,
                       contig_order: List[str]) -> None:
    """Merge per-process TSVs into one, rows in contig order."""
    from .. import constants

    rows = {}
    for path in glob.glob(os.path.join(options.out_dir,
                                       "contig_ploidy_info.*.tsv")):
        with open(path) as fh:
            for line in fh:
                if line.startswith("contig\t") or not line.strip():
                    continue
                rows[line.split("\t", 1)[0]] = line
    with open(os.path.join(options.out_dir,
                           "contig_ploidy_info.tsv"), "w") as out:
        out.write(constants.CONTIG_PLOIDY_HEADER)
        for contig in contig_order:
            if contig in rows:
                out.write(rows[contig])
