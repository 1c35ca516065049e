"""Local phasing engine: per-block ploidy sweep.

Drives the device beam-search kernel over every (block, ploidy) instance of
a contig, refines each result with UPEM, and applies the reference's two
stopping rules to pick the local strain count
(graph_processing.rs:103-304).

Device-first deviation from the reference control flow: the reference sweeps
ploidies sequentially per block and early-exits (graph_processing.rs:132).
We phase ALL (block, ploidy) instances as shape-bucketed device batches and
then replay the stopping rules on the completed MEC vectors — the chosen
ploidy and partitions are identical because each sweep step only reads MEC
values of earlier ploidies, never whether later ones ran.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import aotcache, constants, threads, timing
from ..kernels import beam as beam_kernel
from ..kernels.blocktensor import BlockTensor, pack_block, round_up
from ..options import Options
from .blocks import (find_reads_in_interval, get_range_with_lengths,
                     interval_bounds)


@dataclasses.dataclass
class LocalBlockResult:
    """Chosen partition of one block."""
    block_index: int
    snp_range: Tuple[int, int]
    best_ploidy: int
    # read counter-id sets per part (may be empty), parts in part order
    part_frag_ids: List[np.ndarray]
    mec_vector: np.ndarray


def mec_threshold(ploidy: int, epsilon: float, sensitivity: int) -> float:
    """MEC-ratio stopping threshold (graph_processing.rs:205-222)."""
    if sensitivity == 1:
        denom = 1.0 + 1.0 / (ploidy ** 0.5 + 1.0)
    elif sensitivity == 2:
        denom = 1.0 + 1.0 / (ploidy ** 1.0 + 1.0 / 3.0)
    else:
        denom = 1.0 + 1.0 / (ploidy ** 1.0 + 1.0)
    return 1.0 / (1.0 - epsilon) / denom


def pick_best_ploidy(mec_vector: np.ndarray, expected_errors: np.ndarray,
                     options: Options) -> int:
    """Replay of the sweep's stopping logic (graph_processing.rs:198-252).

    mec_vector[p-1] is the total MEC-epsilon error at ploidy p;
    expected_errors[p-1] = (#alleles at ploidy p) * epsilon.
    """
    max_ploidy = len(mec_vector)
    best = 1
    for ploidy in range(1, max_ploidy + 1):
        best = ploidy
        m = mec_vector[ploidy - 1]
        if ploidy > 1:
            prev = mec_vector[ploidy - 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = m / prev  # inf or nan on zero, like Rust f64
            threshold = mec_threshold(ploidy, options.epsilon,
                                      options.ploidy_sensitivity)
            if not (ratio < threshold):  # nan compares False, like Rust
                if options.stopping_heuristic:
                    best = ploidy - 1
                    break
        if m < expected_errors[ploidy - 1]:
            break
    return best


def _sweep_decide(mec_vector: np.ndarray, expected_errors: np.ndarray,
                  ploidy: int, options: Options) -> Tuple[bool, int]:
    """One level of pick_best_ploidy's sequential walk: given MEC stats
    through `ploidy`, (decided, best). Exactly equivalent to running
    pick_best_ploidy on the full vector (pinned by
    tests/test_kernels.py::test_sweep_decide_matches_pick_best)."""
    max_ploidy = len(mec_vector)
    m = mec_vector[ploidy - 1]
    if ploidy > 1:
        prev = mec_vector[ploidy - 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = m / prev
        threshold = mec_threshold(ploidy, options.epsilon,
                                  options.ploidy_sensitivity)
        if not (ratio < threshold):
            if options.stopping_heuristic:
                return True, ploidy - 1
    if m < expected_errors[ploidy - 1]:
        return True, ploidy
    if ploidy == max_ploidy:
        return True, ploidy
    return False, ploidy


# Per-dispatch batch budget in read-site cells (see _sweep_launch).
# A device that answers a pull in under 5 ms gets the small cap (about
# G=8 at the real R=320, S=2048 block shape); a slower round trip gets
# the large one, which trades per-read speed for fewer dispatches.
# Neither cap has been re-measured on a GPU (ROADMAP design debt 3.4).
# Chunking is output-invariant
# (test_dispatch_cap_chunking_is_output_invariant). `--sweep-cap auto`
# (the default) probes the dispatch round-trip once and picks; env
# FLORIA_SWEEP_CAP_CELLS > --sweep-cap N > auto probe.
_SWEEP_CAP_CELLS = 1 << 26
_SWEEP_CAP_CELLS_LOCAL = 8 * 320 * 2048  # near-G=8 at the real shape
_probed_cap: Optional[int] = None


def _probe_link_cap() -> int:
    """Pick the dispatch cap from a measured device round trip (a
    tiny pull). Probed once per process: the answer is a property of
    the device, not the workload."""
    global _probed_cap
    if _probed_cap is None:
        import jax
        import jax.numpy as jnp

        try:
            x = jnp.arange(8, dtype=jnp.int32)
            np.asarray(x + 1)  # compile + warm
            t0 = time.time()
            for _ in range(3):
                np.asarray(x + 1)
            rt = (time.time() - t0) / 3
        except Exception:  # pragma: no cover - backend init failure
            rt = 1.0
        _probed_cap = (_SWEEP_CAP_CELLS_LOCAL if rt < 0.005
                       else _SWEEP_CAP_CELLS)
        logging.getLogger("floria_tpu").debug(
            "sweep-cap auto: round trip %.4fs -> cap %d cells", rt,
            _probed_cap)
    return _probed_cap


def _sweep_cap_cells(options: Optional[Options] = None) -> int:
    import os

    v = os.environ.get("FLORIA_SWEEP_CAP_CELLS")
    if v and v.strip():
        try:
            return int(v)
        except ValueError:
            raise ValueError(
                f"FLORIA_SWEEP_CAP_CELLS must be an integer "
                f"(read-site cells per dispatch), got {v!r}") from None
    cap = getattr(options, "sweep_cap", "auto") if options else "auto"
    if cap != "auto":
        return int(cap)
    return _probe_link_cap()


# --- shape bucketing -------------------------------------------------------

def _parallel_launch(fn, items: list) -> list:
    """Run per-shape-group device launches from a small thread pool.

    The first call of each (function, shape) variant blocks on trace +
    executable-deserialize; a pool overlaps those while on-device
    execution serializes regardless. Falls back to the plain loop for a
    single group. jit dispatch is thread-safe, results are per-group,
    so outputs are unchanged.

    Pool width follows the host worker budget (`-t`, threads.py) capped
    at 4, and `-t 1` must serialize (the reference's single-thread
    mode, parse_cmd_line.rs:153-156). Whether the pool pays on a GPU is
    ROADMAP design debt 3.4."""
    workers = min(4, threads.num_threads(), len(items))
    if len(items) <= 1 or workers <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


def _bucket_reads(r: int) -> int:
    """Power-of-two below 128, then 64-multiples: every padding read row
    costs a full (wasted) scan step, so tighter buckets beat fewer
    compile variants once blocks are large."""
    if r <= 128:
        return max(16, 1 << (r - 1).bit_length())
    return round_up(r, 64)


def _bucket_cache_rows(b: int) -> int:
    """Pad the BlockDeviceCache batch dim: pow2 (floor 8) below 128,
    then 64-multiples — resident-cache memory overhead stays <=2x
    (<=+20% above 128) while contigs with nearby block counts share one
    sweep-chain jit variant instead of minting one each. Small contigs
    (the many-contig metagenome case, where variant sharing pays) all
    land in the pow2 region; above 128 a dataset rarely has many
    distinct contigs per bucket, so the finer 64 step trades variant
    sharing for upload bytes (the E. coli contig's 296 blocks pad to
    320, +8%, instead of 384, +30%)."""
    if b <= 128:
        return max(8, 1 << (b - 1).bit_length())
    return round_up(b, 64)


def _bucket_sites(s: int) -> int:
    """Coarse site buckets: few compile variants beats tight padding —
    the padded compute is cheap, a fresh XLA variant is not."""
    s = max(s, 64)
    if s <= 256:
        return round_up(s, 128)
    if s <= 1024:
        return round_up(s, 256)
    return round_up(s, 512)


def phase_contig_blocks(frags: Sequence, snp_to_genome_pos: np.ndarray,
                        options: Options,
                        debug_dir: Optional[str] = None
                        ) -> List[LocalBlockResult]:
    """Phase every SNP block of one contig; returns one result per
    non-empty block, in block order (empty blocks are dropped, like the
    None return at graph_processing.rs:129-131)."""
    return phase_contigs_blocks(
        [("__single__", frags, snp_to_genome_pos, debug_dir)],
        options)["__single__"]


def phase_contigs_blocks(per_contig, options: Options
                         ) -> Dict[object, List[LocalBlockResult]]:
    """Phase the SNP blocks of MANY contigs in shared device batches.

    per_contig: [(contig_key, sorted frozen frags, snp_to_genome_pos,
    debug_dir or None)]. Blocks from every contig bucket together — an
    instance is identified by (contig index, block index) — so a whole
    contig group costs the same dispatch rounds as one contig.
    """
    blocks: List[Tuple[Tuple[int, int], BlockTensor]] = []
    contig_frags = {}
    for ci, (ckey, frags, snp_to_genome_pos, _dbg) in enumerate(
            per_contig):
        contig_frags[ci] = frags
        ranges = get_range_with_lengths(
            snp_to_genome_pos, options.block_length,
            options.block_length // 3, options.snp_density)
        bounds = interval_bounds(frags)
        for j, rng in enumerate(ranges):
            reads = find_reads_in_interval(rng[0], rng[1], frags,
                                           bounds=bounds)
            bt = pack_block(reads, rng)
            if bt is not None:
                blocks.append(((ci, j), bt))
    out: Dict[object, List[LocalBlockResult]] = {
        ckey: [] for ckey, *_rest in per_contig}
    if not blocks:
        return out

    chosen, mec_vec, _exp_vec = adaptive_sweep(blocks, options)

    for (ci, j), bt in blocks:
        ckey = per_contig[ci][0]
        debug_dir = per_contig[ci][3]
        mec_vector = mec_vec[(ci, j)]
        best_ploidy, assignment = chosen[(ci, j)]
        part_ids = [bt.frag_ids[assignment == p]
                    for p in range(best_ploidy)]
        out[ckey].append(LocalBlockResult(
            block_index=j, snp_range=bt.snp_range,
            best_ploidy=best_ploidy, part_frag_ids=part_ids,
            mec_vector=mec_vector))
        if debug_dir is not None:
            _dump_local_parts(debug_dir, j, bt, part_ids, best_ploidy,
                              contig_frags[ci])
    return out


def adaptive_sweep(blocks, options: Options,
                   cache: Optional["BlockDeviceCache"] = None) -> Tuple[
                       Dict[object, Tuple[int, np.ndarray]],
                       Dict[object, np.ndarray],
                       Dict[object, np.ndarray]]:
    """The production ploidy sweep over a list of (key, BlockTensor)
    instances: adaptive level-wise dispatch with chained beam->UPEM
    device waves and host-side stopping-rule replay.

    Returns ({key: (best_ploidy, assignment)}, {key: mec_vector},
    {key: expected_errors}). Factored out of phase_contigs_blocks so the
    multi-chip dryrun (__graft_entry__.dryrun_multichip) certifies the
    exact dispatch path the pipeline runs.
    """
    _log = logging.getLogger("floria_tpu")
    sweep_t = time.time()
    if cache is None:
        cache = BlockDeviceCache(blocks)
    max_p = options.max_ploidy
    mec_vec = {key: np.zeros(max_p) for key, _bt in blocks}
    exp_vec = {key: np.zeros(max_p) for key, _bt in blocks}
    chosen: Dict[object, Tuple[int, np.ndarray]] = {}
    # Adaptive level-wise sweep, mirroring the reference's sequential
    # per-block early exit (graph_processing.rs:198-252): ploidy p runs
    # only for blocks still undecided after p-1, at its EXACT ploidy.
    # Each level is ONE wave of chained beam->UPEM device dispatches
    # (_sweep_launch/_sweep_pull): the beam traceback feeds UPEM on device, so a
    # level costs a single result-pull round trip. (Launching ALL
    # levels speculatively would waste ~2.5x the device compute on
    # discarded levels.)
    prev_assign: Dict[object, np.ndarray] = {}
    active = blocks
    # Optional depth-1 speculation (FLORIA_SWEEP_SPEC=1): level p+1
    # launches for the PRE-decision active set while level p's results
    # are in flight. Per-block results are independent of batch
    # composition (pinned by the mixed-ploidy tests), so decisions and
    # outputs are identical either way. Default OFF: it burns the
    # discarded level's compute, and no measurement has shown it paying
    # (ROADMAP design debt 3.4).
    import os as _os
    speculate = _os.environ.get("FLORIA_SWEEP_SPEC", "0") != "0"
    # Levels 1 and 2 run as ONE fused wave ((1, 2) entry,
    # _sweep_chain_fn fused12): level 1 is a near-free MEC evaluation
    # and almost every block proceeds to 2, so the fuse removes a full
    # launch+decide+pull round per contig. The decision replay below
    # still walks level by level, so decisions and outputs are
    # identical to the sequential schedule (the speculative path keeps
    # the per-level schedule — its pending_next bookkeeping assumes
    # one level per wave).
    if max_p >= 2 and not speculate:
        schedule = [(1, 2)] + list(range(3, max_p + 1))
    else:
        schedule = list(range(1, max_p + 1))
    pending_next = None
    for entry in schedule:
        if not active:
            break
        lvl_t = time.time()
        pending_cur = (pending_next if pending_next is not None else
                       _sweep_launch(active, options, cache, [entry]))
        levels = entry if isinstance(entry, tuple) else (entry,)
        pending_next = (_sweep_launch(active, options, cache,
                                      [levels[-1] + 1])
                        if speculate and levels[-1] < max_p else None)
        launch_s = time.time() - lvl_t
        refined_p, stats_p = _sweep_pull(pending_cur)
        _log.debug("sweep level %s: %d blocks, launch %.2fs, "
                   "exec+pull %.2fs", entry, len(active), launch_s,
                   time.time() - lvl_t - launch_s)
        next_active = []
        for key, bt in active:
            undecided = True
            for ploidy in levels:
                good, bad = stats_p[(key, ploidy)]
                mec_vec[key][ploidy - 1] = bad
                exp_vec[key][ploidy - 1] = (good + bad) * options.epsilon
                decided, best = _sweep_decide(mec_vec[key],
                                              exp_vec[key],
                                              ploidy, options)
                if decided:
                    a = (refined_p[(key, ploidy)] if best == ploidy
                         else prev_assign[key])
                    chosen[key] = (best, a)
                    undecided = False
                    break
                prev_assign[key] = refined_p[(key, ploidy)]
            if undecided:
                next_active.append((key, bt))
        active = next_active
    _log.info("Beam search: %d blocks, adaptive chained sweep <= %d in "
              "%.2fs", len(blocks), max_p, time.time() - sweep_t)
    return chosen, mec_vec, exp_vec


def _dump_local_parts(debug_dir: str, j: int, bt: BlockTensor, part_ids,
                      best_ploidy: int, frags) -> None:
    """Per-block partition dump at debug level, the reference's
    local_parts/ artifact (graph_processing.rs:289-300)."""
    import os

    os.makedirs(debug_dir, exist_ok=True)
    name = f"{j}-0-{bt.snp_range[0]}-{best_ploidy}"
    with open(os.path.join(debug_dir, name), "w") as f:
        for p, ids in enumerate(part_ids):
            f.write(f"#{p}\n")
            for fid in ids:
                fr = frags[int(fid)]
                f.write(f"{fr.id}\t{fr.first_position}\t"
                        f"{fr.last_position}\n")


class BlockDeviceCache:
    """Unique block tensors resident on device, bucketed by padded
    shape. Blocks are uploaded ONCE per contig group; the beam and UPEM
    stages assemble their per-(block, ploidy) instance batches by
    on-device gathers from these arrays instead of re-packing and
    re-uploading the same reads once per ploidy (a 4x+5x transfer
    saving on the default 2..5 sweep)."""

    def __init__(self, blocks: List[Tuple[int, BlockTensor]]):
        import jax

        up_t = time.time()
        buckets: Dict[Tuple[int, int],
                      List[Tuple[int, BlockTensor]]] = {}
        for j, bt in blocks:
            key = (_bucket_reads(bt.num_reads),
                   _bucket_sites(bt.num_sites))
            buckets.setdefault(key, []).append((j, bt))
        self.rows: Dict[object, int] = {}
        self.dev: Dict[Tuple[int, int], Tuple[object, object]] = {}
        # Actual allele-value width per bucket (e.g. 2 on biallelic
        # data): kernels dispatched with this instead of MAX_ALLELES
        # skip count planes that are identically zero — exact, at half
        # the state traffic in the common case.
        self.amax: Dict[Tuple[int, int], int] = {}
        for (r_pad, s_pad), members in buckets.items():
            # Bucket the resident batch dim too: an unpadded B makes
            # every contig's block count a brand-new jit variant of the
            # whole sweep chain (the 500-contig scaling census measured
            # 96 of 104 cold-start variants coming from distinct Bs —
            # ~20 s of per-process trace/deserialize). Padded rows are
            # unreachable (idx gathers only real rows, aotexp_index
            # census in VALIDATION.md), so this is output-invariant;
            # memory cost is bounded by pow2 below 128 / 64-multiples
            # above 128 (<= +20% overhead, _bucket_cache_rows).
            B = _bucket_cache_rows(len(members))
            alleles = np.full((B, r_pad, s_pad), -1, dtype=np.int8)
            quals = np.zeros((B, r_pad, s_pad), dtype=np.uint8)
            for b, (j, bt) in enumerate(members):
                r, s = bt.alleles.shape
                alleles[b, :r, :s] = bt.alleles
                quals[b, :r, :s] = bt.quals
                self.rows[j] = b
            self.amax[(r_pad, s_pad)] = min(
                constants.MAX_ALLELES, max(2, int(alleles.max()) + 1))
            # Resident cache stays int8 alleles + uint8 quals (2 B/cell)
            # — f32 weights materialize per DISPATCH at gather time, so
            # resident memory doesn't scale with contig size times 4.
            dev_a = jax.device_put(alleles)
            dev_q = jax.device_put(quals)
            self.dev[(r_pad, s_pad)] = (dev_a, dev_q)
        timing.add("beam.cache_upload", time.time() - up_t)

    def gather(self, key: Tuple[int, int], block_ids: List[object]):
        """Device-side [G, r_pad, s_pad] (alleles, weights) for the
        given blocks, in order (duplicates fine). Weights reconstruct
        from the cached uint8 quals on device (gather-then-convert ==
        convert-then-gather bitwise: the conversion is an elementwise
        table lookup)."""
        import jax.numpy as jnp

        dev_a, dev_q = self.dev[key]
        idx = jnp.asarray(
            np.array([self.rows[j] for j in block_ids], np.int32))
        return (jnp.take(dev_a, idx, axis=0),
                beam_kernel.quals_to_weights(
                    jnp.take(dev_q, idx, axis=0)))


@functools.lru_cache(maxsize=None)
def _sweep_chain_fn(ploidy: int, beam_width: int, window: int,
                    max_alleles: int, fused12: bool = False):
    """ONE jitted program for a whole sweep level on one device:
    cache gather -> device weight reconstruction -> mixed beam ->
    on-device traceback -> device UPEM. Fusing the chain collapses the
    ~6 jit variants per (shape, ploidy) the split dispatches cost into
    one executable — a fresh process used to pay ~0.3-1 s of trace +
    AOT-deserialize PER variant (72 variants on a 125-contig shard =
    13-16 s of the 4-process scaling run's per-rank fixed cost).

    fused12 (requires ploidy == 2): ONE program computing sweep levels
    1 AND 2 — level 1's unit-weight MEC stats ride along with level 2's
    beam+UPEM in the same dispatch and pull. Nearly every block
    proceeds past level 1 (a block stops there only when its MEC
    already beats the expected-error floor, graph_processing.rs:240),
    so fusing removes a whole launch+decide+pull round per contig
    without wasting compute; blocks that DO stop at 1 discard the
    level-2 result — a deviation from the reference's strictly
    sequential early exit (graph_processing.rs:132) that trades
    their level-2 compute for the level round trip, outputs
    identical. Level 1's refined assignment is NOT returned: it is
    all-zeros by construction (UPEM needs >=2 parts to move), so the
    host synthesizes it without a download."""
    import jax
    import jax.numpy as jnp

    from ..kernels.upem_batch import _eval_mec, upem_optimize_device

    assert not (fused12 and ploidy != 2)

    @jax.jit
    def chain(dev_a, dev_q, idx, nreads, eps):
        alleles = jnp.take(dev_a, idx, axis=0)
        if ploidy == 1:
            # UPEM at one part is a no-op (a move needs a second part),
            # so the level-1 chain reduces EXACTLY to the unit-weight
            # MEC stats of the everything-in-part-0 partition — what
            # upem_optimize_device returns there, minus its two full
            # move-evaluation passes and the weight reconstruction
            # (level 1 cost 2.0 s of the 3.4 s warm device time on the
            # E. coli config before this).
            assigns = jnp.zeros(alleles.shape[:2], jnp.int32)
            return assigns, _eval_mec(alleles, assigns, eps, 1,
                                      max_alleles)
        weights = beam_kernel.quals_to_weights(
            jnp.take(dev_q, idx, axis=0))
        nparts = jnp.full(alleles.shape[0], ploidy, jnp.int32)
        result = beam_kernel.beam_search_batch_mixed(
            alleles, weights, nreads, eps, nparts, ploidy,
            beam_width, max_alleles=max_alleles, window=window)
        assigns = beam_kernel.traceback_batch(
            tuple(result)).astype(jnp.int32)
        best, mec, _diff = upem_optimize_device(
            alleles, weights, assigns, nreads, eps, ploidy,
            max_alleles=max_alleles)
        if fused12:
            mec1 = _eval_mec(alleles,
                             jnp.zeros(alleles.shape[:2], jnp.int32),
                             eps, 1, max_alleles)
            return mec1, best, mec
        return best, mec

    return chain


def _sweep_launch(blocks, options: Options, cache: "BlockDeviceCache",
                  ploidies) -> list:
    """Async-launch one wave of chained beam->UPEM dispatch chains for
    every (block, ploidy in ploidies) instance: per shape group and
    level the beam runs, its traceback assignments stay ON DEVICE and
    feed the UPEM hill-climb directly (no host hop for the assignment
    tensors), and only the refined assignments + MEC
    stats are pulled by _sweep_pull, all overlapped. Each level
    dispatches at its exact ploidy, so per-level device results are
    bit-identical to phase_instances + refine_instances (padded-read
    assignment garbage from the device traceback is provably inert: a
    padded read has zero weights and no covered sites, so it contributes
    to no count, score, or move — and moves for it are masked by
    num_reads). The launch/pull split lets the adaptive sweep launch
    level p+1 speculatively while level p's results are in flight."""
    from ..kernels.upem_batch import upem_optimize_device

    import jax.numpy as jnp

    groups: Dict[Tuple[int, int], List[Tuple[object, BlockTensor]]] = {}
    for j, bt in blocks:
        key = (_bucket_reads(bt.num_reads), _bucket_sites(bt.num_sites))
        groups.setdefault(key, []).append((j, bt))
    # Cap each dispatch's batch: a whole-chromosome contig can put
    # thousands of blocks in one shape bucket, and beam device-memory
    # temporaries scale with G x r_pad x s_pad (about 23 GB at
    # G_pad=2048, R=320, S=2048). _SWEEP_CAP_CELLS read-site cells per
    # dispatch (128 blocks at R=320, S=2048) keeps temps a few GB;
    # chunks are per-instance independent, so splitting is
    # output-invariant (test_dispatch_cap_chunking_is_output_invariant).
    cap_cells = _sweep_cap_cells(options)

    import jax

    n_dev = jax.local_device_count()
    if options.num_devices is not None:
        n_dev = min(n_dev, options.num_devices)

    # A (1, 2) entry fuses sweep levels 1+2 into one dispatch
    # (_sweep_chain_fn fused12) — single-device only; the sharded mesh
    # path runs them as separate waves of its generic dispatch.
    if n_dev > 1:
        ploidies = [q for p in ploidies
                    for q in (p if isinstance(p, tuple) else (p,))]
    items = []
    for ploidy in ploidies:
        for key, members in groups.items():
            g_cap = max(1, cap_cells // (key[0] * key[1]))
            # Chunk at next-pow2 of the cap: full chunks then land
            # EXACTLY on their pow2 batch pad (one shared jit variant,
            # zero batch padding) instead of a ~60%-padded odd size per
            # distinct G. Memory is unchanged — the guard always paid
            # for the pow2-padded worst case. Chunk composition never
            # affects per-instance results
            # (test_dispatch_cap_chunking_is_output_invariant).
            g_chunk = 1 << max(0, (g_cap - 1).bit_length())
            for lo in range(0, len(members), g_chunk):
                items.append((ploidy, key, members[lo:lo + g_chunk]))

    def _launch(item):
        ploidy, (r_pad, s_pad), members = item
        G = len(members)
        # pow2 batch dim with a floor of 8: dispatches below 8 are the
        # adaptive sweep's long tail (few undecided blocks at deep
        # ploidies), where padding is absolutely cheap but each distinct
        # G_pad is another jit variant a fresh process must deserialize.
        G_pad = max(8, 1 << max(0, (G - 1)).bit_length())
        nreads = np.zeros(G_pad, dtype=np.int32)
        max_span = 0
        for g, (j, bt) in enumerate(members):
            nreads[g] = bt.num_reads
            max_span = max(max_span, bt.max_read_span())
        eps = np.full(G_pad, options.epsilon, dtype=np.float32)
        ids = [j for j, _bt in members]
        ids += [ids[0]] * (G_pad - G)
        amax = cache.amax[(r_pad, s_pad)]
        # Same sliding-window policy as phase_instances.
        window = round_up(max_span + 128, 256)
        if window * 4 > s_pad:
            window = 0
        if n_dev <= 1:
            # Single-device (the production one-chip-per-host case):
            # the whole level is ONE fused executable (_sweep_chain_fn).
            dev_a, dev_q = cache.dev[(r_pad, s_pad)]
            idx = jnp.asarray(np.array([cache.rows[j] for j in ids],
                                       np.int32))
            # Dispatch through the machine-local AOT-export cache: a
            # fresh process deserializes the traced program (~2 ms)
            # instead of re-tracing it (~0.9 s/variant) — the dominant
            # per-rank fixed cost of multi-process cold starts
            # (aotcache.py; the reference's rayon pool has no analog
            # cost, parse_cmd_line.rs:153-156).
            # x64 wraps trace + export + execution: the chain's beam
            # and UPEM carry exact f64 quanta (kernels/beam.py
            # _require_x64).
            import jax as _jax
            if ploidy == (1, 2):
                static_key = (2, options.max_number_solns, window,
                              amax, True)
                with _jax.enable_x64():
                    mec1, best2, mec2 = aotcache.call(
                        "sweep_chain", static_key,
                        _sweep_chain_fn(*static_key),
                        (dev_a, dev_q, idx, nreads, eps))
                return members, ploidy, best2, (mec1, mec2)
            static_key = (ploidy, options.max_number_solns, window,
                          amax)
            with _jax.enable_x64():
                best, mec = aotcache.call(
                    "sweep_chain", static_key,
                    _sweep_chain_fn(*static_key),
                    (dev_a, dev_q, idx, nreads, eps))
            return members, ploidy, best, mec
        alleles, weights = cache.gather((r_pad, s_pad), ids)
        if ploidy == 1:
            assigns = jnp.zeros((G_pad, r_pad), jnp.int32)
        else:
            nparts = np.full(G_pad, ploidy, dtype=np.int32)
            result = _dispatch_beam(alleles, weights, nreads, eps,
                                    nparts, ploidy,
                                    options.max_number_solns, options,
                                    window=window, max_alleles=amax)
            assigns = beam_kernel.traceback_batch(
                tuple(result)).astype(jnp.int32)
        best, mec, _diff = upem_optimize_device(
            alleles, weights, assigns, nreads, eps, ploidy,
            max_alleles=amax)
        return members, ploidy, best, mec

    launch_t = time.time()
    pending = _parallel_launch(_launch, items)
    # Honest attribution: this span covers only enqueueing the async
    # dispatches (plus first-call trace/deserialize). The chained
    # beam->UPEM device EXECUTION drains inside _sweep_pull's result
    # wait — by design there is exactly one pull per level, so a
    # beam-vs-UPEM execution split is not observable from the host.
    timing.add("phase.launch", time.time() - launch_t)
    for _m, _p, best, mec in pending:
        for a in _result_arrays(best, mec):
            if hasattr(a, "copy_to_host_async"):
                a.copy_to_host_async()
    return pending


def _result_arrays(best, mec) -> list:
    """Flatten one pending item's device results (fused waves carry a
    (mec1, mec2) tuple) in a fixed order shared with _sweep_pull."""
    arrs = list(best) if isinstance(best, tuple) else [best]
    arrs += list(mec) if isinstance(mec, tuple) else [mec]
    return arrs


def _sweep_pull(pending: list) -> Tuple[
        Dict[Tuple[object, int], np.ndarray],
        Dict[Tuple[object, int], Tuple[float, float]]]:
    pull_t = time.time()
    flat, spans = [], []
    for _m, _p, best, mec in pending:
        arrs = _result_arrays(best, mec)
        spans.append(len(flat))
        flat.extend(arrs)
    hosts = _parallel_launch(np.asarray, flat)
    # Chained beam+UPEM device execution AND the result download drain
    # in this wait (see _sweep_launch's attribution note).
    timing.add("phase.wait", time.time() - pull_t)
    refined: Dict[Tuple[object, int], np.ndarray] = {}
    stats: Dict[Tuple[object, int], Tuple[float, float]] = {}
    for (members, ploidy, _b, _m), off in zip(pending, spans):
        if ploidy == (1, 2):
            best2, mec1, mec2 = hosts[off], hosts[off + 1], hosts[
                off + 2]
            for g, (j, bt) in enumerate(members):
                # Level 1's assignment is all-zeros by construction
                # (see _sweep_chain_fn fused12) — synthesized, not
                # downloaded.
                refined[(j, 1)] = np.zeros(bt.num_reads, np.int32)
                stats[(j, 1)] = (float(mec1[g, 0]), float(mec1[g, 1]))
                refined[(j, 2)] = best2[g, :bt.num_reads]
                stats[(j, 2)] = (float(mec2[g, 0]), float(mec2[g, 1]))
            continue
        best = hosts[off]
        mec = hosts[off + 1]
        for g, (j, bt) in enumerate(members):
            refined[(j, ploidy)] = best[g, :bt.num_reads]
            stats[(j, ploidy)] = (float(mec[g, 0]), float(mec[g, 1]))
    return refined, stats


def refine_instances(blocks: List[Tuple[int, BlockTensor]],
                     assignments: Dict[Tuple[int, int], np.ndarray],
                     options: Options,
                     cache: Optional[BlockDeviceCache] = None,
                     ploidies=None) -> Tuple[
                         Dict[Tuple[int, int], np.ndarray],
                         Dict[Tuple[int, int], Tuple[float, float]]]:
    """Batched UPEM refinement + no-phred MEC stats for every
    (block, ploidy) instance, shape-bucketed like phase_instances.

    Returns ({(block, ploidy): refined assignment},
             {(block, ploidy): (bases, errors)}).
    """
    from ..kernels.upem_batch import upem_optimize_device

    if cache is None:
        cache = BlockDeviceCache(blocks)
    if ploidies is None:
        ploidies = range(1, options.max_ploidy + 1)
    groups: Dict[Tuple[int, int, int],
                 List[Tuple[int, BlockTensor]]] = {}
    for ploidy in ploidies:
        for j, bt in blocks:
            key = (ploidy, _bucket_reads(bt.num_reads),
                   _bucket_sites(bt.num_sites))
            groups.setdefault(key, []).append((j, bt))

    # One device dispatch per shape group runs the whole <=20-iteration
    # hill-climb on device (no per-iteration host round trips); launch
    # every group async before pulling any result, with first-call
    # trace/deserialize parallelized across a small thread pool.
    def _launch(item):
        (ploidy, r_pad, s_pad), members = item
        # pow2-bucketed batch dim, same as phase_instances.
        G = len(members)
        G_pad = 1 << max(0, (G - 1)).bit_length()
        assigns = np.zeros((G_pad, r_pad), dtype=np.int32)
        nreads = np.zeros(G_pad, dtype=np.int32)
        for g, (j, bt) in enumerate(members):
            nreads[g] = bt.num_reads
            if ploidy > 1:
                assigns[g, :bt.num_reads] = assignments[(j, ploidy)]
        eps = np.full(G_pad, options.epsilon, dtype=np.float32)
        ids = [j for j, _bt in members]
        ids += [ids[0]] * (G_pad - G)
        alleles, weights = cache.gather((r_pad, s_pad), ids)
        best, mec, _diff = upem_optimize_device(
            alleles, weights, assigns, nreads, eps, ploidy)
        return members, ploidy, best, mec

    launch_t = time.time()
    pending = _parallel_launch(_launch, list(groups.items()))
    timing.add("upem.launch", time.time() - launch_t)

    pull_t = time.time()
    for _m, _p, best, mec in pending:
        for a in (best, mec):
            if hasattr(a, "copy_to_host_async"):
                a.copy_to_host_async()
    # Concurrent pulls: a pool overlaps the per-array device->host
    # syncs.
    flat = [a for _m, _p, best, mec in pending for a in (best, mec)]
    hosts = _parallel_launch(np.asarray, flat)
    timing.add("upem.pull", time.time() - pull_t)
    refined: Dict[Tuple[int, int], np.ndarray] = {}
    stats: Dict[Tuple[int, int], Tuple[float, float]] = {}
    for i, (members, ploidy, _b, _m2) in enumerate(pending):
        best = hosts[2 * i]
        mec = hosts[2 * i + 1]
        for g, (j, bt) in enumerate(members):
            refined[(j, ploidy)] = best[g, :bt.num_reads]
            stats[(j, ploidy)] = (float(mec[g, 0]), float(mec[g, 1]))
    return refined, stats


def phase_instances(blocks: List[Tuple[int, BlockTensor]],
                    options: Options, ploidies,
                    cache: Optional[BlockDeviceCache] = None
                    ) -> Dict[Tuple[int, int], np.ndarray]:
    """Run the beam kernel for every (block, ploidy) instance, batched by
    (padded reads, padded sites) shape bucket with mixed ploidies in one
    dispatch (inactive parts masked — provably identical to per-ploidy
    batches, tests/test_mixed_ploidy.py).

    Returns {(block_index, ploidy): assignment[num_reads]}.
    """
    ploidies = list(ploidies)
    if cache is None:
        cache = BlockDeviceCache(blocks)
    groups: Dict[Tuple[int, int],
                 List[Tuple[int, int, BlockTensor]]] = {}
    for ploidy in ploidies:
        for j, bt in blocks:
            key = (_bucket_reads(bt.num_reads),
                   _bucket_sites(bt.num_sites))
            groups.setdefault(key, []).append((ploidy, j, bt))

    # Launch every group's device call first (async), then pull results
    # and run tracebacks — avoids serializing on per-pull latency.
    # Block tensors come from the shared device cache (uploaded once,
    # gathered per ploidy on device — each read is uploaded once per
    # contig group, not once per ploidy per stage).
    max_ploidy = max(ploidies) if ploidies else 1

    def _launch(item):
        (r_pad, s_pad), members = item
        # Bucket the batch dim to pow2: instance counts drift run to
        # run and level to level, and each distinct G is a fresh jit
        # variant (~1s trace+deserialize cold). Padding instances are
        # masked (no reads, 1 part) and their outputs discarded.
        G = len(members)
        G_pad = 1 << max(0, (G - 1)).bit_length()
        nreads = np.zeros(G_pad, dtype=np.int32)
        # Padding instances take a real member's ploidy (not 1) so they
        # stay on the kernel's well-tested mixed-ploidy paths; with 0
        # reads they are pure masked compute either way.
        nparts = np.full(G_pad, members[0][0], dtype=np.int32)
        max_span = 0
        for g, (ploidy, _j, bt) in enumerate(members):
            nreads[g] = bt.num_reads
            nparts[g] = ploidy
            max_span = max(max_span, bt.max_read_span())
        eps = np.full(G_pad, options.epsilon, dtype=np.float32)
        ids = [j for _p, j, _bt in members]
        ids += [ids[0]] * (G_pad - G)
        alleles, weights = cache.gather((r_pad, s_pad), ids)
        # Sliding compute window: columns behind the sorted-read frontier
        # are never read again, so per-step work scales with the max read
        # span instead of the block width. Coarsely bucketed to limit
        # compile variants. Only used for a deep (>=4x) shrink: the
        # per-step dynamic slices of the read-weight tensor add memory
        # traffic that a small shrink does not pay back.
        window = round_up(max_span + 128, 256)
        if window * 4 > s_pad:
            window = 0
        result = _dispatch_beam(alleles, weights, nreads, eps, nparts,
                                max_ploidy, options.max_number_solns,
                                options, window=window)
        # Traceback on device: one small [G, R] int8 download per group
        # instead of six traceback-record arrays.
        assigns = beam_kernel.traceback_batch(tuple(result))
        logging.getLogger("floria_tpu").debug(
            "beam group r_pad=%d s_pad=%d G=%d window=%d", r_pad, s_pad,
            G, window)
        return members, assigns

    # Launch groups from a small thread pool: each group's FIRST call
    # pays trace + executable-deserialize, which parallelizes across
    # threads; device execution serializes regardless. Results are
    # per-group and deterministic, so launch order doesn't affect
    # outputs.
    pending = _parallel_launch(_launch, list(groups.items()))

    out: Dict[Tuple[int, int], np.ndarray] = {}
    pull_t = time.time()
    for _m, assigns in pending:
        if hasattr(assigns, "copy_to_host_async"):
            assigns.copy_to_host_async()
    hosts = _parallel_launch(np.asarray,
                             [assigns for _m, assigns in pending])
    timing.add("beam.pull", time.time() - pull_t)
    tb_t = time.time()
    for (members, _assigns), host in zip(pending, hosts):
        for g, (ploidy, j, bt) in enumerate(members):
            out[(j, ploidy)] = host[g, :bt.num_reads].astype(np.int32)
    timing.add("beam.traceback", time.time() - tb_t)
    return out


def _dispatch_beam(alleles, weights, nreads, eps, nparts, max_ploidy,
                   beam_width, options: Options, window: int = 0,
                   max_alleles: int = constants.MAX_ALLELES):
    """Single-device jit+vmap, or shard_map over a ('block',) mesh when
    several devices are available.

    max_alleles may be the batch's actual allele-value width (e.g. 2 on
    biallelic data) instead of the global MAX_ALLELES: count planes for
    absent alleles are identically zero, so shrinking the A axis is
    exact while halving the kernel's dominant state traffic."""
    import jax

    n_dev = jax.local_device_count()
    if options.num_devices is not None:
        n_dev = min(n_dev, options.num_devices)
    if n_dev > 1:
        from ..parallel.mesh import beam_search_sharded, make_block_mesh
        mesh = make_block_mesh(n_dev)
        return beam_search_sharded(mesh, alleles, weights, nreads, eps,
                                   nparts, max_ploidy, beam_width,
                                   window=window,
                                   max_alleles=max_alleles)
    # Device arrays returned as-is; callers pull them after launching
    # every group (async dispatch).
    return tuple(beam_kernel.beam_search_batch_mixed(
        alleles, weights, nreads, eps, nparts, max_ploidy, beam_width,
        max_alleles=max_alleles, window=window))
