"""Batched SNP-local realignment.

The reference re-calls each (read, SNP) pair by globally aligning a 32bp
read window against the reference window with each candidate allele
substituted at the center, keeping the allele with the best score
(alignment.rs:7-64, SIMD block-aligner: match +1 / mismatch -1, gap open
-2 extend -1). That is thousands of independent fixed-size
needleman-wunsch problems — ideal device shape — so we collect every
(read, SNP) job for a contig with vectorized window gathers and run
chunked batched affine-gap NW (Gotoh) over all (job, allele) pairs.

Transfer layout (host-to-device bytes, not the NW compute, set the
cost): per job we ship only a 4-bit-packed 32bp query window
(16 B) and an int32 SNP row (4 B); the reference windows, candidate
allele codes, and allele counts are per-SNP tables uploaded once per
flush and gathered on device (every read covering a SNP shares its
row). The allele argmax also runs on device, so the download is one
int8 call per job. Biallelic sites (almost all of them) run in their
own partition with 2 NW problems per job instead of MAX_ALLELES.

Deviation from the reference (documented design choice): exact NW
instead of block-aligner's banded block approximation (the band covers
the full 32x32 problem at block size 8 in most cases, so scores rarely
differ).

Supplementary-alignment quirk, replicated exactly for parity: the
reference offsets a supplementary record's stored query positions by
its leading hard-clips even though seq_string holds the hard-clipped
sequence (file_reader.rs:719-720), so realignment windows for such
sites are either misplaced by the clip length or dropped by the bounds
guard (alignment.rs:24-27). Both ingest paths here reproduce that
offset (ingest/fragments.py:66-85, native/bgzf_bam.cpp lead_hard);
pinned by tests/test_ingest.py::test_supp_hardclip_offset_parity.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..frag import Frag
from ..ingest.vcf import ContigVcf

FLANK = 16
WINDOW = 2 * FLANK
GAP_OPEN = -2
GAP_EXTEND = -1
MATCH = 1
MISMATCH = -1
# All NW scores are small integers (|score| <= ~100 at W=32), so the DP
# runs in int16 — half the HBM traffic of f32 with bit-identical
# argmax. The -inf sentinel only needs to undercut every real score
# while leaving headroom for the few additive constants applied to it.
NEG = -16384

# Jobs per on-device map step; the whole sweep is ONE dispatch with a
# lax.map over chunks (chunk count bucketed to powers of two). The NW
# scan is 32 sequential row steps of ~10 small ops each, so the kernel
# is op-latency bound: big chunks keep the op count low ([256k, 33]
# int16 rows are a few MB of device memory). CPU tests keep small
# chunks — the XLA CPU backend would otherwise chew 200MB vector ops
# per step.
CHUNK_JOBS = 32768


def _chunk_jobs() -> int:
    # 2^18 jobs per chunk on an accelerator; not yet re-measured on a
    # GPU (ROADMAP item 1.5).
    return 32768 if jax.default_backend() == "cpu" else (1 << 18)

# 4-bit sequence codes: the BAM nibble alphabet (every base a BAM or
# FASTA can produce after .upper()) gets a distinct code, so comparing
# codes is equivalent to comparing the raw bytes for all real inputs.
# Unknown bytes collapse to 'N' (code 15) — they cannot arise from the
# in-repo BAM decoder and are vanishingly rare in FASTA refs.
_ALPHABET = b"=ACMGRSVTWYHKDBN"
_ENC = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate(_ALPHABET):
    _ENC[_b] = _i


def _pack4(codes: np.ndarray) -> np.ndarray:
    """[n, W] 4-bit codes -> [n, W//2] packed bytes (even idx = low
    nibble)."""
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("n_alleles_max",))
def _nw_best_chunked(q3p: jax.Array, si3: jax.Array, ref_tab: jax.Array,
                     al_tab: jax.Array, nal_tab: jax.Array,
                     n_alleles_max: int) -> jax.Array:
    """One dispatch for the whole sweep, transfer-lean: per job only a
    4-bit-packed query window [C, W//2] and a SNP row index [C]; the
    per-SNP reference windows / allele codes / allele counts live in
    small tables gathered ON DEVICE (reads share SNP windows, so the
    tables are ~100x smaller than per-job ref windows). Allele variants
    are also built on device, and the argmax over alleles happens on
    device so only an int8 call per job is downloaded.
    Returns [n, C] int8 best-allele indices."""
    A = n_alleles_max

    def one_chunk(args):
        qp, si = args                          # [C, W//2], [C]
        C = qp.shape[0]
        lo = qp & 0xF
        hi = qp >> 4
        q = jnp.stack([lo, hi], axis=-1).reshape(C, WINDOW)
        r = ref_tab[si]                        # [C, W]
        al = al_tab[si, :A]                    # [C, A]
        nal = nal_tab[si]                      # [C]
        var = jnp.repeat(r[:, None, :], A, axis=1)
        var = var.at[:, :, FLANK].set(al)
        qq = jnp.repeat(q[:, None, :], A, axis=1)
        sc = _nw_scores(qq.reshape(C * A, WINDOW),
                        var.reshape(C * A, WINDOW)).reshape(C, A)
        sc = jnp.where(jnp.arange(A)[None, :] < nal[:, None], sc, NEG)
        return jnp.argmax(sc, axis=1).astype(jnp.int8)

    return jax.lax.map(one_chunk, (q3p, si3))


@jax.jit
def _nw_scores(q: jax.Array, r: jax.Array) -> jax.Array:
    """Global affine-gap alignment scores for a batch of equal-length
    sequence pairs. q, r: [N, W] uint8. Returns [N] float32.

    State lives TRANSPOSED as [W+1, N]: the batch axis is the minor
    (contiguous) one instead of a 33-long minor axis that wastes most
    of each vector tile, and in int16 (scores are small exact
    integers) — half the memory traffic of f32 with identical argmax.
    """
    dt = jnp.int16
    N, W = q.shape
    jcols = jnp.arange(W + 1, dtype=dt)[:, None]  # [W+1, 1]

    # Boundary row i=0: only gaps along the reference.
    col0 = jnp.arange(W + 1)[:, None] == 0
    m0 = jnp.broadcast_to(jnp.where(col0, 0, NEG).astype(dt), (W + 1, N))
    iy0 = jnp.broadcast_to(
        jnp.where(col0, NEG,
                  GAP_OPEN + GAP_EXTEND * (jcols - 1)).astype(dt),
        (W + 1, N))
    ix0 = jnp.full((W + 1, N), NEG, dt)

    r_t = r.T  # [W, N]

    def row_step(carry, qi_and_i):
        m_prev, ix_prev, iy_prev = carry
        q_i, i = qi_and_i
        h_prev = jnp.maximum(jnp.maximum(m_prev, ix_prev), iy_prev)
        sub = jnp.where(q_i[None, :] == r_t, MATCH,
                        MISMATCH).astype(dt)  # [W, N]
        m = jnp.concatenate(
            [jnp.full((1, N), NEG, dt), h_prev[:-1] + sub], axis=0)
        ix = jnp.maximum(m_prev + jnp.int16(GAP_OPEN),
                         ix_prev + jnp.int16(GAP_EXTEND))
        ix = ix.at[0, :].set((GAP_OPEN + GAP_EXTEND * i).astype(dt))
        # Iy via max-plus prefix: Iy[j] = e*j + cummax_{k<j}(M[k]+o-e(k+1))
        base = m + jnp.int16(GAP_OPEN) - jnp.int16(GAP_EXTEND) * (jcols
                                                                  + 1)
        base = jnp.maximum(
            base, ix + jnp.int16(GAP_OPEN)
            - jnp.int16(GAP_EXTEND) * (jcols + 1))
        cm = jax.lax.cummax(base, axis=0)
        iy = jnp.concatenate(
            [jnp.full((1, N), NEG, dt),
             cm[:-1] + jnp.int16(GAP_EXTEND) * jcols[1:]], axis=0)
        return (m, ix, iy), None

    qi = q.astype(jnp.int16).T  # [W, N]
    ii = jnp.arange(W, dtype=jnp.int32)
    (m, ix, iy), _ = jax.lax.scan(row_step, (m0, ix0, iy0), (qi, ii))
    return jnp.maximum(jnp.maximum(m[-1], ix[-1]), iy[-1])


_OFFSETS = np.arange(-FLANK, FLANK)


class RealignPool:
    """Contig-agnostic job pool: packed query windows + SNP row indices
    into concatenated per-contig SNP tables (ref window / allele codes /
    allele counts). Shared across contigs so a whole contig group
    realigns in one device dispatch."""

    def __init__(self):
        self._q: List[np.ndarray] = []      # [n, W//2] packed query codes
        self._si: List[np.ndarray] = []     # [n] int32 global SNP rows
        self._nal: List[np.ndarray] = []
        self._targets: List = []  # (frag, snp_pos array per batch)
        self._tab_r: List[np.ndarray] = []   # per-contig [n_snp, W] codes
        self._tab_al: List[np.ndarray] = []  # per-contig [n_snp, A] codes
        self._tab_nal: List[np.ndarray] = []
        self._tab_rows: int = 0
        self._gen: int = 0  # bumped by flush; invalidates registrations


class SnpRealigner:
    """Collects (read, SNP) realignment jobs with vectorized window
    gathers and applies them in chunked batched device calls. Pass a
    shared RealignPool to batch several contigs into one flush."""

    def __init__(self, ref_seq: bytes, contig_vcf: ContigVcf,
                 pool: "RealignPool" = None):
        self.ref = np.frombuffer(ref_seq.upper(), dtype=np.uint8)
        self.cv = contig_vcf
        self.allele_mat = contig_vcf.allele_matrix()       # [n_snp, A]
        self.n_alleles = (self.allele_mat > 0).sum(axis=1)
        self.pool = pool if pool is not None else RealignPool()
        self._tab_base = None  # row offset of this contig's SNP tables
        self._tab_gen = -1

    def _ensure_tables(self) -> int:
        """Register this contig's per-SNP tables in the pool (once per
        pool generation — a flush clears the tables)."""
        if self._tab_base is None or self._tab_gen != self.pool._gen:
            self._tab_gen = self.pool._gen
            pool = self.pool
            self._tab_base = pool._tab_rows
            gn = self.cv.genome_pos.astype(np.int64)
            # Out-of-bounds windows are filtered per job; clamp so the
            # (unused) table rows still gather safely.
            idx = np.clip(gn[:, None] + _OFFSETS, 0,
                          max(0, len(self.ref) - 1))
            pool._tab_r.append(_ENC[self.ref[idx]])
            pool._tab_al.append(_ENC[self.allele_mat])
            pool._tab_nal.append(self.n_alleles.astype(np.int32))
            pool._tab_rows += len(gn)
        return self._tab_base

    def realign(self, frag: Frag) -> None:
        """Queue one fragment (pure-Python ingest path: sites still live
        in dicts)."""
        if not frag.seq_dict:
            return
        snps = np.fromiter(frag.seq_dict.keys(), dtype=np.int64,
                           count=len(frag.seq_dict))
        qpos = np.fromiter(
            (frag.snp_pos_to_seq_pos[int(p)][1] for p in snps),
            dtype=np.int64, count=len(snps))
        self.add_jobs(frag, snps, qpos,
                      np.frombuffer(frag.seq_string[0].upper(),
                                    dtype=np.uint8))

    def add_jobs(self, frag: Frag, snp_counters: np.ndarray,
                 qpos: np.ndarray, seq: np.ndarray) -> None:
        """Queue sites given as arrays (1-based SNP counters)."""
        snp_idx = snp_counters.astype(np.int64) - 1
        gn = self.cv.genome_pos[snp_idx]
        ok = ((gn >= FLANK) & (gn + FLANK < len(self.ref))
              & (qpos >= FLANK) & (qpos + FLANK < len(seq)))
        if not ok.any():
            return
        base = self._ensure_tables()
        qp = qpos[ok]
        pool = self.pool
        pool._q.append(_pack4(_ENC[seq[qp[:, None] + _OFFSETS]]))
        pool._si.append((base + snp_idx[ok]).astype(np.int32))
        pool._nal.append(self.n_alleles[snp_idx[ok]])
        pool._targets.append((frag, snp_counters[ok]))

    def add_jobs_from_records(self, seq_buf: np.ndarray,
                              pay_offs: np.ndarray, out_rec: np.ndarray,
                              out_qpos: np.ndarray, out_snp: np.ndarray,
                              rec_targets) -> None:
        """Queue a whole contig's jobs straight from the native ingest's
        flat site arrays (record id / in-payload query pos / 0-based SNP
        row per site). The native single-pass builder fuses the bounds
        mask, window pack, and table lookups of add_jobs_bulk — which is
        the bitwise-identical fallback — writing each output byte once
        (fresh-page first-touch, not compute, dominates this stage on
        the target VMs)."""
        if not len(out_snp):
            return
        from .. import native
        base = self._ensure_tables()
        res = native.realign_jobs(seq_buf, out_rec, out_qpos, out_snp,
                                  pay_offs, self.cv.genome_pos,
                                  len(self.ref), self.n_alleles, FLANK,
                                  base)
        if res is None:
            starts = pay_offs[out_rec]
            self.add_jobs_bulk(seq_buf,
                               out_qpos.astype(np.int64) + starts,
                               starts, pay_offs[out_rec + 1],
                               out_snp.astype(np.int64) + 1, rec_targets)
            return
        _kept, packed, si, nal, snp_kept, rec_counts = res
        if not len(si):
            return
        pool = self.pool
        pool._q.append(packed)
        pool._si.append(si)
        pool._nal.append(nal)
        # Per-record split of the compacted kept sites: sites are
        # record-major, so record r's kept sites live at
        # [offs[r], offs[r+1]) of the compacted arrays (the builder
        # tallies per-record kept counts — a host cumsum over the tens
        # of millions of per-site flags costs more).
        offs = np.zeros(len(rec_counts) + 1, np.int64)
        np.cumsum(rec_counts, out=offs[1:])
        for frag, sl in rec_targets:
            rid = int(out_rec[sl.start])
            o, e = int(offs[rid]), int(offs[rid + 1])
            if e > o:
                pool._targets.append((frag, snp_kept[o:e]))

    def add_jobs_bulk(self, seq: np.ndarray, qpos_global: np.ndarray,
                      rec_start: np.ndarray, rec_end: np.ndarray,
                      snp_counters: np.ndarray,
                      rec_targets) -> None:
        """Queue a whole contig's jobs in one vectorized pass.

        seq: concatenated payload bases of all records; qpos_global:
        per-site position in that buffer; rec_start/rec_end: the owning
        record's payload bounds per site; rec_targets: [(frag, slice)]
        per record covering snp_counters in order (record-major, the
        same order the packed rows are emitted)."""
        snp_idx = snp_counters.astype(np.int64) - 1
        gn = self.cv.genome_pos[snp_idx]
        rel = qpos_global - rec_start
        ok = ((gn >= FLANK) & (gn + FLANK < len(self.ref))
              & (rel >= FLANK) & (qpos_global + FLANK < rec_end))
        if not ok.any():
            return
        base = self._ensure_tables()
        pool = self.pool
        qsel = qpos_global[ok]
        from .. import native
        packed = native.pack_windows(seq, qsel, FLANK)
        if packed is None:
            # Chunked window gather: one flat [N, W] int64 index tensor
            # for millions of jobs is a >1 GB allocation whose page
            # faults cost far more than the gather; slabs keep the
            # working set in cache.
            n = len(qsel)
            packed = np.empty((n, WINDOW // 2), np.uint8)
            slab = 1 << 17
            for i in range(0, n, slab):
                idx = qsel[i:i + slab][:, None] + _OFFSETS
                packed[i:i + slab] = _pack4(_ENC[seq[idx]])
        pool._q.append(packed)
        pool._si.append((base + snp_idx[ok]).astype(np.int32))
        pool._nal.append(self.n_alleles[snp_idx[ok]])
        for frag, sl in rec_targets:
            kept = snp_counters[sl][ok[sl]]
            if len(kept):
                pool._targets.append((frag, kept))

    def flush(self) -> None:
        """Flush this realigner's pool (a shared pool flushes every
        contig's jobs at once)."""
        flush_pool(self.pool)


def _dispatch_jobs(q: np.ndarray, si: np.ndarray, ref_tab: jax.Array,
                   al_tab: jax.Array, nal_tab: jax.Array,
                   n_alleles_max: int) -> np.ndarray:
    """Pad one job partition into bucketed chunk shapes and run it."""
    import time as _time

    from .. import timing as _timing

    N = len(q)
    chunk = _chunk_jobs()
    n_chunks = (N + chunk - 1) // chunk
    # Bucket the chunk count (multiples of 8, power-of-two for small)
    # so few shapes compile while bounding padding waste.
    if n_chunks <= 4:
        n_pad = 1 << max(0, (n_chunks - 1)).bit_length()
    else:
        n_pad = ((n_chunks + 3) // 4) * 4
    n_pad = max(n_pad, 1)
    total = n_pad * chunk
    q_all = np.zeros((total, WINDOW // 2), np.uint8)
    si_all = np.zeros(total, np.int32)
    q_all[:N] = q
    si_all[:N] = si
    _t = _time.time()
    res = _nw_best_chunked(
        jnp.asarray(q_all.reshape(n_pad, chunk, WINDOW // 2)),
        jnp.asarray(si_all.reshape(n_pad, chunk)),
        ref_tab, al_tab, nal_tab, n_alleles_max)
    _timing.add("realign.device.dispatch", _time.time() - _t)
    _t = _time.time()
    out = np.asarray(res).reshape(total)[:N]
    _timing.add("realign.device.pull", _time.time() - _t)
    return out


def flush_pool(pool: RealignPool) -> None:
    import time as _time

    from .. import timing as _timing

    if not pool._targets:
        return
    _t = _time.time()
    q = np.concatenate(pool._q)
    si = np.concatenate(pool._si)
    nal = np.concatenate(pool._nal)
    N = len(q)
    ref_tab = np.concatenate(pool._tab_r)
    al_tab = np.concatenate(pool._tab_al)
    nal_tab = np.concatenate(pool._tab_nal)
    A = al_tab.shape[1]
    T = len(ref_tab)
    # Bucket table rows (pow2, >=4k) so few shapes compile.
    T_pad = max(4096, 1 << max(0, (T - 1)).bit_length())
    ref_tab = np.pad(ref_tab, ((0, T_pad - T), (0, 0)))
    al_tab = np.pad(al_tab, ((0, T_pad - T), (0, 0)))
    nal_tab = np.pad(nal_tab, (0, T_pad - T))
    ref_d = jnp.asarray(ref_tab)
    al_d = jnp.asarray(al_tab)
    nal_d = jnp.asarray(nal_tab)

    best = np.empty(N, np.int8)
    # Hamming precheck (native): with these scores a gapless alignment
    # of equal-length windows scores exactly W - 2*hamming while ANY
    # gapped alignment scores <= W - 5, so whenever some variant is
    # within hamming 2 the NW argmax is provable host-side (first
    # lowest-index minimum, the same tie rule as jnp.argmax); see
    # floria_realign_exact in native/bgzf_bam.cpp for the proof. At
    # realistic error rates this resolves ~90%+ of jobs with a 16-byte
    # XOR scan each.
    from .. import native as _native
    todo = np.ones(N, bool)
    if N:
        var = np.repeat(ref_tab[:T, None, :], A, axis=1)
        var[:, :, FLANK] = al_tab[:T]
        var_packed = np.ascontiguousarray(
            (var[:, :, 0::2] | (var[:, :, 1::2] << 4)).astype(np.uint8))
        pre = _native.realign_exact(q, si, nal.astype(np.int32),
                                    var_packed)
        if pre is not None:
            best = pre
            todo = pre < 0
    rest = np.nonzero(todo)[0]
    # Dedup the surviving jobs: reads covering a SNP with identical
    # windows are the same NW problem (ratio ~2x at long-read error
    # rates). The unique representative's result is scattered back, so
    # per-job outputs are unchanged.
    rest_all = rest
    inv = None
    if len(rest):
        dd = _native.dedup_jobs(q[rest], si[rest])
        if dd is not None:
            uniq_local, inv = dd
            rest = rest[uniq_local]
    _timing.add("realign.host_prep", _time.time() - _t)
    _t = _time.time()
    # Biallelic sites (the vast majority) only need 2 NW problems per
    # job; run them as their own partition at half the compute.
    if len(rest):
        nal_r = nal[rest]
        bi = nal_r <= 2
        for sel, a_max in ((bi, min(2, A)), (~bi, A)):
            idx = rest[np.nonzero(sel)[0]]
            if len(idx) == 0:
                continue
            # Small partitions (the multi-allelic remainder, little
            # contigs) run the exact C++ Gotoh — cell-for-cell the
            # device recurrence (validated bit-equal) — instead of
            # paying a padded device dispatch.
            if len(idx) <= 131072:
                _tc = _time.time()
                host = _native.nw_batch(q[idx], si[idx],
                                        nal[idx].astype(np.int32),
                                        ref_tab, al_tab)
                if host is not None:
                    best[idx] = host
                    _timing.add("realign.device.cpp",
                                _time.time() - _tc)
                    continue
            best[idx] = _dispatch_jobs(q[idx], si[idx], ref_d, al_d,
                                       nal_d, a_max)
    if inv is not None and len(rest_all):
        best[rest_all] = best[rest][inv]
    _timing.add("realign.device", _time.time() - _t)
    _t = _time.time()

    off = 0
    for frag, snp_pos in pool._targets:
        calls = best[off:off + len(snp_pos)]
        off += len(snp_pos)
        frag.set_calls(snp_pos, calls)
    pool._q.clear()
    pool._si.clear()
    pool._nal.clear()
    pool._targets.clear()
    pool._tab_r.clear()
    pool._tab_al.clear()
    pool._tab_nal.clear()
    pool._tab_rows = 0
    pool._gen += 1
    _timing.add("realign.scatter", _time.time() - _t)
