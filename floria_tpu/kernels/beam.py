"""Batched beam-search phasing kernel (the framework's hot loop).

Reimplements the reference's per-block beam search
(global_clustering.rs:10-208) as a dense JAX program:

- a beam slot's state is the part-wise allele count tensor [P, A, S]
  (the HapBlock) plus its cumulative MEC score; the SNP axis S is the
  minor dimension so vector tiles carry no padding waste. Three
  bitwise-equal state representations exist (impl=
  "planes"/"hist"/"counts", see _beam_search_batch_mixed_jit); the
  backend picks one (_AUTO_IMPL);
- one lax.scan step inserts one read: distances of the read against every
  (beam, part) pair are masked reductions over S; the binomial tail +
  log-sum-exp posterior prunes branches; rank-by-counting selection
  (_rank_select) replaces the BinaryHeap — bit-equal to lax.top_k order
  without a sort;
- the scan runs in two phases matching the reference's beam widening
  (global_clustering.rs:50-55): the first 25 reads keep ploidy*W beam
  slots, a transition step selects the top W, and the remaining reads
  scan only W slots — a ~P-fold saving on the long tail;
- the whole thing vmaps over a batch of block instances, which is where
  the device win comes from — the reference parallelizes over blocks with
  rayon (graph_processing.rs:345-362), we batch them onto the device.

Truncation note: the reference prunes haplotype positions left of the
current read start when copying blocks (types_structs.rs:327-376). Since
reads are inserted sorted by start and every read's own positions are at
or after the previous read's start, truncation can never change any later
distance computation, so the kernel keeps full (untruncated) counts.
Duplicate-block dedup (global_clustering.rs:122-127), which IS sensitive
to truncation (chains that differ only in the assignment of fully
truncated reads produce equal blocks), is realized exactly in tensor
form (dedup=True, the default): per-candidate linear fingerprints of the
truncated window plus a closed-form reduction of the reference's
sequential keep-the-worse scan — see _step. Broken-block bookkeeping
affects only disabled reference code paths (WEIRD_SPLIT=false).

Tie-breaks: the beam slot order maintained by top_k is (score asc,
candidate generation order asc), which is exactly the host oracle's
(score, uid) canonical order (tests/oracle.py), inductively: top_k ties
resolve to the lowest flattened (parent slot, part) index and parents
are already in canonical order.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..frag import phred_weight
from .scores import binom_tail_jnp, log_sum_exp_jnp

# int32 zero for dynamic_slice index tuples: literal 0 weak-types
# to int64 under x64 and dynamic_slice requires uniform index dtypes.
def _z():
    return jnp.int32(0)

# phred qual -> weight, computed host-side with the exact expression
# frag.freeze uses, so device-reconstructed weights are bitwise equal to
# host weights. Index 0 maps to 0.0, matching zeroed padding.
_PHRED_TABLE = phred_weight(np.arange(256, dtype=np.uint8))


@jax.jit
def quals_to_weights(quals: jax.Array) -> jax.Array:
    """Device-side weight reconstruction from uint8 quals (uploads
    shrink 5 bytes/cell -> 2)."""
    return jnp.take(jnp.asarray(_PHRED_TABLE), quals.astype(jnp.int32))

# Plain python float: a module-level jnp scalar would initialize the
# XLA backend at import time, breaking jax.distributed.initialize for
# any process that imports this module first (multihost workers).
INF = float("inf")

# Loop-overhead amortization for the per-read scans; read insertion is
# inherently sequential, unrolling only trades code size for dispatch
# overhead. 1 keeps each sweep-chain executable small; not yet
# re-measured on a GPU (ROADMAP item 1.5).
_SCAN_UNROLL = 1

# Finite stand-in for INF during candidate ranking (cumulative MEC
# scores are bounded by the total phred weight, orders of magnitude
# below this).
_BIG = jnp.float32(1e30)
_BIG_CUT = jnp.float32(1e29)


def _rank_select(cand, out_slots):
    """Select the best out_slots candidates of cand [B, P] in exactly
    lax.top_k's (score asc, flattened index asc) order, via rank-by-
    counting: a pairwise comparison matrix + one-hot picks, with no
    sort (whether lax.top_k is cheaper on a GPU is ROADMAP item 1.5).

    Returns (sel_score [out], gather_oh [out, B], part_oh [out, P],
    parent [out] int32, part [out] int32). sel_score reproduces the
    picked candidate bitwise (one-hot sums add exact +0s); INF
    candidates come back as _BIG. parent/part are extracted as exact
    int32 (no float matvec: an f32 index product is exact only while
    the index fits the multiplier's significand, 11 bits under TF32)."""
    B, P = cand.shape
    N = B * P
    flat = jnp.minimum(cand.reshape(N), _BIG)
    gen = jnp.arange(N)
    less = ((flat[None, :] < flat[:, None])
            | ((flat[None, :] == flat[:, None])
               & (gen[None, :] < gen[:, None])))
    rank = less.sum(axis=1)                      # [N], a permutation
    hit = rank[None, :] == jnp.arange(out_slots)[:, None]  # [out, N]
    sel = hit.astype(jnp.float32)                # one-hot rows
    sel_score = (sel * flat[None, :]).sum(-1)
    sel3 = sel.reshape(out_slots, B, P)
    gather_oh = sel3.sum(-1)                     # [out, B]
    part_oh = sel3.sum(-2)                       # [out, P]
    # rank is a permutation, so each row has exactly one hit.
    picked = jnp.where(hit, jnp.arange(N, dtype=jnp.int32)[None, :],
                       jnp.int32(0)).sum(-1, dtype=jnp.int32)
    return sel_score, gather_oh, part_oh, picked // P, picked % P


class BeamResult(NamedTuple):
    """Per-phase traceback records + final beam state.

    warm_parents/parts cover reads [0, T1) over B1 = ploidy*W slots;
    main_parents/parts cover reads [T1, R) over W slots (the first main
    step's parents index into the B1 warm slots). scores/live describe
    the final beam (width W when a main phase exists, else B1).
    """
    warm_parents: jax.Array   # [G, T1, B1]
    warm_parts: jax.Array     # [G, T1, B1]
    main_parents: jax.Array   # [G, R - T1, W]
    main_parts: jax.Array     # [G, R - T1, W]
    scores: jax.Array         # [G, B_final]
    live: jax.Array           # [G, B_final]


def _require_x64() -> None:
    """The exact-arithmetic kernel stores f64 quanta; without
    jax_enable_x64 JAX silently downcasts float64 to float32, which
    would silently reintroduce the deep-coverage inexactness this
    design eliminates (VALIDATION.md "Exact arithmetic"). Public
    entries enter jax.enable_x64() themselves; this guard catches any
    new call path that forgets to."""
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "beam kernel traced without x64: wrap the call in "
            "jax.enable_x64() (see kernels/beam.py _require_x64)")


def beam_search_batch(alleles: jax.Array, weights: jax.Array,
                      num_reads: jax.Array, epsilon: jax.Array,
                      ploidy: int, beam_width: int,
                      max_alleles: int = constants.MAX_ALLELES,
                      window: int = 0, dedup: bool = True) -> BeamResult:
    """Phase a batch of block instances at a fixed ploidy.

    alleles  [G, R, S] int8 (-1 = uncovered / padding)
    weights  [G, R, S] float32
    num_reads [G] int32 — live reads per instance (rest are padding rows)
    epsilon  [G] float32 — per-contig error rate
    window   sliding compute-window width in sites (0 or >= S => full).
             Must be >= any read's column span + 128; per-step compute
             then touches only the window, exploiting the fact that
             columns behind the sorted-read frontier are never read
             again (the tensor analog of the reference's haplotype
             truncation, types_structs.rs:327-376).
    """
    G = alleles.shape[0]
    num_parts = jnp.full(G, ploidy, dtype=jnp.int32)
    return beam_search_batch_mixed(alleles, weights, num_reads, epsilon,
                                   num_parts, ploidy, beam_width,
                                   max_alleles, window, dedup)


def beam_search_batch_mixed(alleles, weights, num_reads, epsilon,
                            num_parts, max_ploidy: int,
                            beam_width: int,
                            max_alleles: int = constants.MAX_ALLELES,
                            window: int = 0, dedup: bool = True,
                            impl: str = "auto") -> BeamResult:
    """x64-entering public wrapper; see _beam_search_batch_mixed_jit
    for semantics. Safe to call from inside an already-x64 trace (the
    fused sweep chain) — re-entering the context is a no-op."""
    with jax.enable_x64():
        return _beam_search_batch_mixed_jit(
            alleles, weights, num_reads, epsilon, num_parts, max_ploidy,
            beam_width, max_alleles, window, dedup, impl)


@functools.partial(jax.jit, static_argnames=("max_ploidy", "beam_width",
                                             "max_alleles", "window",
                                             "dedup", "impl"))
def _beam_search_batch_mixed_jit(alleles: jax.Array, weights: jax.Array,
                            num_reads: jax.Array, epsilon: jax.Array,
                            num_parts: jax.Array, max_ploidy: int,
                            beam_width: int,
                            max_alleles: int = constants.MAX_ALLELES,
                            window: int = 0, dedup: bool = True,
                            impl: str = "auto") -> BeamResult:
    """Mixed-ploidy batch: each instance phases into its own number of
    parts (num_parts[g] <= max_ploidy); inactive parts are masked out of
    scoring, pruning, and candidate selection, so one dispatch covers a
    whole ploidy sweep. Beam slots are max_ploidy * beam_width wide with
    per-instance warmup widths of num_parts * beam_width
    (global_clustering.rs:50-55).

    impl selects the (bit-identical) state representation:
      "planes" — persistent f32 13-bit count-plane pair permuted by
        one-hot matmul (needs R <= _R_CHUNK; longer blocks take hist);
      "hist"   — assignment-history state, window counts reconstructed
        by full-R matmuls each step (handles any R: falls back to
        combined-f64 planes past _R_CHUNK);
      "counts" — materialized f64 quanta counts (the reference-shaped
        oracle twin);
      "auto"   — _AUTO_IMPL[backend] for the process default backend
        at trace time (dispatches always target it; all three impls
        are bitwise-equal, test_state_impls_bitwise_equal)."""
    R = alleles.shape[-2]
    S = alleles.shape[-1]
    if window <= 0 or window >= S:
        window = S
    impl = resolve_impl(impl, R)
    single = {"hist": _beam_search_single_hist,
              "planes": _beam_search_single_planes,
              "counts": _beam_search_single}[impl]
    fn = jax.vmap(functools.partial(
        single, ploidy=max_ploidy, beam_width=beam_width,
        max_alleles=max_alleles, window=window, dedup=dedup))
    return BeamResult(*fn(alleles, weights, num_reads, epsilon,
                          num_parts.astype(jnp.int32)))


# Beam state impl per backend for impl="auto": the fastest of the three
# bitwise-equal impls measured on that backend at the real block shape
# (G=8 R=320 S=2048, ploidy sweep 2..5; chip_smoke.py's kernel phase
# times all three). XLA:CPU: hist beats planes 1.3x. H100 80GB HBM3 at
# 700 W, warm sweep: counts 0.089 s, planes 0.114 s, hist 0.133 s —
# f64 is native there, so the materialized f64 counts win. Other
# backends default to hist, which handles any block length.
_AUTO_IMPL = {"cpu": "hist", "gpu": "counts"}


def resolve_impl(impl: str, R: int) -> str:
    """Concrete state impl for a dispatch of R reads. "auto" takes
    FLORIA_BEAM_IMPL when set (output-invariant tuning / fuzzing the
    non-default path), else _AUTO_IMPL of the default backend. "planes"
    needs the R <= _R_CHUNK exactness bound, so longer blocks fall back
    to "hist" whichever way it was chosen."""
    if impl == "auto":
        forced = os.environ.get("FLORIA_BEAM_IMPL", "").strip()
        impl = (forced if forced in ("hist", "planes", "counts")
                else _AUTO_IMPL.get(jax.default_backend(), "hist"))
    if impl == "planes" and R > _R_CHUNK:
        impl = "hist"
    return impl


def _step(counts, qstate, score, live, t, off_t, a_cov, wq_t, oh_t,
          num_reads, eps64, epsq, width, ploidy, out_slots, window,
          part_active=None, start_t=None, hash_consts=None):
    """Insert read t into every live beam; keep the best `width` of the
    top `out_slots` candidates. counts: [B, P, A, S]; compute touches
    only the `window` columns starting at off_t (see beam_search_batch).
    Columns ahead of every window are all-zero in every slot, columns
    behind the frontier are never read again, so skipping them in the
    beam permutation preserves all downstream results exactly.

    When hash_consts is given, duplicate candidate blocks are deduped
    exactly like the reference (global_clustering.rs:122-127): two
    candidates are duplicates when their count tensors truncated at the
    read start (start_t) coincide; among duplicates only a candidate
    strictly better than every earlier (generation-order) one survives —
    closed form of the reference's sequential keep-the-worse scan, since
    kept scores form a strictly decreasing-MEC chain. Equality is
    detected on qstate[B, P, F, S] — per-slot per-part wrapping-uint32
    fingerprint columns q[.., f, s] = sum of (w * 2^26) * H_f[allele, s]
    over the part's reads — whose suffix sums reproduce the reference's
    exact truncated-map equality order-free (see _hash_consts)."""
    B, P, A, S = counts.shape
    f64 = jnp.float64
    cutoff = jnp.asarray(math.log(constants.PROB_CUTOFF), f64)
    div = jnp.asarray(constants.DIV_FACTOR, f64)
    valid = t < num_reads

    if window < S:
        win = jax.lax.dynamic_slice(counts, (_z(), _z(), _z(), off_t),
                                    (B, P, A, window))
        a_cov_w = jax.lax.dynamic_slice(a_cov, (off_t,), (window,))
        wq_w = jax.lax.dynamic_slice(wq_t, (off_t,), (window,))
        oh_w = jax.lax.dynamic_slice(oh_t, (_z(), off_t), (A, window))
    else:
        win, a_cov_w, wq_w, oh_w = counts, a_cov, wq_t, oh_t

    # counts carry exact f64 integer quanta (see _step_hist's exact-
    # arithmetic note); comparisons and sums below are exact.
    maxc = win.max(axis=2)                                  # [B, P, Wn]
    at = (win * oh_w[None, None].astype(f64)).sum(axis=2)   # [B, P, Wn]
    empty = maxc == 0.0
    cov = a_cov_w[None, None, :]
    wq64 = wq_w[None, None, :].astype(f64)
    same_q = (wq64 * (cov & ~empty & (at == maxc))).sum(-1)  # [B, P]
    diff_q = ((wq64 * (cov & ~empty & (at < maxc))).sum(-1)
              + epsq * (cov & empty).sum(-1))
    pval = binom_tail_jnp((same_q + diff_q) * _INV_WEIGHT_SCALE,
                          diff_q * _INV_WEIGHT_SCALE, eps64, div)
    if part_active is not None:
        # Inactive parts drop out of the posterior and the candidates.
        pval = jnp.where(part_active[None, :], pval, -jnp.inf)
    lse = log_sum_exp_jnp(pval, axis=-1)                    # [B]
    keep = (pval - lse[:, None]) > cutoff
    if part_active is not None:
        keep = keep & part_active[None, :]
    cand = jnp.where(keep & live[:, None],
                     score[:, None] + diff_q, INF)          # [B, P]

    contribs = None
    if hash_consts is not None:
        hs, gs = hash_consts             # [A, S] x F, [P] x F (uint32)
        F = len(hs)
        start_loc = start_t - off_t if window < S else start_t
        colb = jnp.arange(window) >= start_loc               # [Wn] bool
        qwin = (jax.lax.dynamic_slice(qstate, (_z(), _z(), _z(), off_t),
                                      (B, P, F, window))
                if window < S else qstate)
        mt = wq_w.astype(jnp.uint32)                         # [Wn] u32
        zero = jnp.zeros((), jnp.uint32)
        contribs = []
        h_list = []
        for f, (h, gp) in enumerate(zip(hs, gs)):
            hw = (jax.lax.dynamic_slice(h, (_z(), off_t), (A, window))
                  if window < S else h)
            # 0/1 contractions as SELECTS, not u32 multiplies (see
            # _step_hist's dedup note).
            c = mt * jnp.where(oh_w != 0, hw, zero).sum(
                axis=0, dtype=jnp.uint32)                    # [Wn] u32
            contribs.append(c)
            # Truncated-parent fingerprint + the read's delta per part.
            ph = jnp.where(colb[None, None], qwin[:, :, f], zero).sum(
                -1, dtype=jnp.uint32)
            rc = jnp.where(colb, c, zero).sum(dtype=jnp.uint32)
            h_list.append(((ph * gp[None, :]).sum(-1)[:, None]
                           + gp[None, :] * rc).reshape(B * P))
        flat = cand.reshape(B * P)
        gen = jnp.arange(B * P)
        finite = jnp.isfinite(flat)
        eq = functools.reduce(
            jnp.logical_and,
            [(h[:, None] == h[None, :]) for h in h_list])
        dup = (eq & (gen[None, :] < gen[:, None]) & finite[None, :]
               & (flat[None, :] >= flat[:, None]))
        cand = jnp.where(dup.any(axis=1).reshape(B, P), INF, cand)

    sel_score, gather_oh, part_oh, parent, part = _rank_select(
        cand, out_slots)
    new_live = (jnp.arange(out_slots) < width) & (sel_score < _BIG_CUT)

    # Indexed gather (exact for any dtype): the f64 quanta counts can't
    # ride the f32 one-hot matmul the old f32 state used.
    neww = jnp.take(win, parent, axis=0)
    update = wq_w[None, :].astype(jnp.float64) * oh_w       # [A, Wn]
    neww = neww + part_oh[:, :, None, None] * update[None, None]
    new_score = jnp.where(new_live, sel_score, INF)

    base = counts if out_slots == B else counts[:out_slots]
    if window < S:
        neww = jnp.where(valid, neww,
                         jax.lax.dynamic_slice(
                             base, (_z(), _z(), _z(), off_t),
                             (out_slots, P, A, window)))
        counts_out = jax.lax.dynamic_update_slice(
            base, neww, (_z(), _z(), _z(), off_t))
    else:
        counts_out = jnp.where(valid, neww, base)

    if hash_consts is not None:
        # Integer fingerprint state follows the same gather/update;
        # indexed take (not the float one-hot matmul) keeps it in u32.
        newq = jnp.take(qwin, parent, axis=0)     # [out, P, F, Wn]
        cstack = jnp.stack(contribs)              # [F, Wn]
        newq = newq + jnp.where(
            (part_oh != 0)[:, :, None, None], cstack[None, None],
            jnp.zeros((), jnp.uint32))
        qbase = qstate if out_slots == B else qstate[:out_slots]
        if window < S:
            newq = jnp.where(valid, newq,
                             jax.lax.dynamic_slice(
                                 qbase, (_z(), _z(), _z(), off_t),
                                 (out_slots, P, F, window)))
            qstate_out = jax.lax.dynamic_update_slice(
                qbase, newq, (_z(), _z(), _z(), off_t))
        else:
            qstate_out = jnp.where(valid, newq, qbase)
    else:
        qstate_out = qstate if out_slots == B else qstate[:out_slots]
    score_out = jnp.where(valid, new_score,
                          score if out_slots == B else score[:out_slots])
    live_out = jnp.where(valid, new_live,
                         live if out_slots == B else live[:out_slots])
    out_parent = jnp.where(valid, parent,
                           jnp.arange(out_slots)).astype(jnp.int32)
    out_part = jnp.where(valid, part, -1).astype(jnp.int32)
    return counts_out, qstate_out, score_out, live_out, out_parent, \
        out_part


def _read_starts(covered_all, S):
    """First covered column per read (S for all-padding rows)."""
    col = jnp.argmax(covered_all, axis=1).astype(jnp.int32)
    has = covered_all.any(axis=1)
    return jnp.where(has, col, S).astype(jnp.int32)


def _window_offsets(covered_all, S, window):
    """Per-read 128-aligned window start columns: floor-128 of the first
    covered column, clipped so the window stays inside [0, S), made
    monotone (reads are sorted by start, so this is already monotone up
    to padding rows, where cummax holds the last offset)."""
    if window >= S:
        return jnp.zeros(covered_all.shape[0], dtype=jnp.int32)
    start = jnp.minimum(_read_starts(covered_all, S), S - 1)
    off = (start // 128) * 128
    off = jnp.minimum(off, S - window)
    off = jax.lax.cummax(off)
    return off


_NUM_FINGERPRINTS = 2

# Weight-to-integer scale for dedup fingerprints: every phred-table
# weight 1 - 10^(-q/10) computed in float32 (frag.phred_weight,
# utils_frags.rs:702-711) is an exact multiple of 2^-26 (its f32
# exponent is >= -3 for every q >= 1, leaving the 24-bit mantissa on a
# 2^-26 grid), so w * 2^26 is an exact f32 integer < 2^26.
_WEIGHT_SCALE = float(1 << 26)
_INV_WEIGHT_SCALE = 1.0 / (1 << 26)

# Max read rows per exact-plane matmul: each 13-bit quanta plane's
# read-axis partial sums must stay < 2^24 (f32 exact-integer range), so
# R-chunks are capped at 2^24 / 2^13 = 2048 rows.
_R_CHUNK = 2048
_PLANE_SPLIT = 8192.0      # 2^13: quanta = hi * 2^13 + lo

# THE precision of every exactness-bearing f32 dot_general (weight or
# count data): the 0/1-by-13-bit-plane window-count and UPEM einsums
# and the one-hot permutation of full 24-bit count planes. HIGHEST is
# a plain f32 multiply with f32 accumulation on XLA:CPU and on XLA:GPU
# (no TF32: DEFAULT and HIGH on an H100 round each operand to TF32's
# 11 significand bits, which truncates 13-bit planes and 24-bit
# counts). With full f32 operands every product here is exact — a 0/1
# times an integer < 2^24 — and every f32 partial sum is an integer
# < 2^24 (per-plane values < 2^13 over R-chunks <= _R_CHUNK = 2^11
# rows; a one-hot row has one nonzero product), so each result is
# exact in any summation order. Only dots whose operands are BOTH 0/1
# may stay at DEFAULT (their products are exact in TF32 too); they are
# named in tests/test_precision_audit.py, which checks every
# dot_general of the traced kernels against this rule.
EXACT_MATMUL_PRECISION = jax.lax.Precision.HIGHEST


def _int_weights(weights):
    """weights * 2^26 as exact uint32 (see _WEIGHT_SCALE)."""
    return (weights * jnp.float32(_WEIGHT_SCALE)).astype(jnp.uint32)


def _window_counts_q(hist, wa_hi, wa_lo):
    """Exact window count reconstruction in f64 QUANTA.

    hist [B, P, R] is exactly 0/1 f32; wa_hi/wa_lo [R, A, Wn] are the
    13-bit halves of the per-(read, allele, site) weight quanta
    (integer-valued f32 < 2^13). Each matmul's read-axis sums stay
    < 2^24 for R-chunks <= 2048 rows, so every partial product and sum
    is exact (EXACT_MATMUL_PRECISION); the halves
    combine in f64 (exact: quanta < 2^53). Returns [B, P, A, Wn] f64
    integer quanta — bit-equal to the reference's f64 per-(site,
    allele) weight sums in any order.

    Only the hist impl's R > _R_CHUNK fallback uses this; smaller
    blocks on the hist impl take the all-f32 plane-pair path
    (_window_counts_planes + _cmp_planes), and the planes impl avoids
    per-step reconstruction entirely (_step_planes) — all computing
    the identical integers."""
    R = hist.shape[2]
    f64 = jnp.float64
    out = None
    for r0 in range(0, R, _R_CHUNK):
        r1 = min(r0 + _R_CHUNK, R)
        h = hist[:, :, r0:r1]
        hi = jnp.einsum("bpr,raw->bpaw", h, wa_hi[r0:r1],
                        preferred_element_type=jnp.float32,
                        precision=EXACT_MATMUL_PRECISION)
        lo = jnp.einsum("bpr,raw->bpaw", h, wa_lo[r0:r1],
                        preferred_element_type=jnp.float32,
                        precision=EXACT_MATMUL_PRECISION)
        part = hi.astype(f64) * _PLANE_SPLIT + lo.astype(f64)
        out = part if out is None else out + part
    return out


def _window_counts_planes(hist, wa_hi, wa_lo):
    """Window counts as an UNCOMBINED f32 plane pair (hi, lo), each
    [B, P, A, Wn]: the value is hi * 2^13 + lo, every plane entry an
    exact integer-valued f32 (per-plane read-axis sums < 2^24 because
    plane values are < 2^13 and R <= _R_CHUNK = 2^11). Skipping the f64
    combine keeps the big per-step tensors in f32; whether that still
    pays where f64 is native is ROADMAP design debt 3.2. Exact
    comparisons on the pairs go through _cmp_planes; exact window sums
    through _plane_pair_sum."""
    assert hist.shape[2] <= _R_CHUNK
    hi = jnp.einsum("bpr,raw->bpaw", hist, wa_hi,
                    preferred_element_type=jnp.float32,
                    precision=EXACT_MATMUL_PRECISION)
    lo = jnp.einsum("bpr,raw->bpaw", hist, wa_lo,
                    preferred_element_type=jnp.float32,
                    precision=EXACT_MATMUL_PRECISION)
    return hi, lo


def _cmp_planes(dh, dl):
    """Exact sign of the plane-pair difference dh * 2^13 + dl, computed
    entirely in f32. dh, dl are integer-valued f32 with |dh|, |dl|
    <= 2^24 - 1 (differences of plane sums, each < 2^24). Proof of
    exactness:
      - |dh| >= 2^11: |dh * 2^13| >= 2^24 > |dl|, so dh alone carries
        the sign (and the value cannot be zero);
      - |dh| < 2^11: dh * 8192 is an exact f32 integer (< 2^24), and
        the true sum t = dh * 8192 + dl has |t| < 2^25. f32
        round-to-nearest of an exact-operand add returns t exactly when
        |t| < 2^24, and otherwise rounds by at most 1 ulp — which can
        flip neither the sign nor zero-ness of an integer |t| >= 2^24.
    So sign(returned) == sign(dh * 2^13 + dl) and (returned == 0) ==
    (dh * 2^13 + dl == 0), bit-exactly."""
    return jnp.where(jnp.abs(dh) >= 2048.0, dh, dh * 8192.0 + dl)


def _plane_pair_sum(mask, v_hi, v_lo):
    """Exact f64 quanta of sum(v over mask): masked window sums of the
    13-bit value planes v_hi/v_lo [Wn] over mask [B, P, Wn], chunked so
    each f32 partial sum stays < 2^24 (2048 sites x (2^13 - 1) < 2^24),
    combined in f64 only at the small [B, P] result."""
    Wn = mask.shape[-1]
    zero = jnp.float32(0.0)
    out = None
    for s0 in range(0, Wn, 2048):
        s1 = min(s0 + 2048, Wn)
        m = mask[..., s0:s1]
        h = jnp.where(m, v_hi[s0:s1], zero).sum(-1)
        lo = jnp.where(m, v_lo[s0:s1], zero).sum(-1)
        part = h.astype(jnp.float64) * _PLANE_SPLIT + lo.astype(
            jnp.float64)
        out = part if out is None else out + part
    return out


def _split_weight_planes(oh_all, weights):
    """(wq [R, S] f32 integer quanta, wa_hi, wa_lo [R, A, S] f32) — the
    13-bit plane split feeding _window_counts_q."""
    wq = weights * jnp.float32(_WEIGHT_SCALE)        # exact f32 ints
    hi = jnp.floor(wq / jnp.float32(_PLANE_SPLIT))
    lo = wq - hi * jnp.float32(_PLANE_SPLIT)
    return wq, oh_all * hi[:, None, :], oh_all * lo[:, None, :]


def _hash_consts(max_alleles, S, ploidy):
    """Deterministic uint32 fingerprint constants for block dedup.

    Dedup must reproduce the reference's exact HapBlock equality
    (global_clustering.rs:122-127; HapBlock is Vec<FxHashMap<pos,
    FxHashMap<allele, OrderedFloat<f64>>>>, types_structs.rs:13-15,253).
    Every allele weight is an exact multiple of 2^-26 (_WEIGHT_SCALE),
    and the reference's f64 per-(site, allele) sums of < 2^19 such terms
    are EXACT (45 < 53 mantissa bits) hence order-free — so HapBlock
    equality is equality of per-(site, allele) INTEGER sums of
    m = w * 2^26. A wrapping-uint32 linear fingerprint
    h(part) = sum_{site, allele} intsum * H[allele, site]  (mod 2^32)
    detects that exactly: true duplicates ALWAYS match (integer
    arithmetic is associative and order-free — float32 fingerprints,
    used before round 3, missed duplicates whose accumulation orders
    rounded differently), and distinct blocks must collide in
    _NUM_FINGERPRINTS independent 32-bit projections at once (~2^-60
    per candidate pair with the odd per-part mixers; a run of 10^12
    candidate pairs has ~1e-6 odds of a single false dedup).

    DELIBERATE DEVIATION (zero-weight entries): a (site, allele) entry
    PRESENT with total weight 0 (possible only via phred-0 bases)
    fingerprints like an absent entry, so equality here is the
    reference's equality on ZERO-STRIPPED maps. This is fundamental,
    not an implementation shortcut: presence of an entry is not a
    linear function of per-read contributions, so no exact linear
    fingerprint of the reference's raw dict equality exists. Scoring
    treats present-with-0 and absent identically (the all-zero test in
    dist_eps, utils_frags.rs:696-700), making such chains
    score-equivalent forever; merging them only frees a beam slot.
    The oracle realizes the same normalized equality
    (tests/oracle.py strip_zero_entries) and the corner is pinned by
    tests/test_phred0_dedup.py.
    """
    hs_np, gs_np = _hash_consts_np(max_alleles, S, ploidy)
    return ([jnp.asarray(h) for h in hs_np],
            [jnp.asarray(g) for g in gs_np])


def _hash_consts_np(max_alleles, S, ploidy):
    """Numpy twin of _hash_consts (same rng stream) for callers that
    need host constants (the Pallas kernel builder)."""
    rng = np.random.default_rng(0xF10E1A)
    hs = [rng.integers(0, 1 << 32, (max_alleles, S), dtype=np.uint32)
          for _ in range(_NUM_FINGERPRINTS)]
    # Odd per-part mixers: odd multipliers are bijections mod 2^32, so
    # a single-part difference can never be annihilated by its mixer.
    gs = [rng.integers(0, 1 << 32, ploidy, dtype=np.uint32)
          | np.uint32(1) for _ in range(_NUM_FINGERPRINTS)]
    return hs, gs


def _step_hist(hist, score, live, t, off_t, start_t, a_cov, wq_t, oh_t,
               wa_hi, wa_lo, zs, num_reads, eps64, epsq, width, ploidy,
               out_slots, window, gs, part_active=None, dedup=True):
    """hist-state twin of _step: the beam state is the per-slot
    assignment history hist[B, P, R] (one-hot over reads) instead of the
    materialized count tensor. The window's counts are reconstructed
    each step by matmuls over the read axis — O(B*P*R*A*window)
    FLOPs instead of O(B*P*A*S) state bytes permuted (hist is ~10x
    smaller than the f64 counts state).

    EXACT ARITHMETIC (see VALIDATION.md "Exact arithmetic"): weights are
    integer multiples of 2^-26 and epsilon is quantized onto the same
    grid (options.py), so every count / distance / score the reference
    computes in f64 is an exact integer number of 2^-26 quanta
    (< 2^53), and addition of such values is exact and ORDER-FREE. The
    window counts are reconstructed as TWO f32 matmuls over 13-bit
    weight-quanta planes (each plane's read-axis sums stay < 2^24, the
    f32 exact-integer range, for R <= _R_CHUNK = 2048). For such R the
    planes are never combined on the big tensors: count comparisons use
    the exact f32 sign trick (_cmp_planes) and window sums accumulate
    per-plane in f32 (_plane_pair_sum), so f64 touches only the small
    [B, P] same/diff/score tensors, where quanta < 2^53 keep it exact.
    Longer blocks fall back to combined-f64 window counts (bit-equal,
    slower). The result is bit-equal to the sequential f64 dict oracle
    BY CONSTRUCTION — a plain f32 kernel was measurably inexact at
    ~400x site coverage (round-4 deep fuzz, seed 43). Only the binomial
    tail / log-sum-exp posterior is transcendental; it is computed in
    f64 on [B, P] exactly as before and feeds nothing but the prune
    threshold, where a flip would need the posterior to sit within
    ~1 ulp of log(PROB_CUTOFF) — measure-zero.

    Truncated-block fingerprints for dedup come from per-read uint32
    suffix sums zint[r, s] = sum_{s'>=s} (w * 2^26) * H[allele, s']
    (mod 2^32): wrapping integer arithmetic is order-free, so any two
    chains whose truncated blocks are equal (as the reference's exact
    per-(site, allele)-sum maps, see _hash_consts) hash identically by
    construction, whatever reads produced them."""
    B, P, R = hist.shape
    A, S = oh_t.shape
    f64 = jnp.float64
    cutoff = jnp.asarray(math.log(constants.PROB_CUTOFF), f64)
    div = jnp.asarray(constants.DIV_FACTOR, f64)
    valid = t < num_reads

    if window < S:
        wa_hi_win = jax.lax.dynamic_slice(wa_hi, (_z(), _z(), off_t),
                                          (R, A, window))
        wa_lo_win = jax.lax.dynamic_slice(wa_lo, (_z(), _z(), off_t),
                                          (R, A, window))
        a_cov_w = jax.lax.dynamic_slice(a_cov, (off_t,), (window,))
        wq_w = jax.lax.dynamic_slice(wq_t, (off_t,), (window,))
        oh_w = jax.lax.dynamic_slice(oh_t, (_z(), off_t), (A, window))
    else:
        wa_hi_win, wa_lo_win = wa_hi, wa_lo
        a_cov_w, wq_w, oh_w = a_cov, wq_t, oh_t

    cov = a_cov_w[None, None, :]
    if R <= _R_CHUNK:
        # Fast exact path (the production case): window counts stay an
        # f32 plane pair; comparisons ride _cmp_planes and window sums
        # _plane_pair_sum, so the step is pure native-f32 work and
        # f64 appears only at the [B, P] score level. Produces
        # bit-identical same_q/diff_q to the f64 fallback below.
        win_hi, win_lo = _window_counts_planes(
            hist, wa_hi_win, wa_lo_win)                 # [B, P, A, Wn]
        ohf = oh_w[None, None]                          # [1, 1, A, Wn]
        at_hi = (win_hi * ohf).sum(axis=2)              # [B, P, Wn]
        at_lo = (win_lo * ohf).sum(axis=2)
        # total == 0 iff every plane entry is 0: f32 sums of
        # nonnegatives are >= their largest operand, so a positive
        # total can never round to exactly 0.
        empty = (win_hi.sum(axis=2) + win_lo.sum(axis=2)) == 0.0
        # at < maxc  <=>  some allele's count strictly exceeds at.
        lt = _cmp_planes(at_hi[:, :, None] - win_hi,
                         at_lo[:, :, None] - win_lo) < 0.0
        lt_any = lt.any(axis=2)                         # [B, P, Wn]
        wq_hi_w = jnp.floor(wq_w * jnp.float32(1.0 / _PLANE_SPLIT))
        wq_lo_w = wq_w - wq_hi_w * jnp.float32(_PLANE_SPLIT)
        same_q = _plane_pair_sum(cov & ~empty & ~lt_any,
                                 wq_hi_w, wq_lo_w)      # [B, P] f64
        diff_q = (_plane_pair_sum(cov & ~empty & lt_any,
                                  wq_hi_w, wq_lo_w)
                  + epsq * (cov & empty).sum(
                      -1, dtype=jnp.float32).astype(f64))
    else:
        # R > _R_CHUNK fallback: combined f64 quanta counts (slower —
        # emulated f64 elementwise — but the plane-pair sums would
        # leave the f32 exact-integer range).
        win = _window_counts_q(hist, wa_hi_win, wa_lo_win)  # [B,P,A,Wn]
        maxc = win.max(axis=2)                              # [B, P, Wn]
        at = (win * oh_w[None, None].astype(f64)).sum(axis=2)
        empty = maxc == 0.0
        wq64 = wq_w[None, None, :].astype(f64)
        same_q = (wq64 * (cov & ~empty & (at == maxc))).sum(-1)
        diff_q = ((wq64 * (cov & ~empty & (at < maxc))).sum(-1)
                  + epsq * (cov & empty).sum(-1))
    same = same_q * _INV_WEIGHT_SCALE
    diff = diff_q * _INV_WEIGHT_SCALE
    pval = binom_tail_jnp(same + diff, diff, eps64, div)    # [B, P]
    if part_active is not None:
        pval = jnp.where(part_active[None, :], pval, -jnp.inf)
    lse = log_sum_exp_jnp(pval, axis=-1)                    # [B]
    keep = (pval - lse[:, None]) > cutoff
    if part_active is not None:
        keep = keep & part_active[None, :]
    # Scores stay in integer QUANTA (f64): score + diff_q is an exact
    # integer add, so candidate ordering/dedup compares are exact.
    cand = jnp.where(keep & live[:, None],
                     score[:, None] + diff_q, INF)          # [B, P]

    if dedup:
        h_list = []
        # zs is stored [S+1, R] so the per-step suffix-column slice is a
        # contiguous row; hist is exactly 0/1, so the u32 contraction is
        # a SELECT + reduce, not an integer multiply (32-bit int muls
        # are costlier than selects).
        hmask = hist != 0
        zero = jnp.zeros((), jnp.uint32)
        for z, gp in zip(zs, gs):
            zt = jax.lax.dynamic_slice(z, (start_t, jnp.int32(0)),
                                       (1, R))[0]
            ph = jnp.where(hmask, zt[None, None, :], zero).sum(
                axis=-1, dtype=jnp.uint32)                   # [B, P]
            rc = zt[t]  # the read's own full contribution
            h_list.append(((ph * gp[None, :]).sum(axis=-1)[:, None]
                           + gp[None, :] * rc).reshape(B * P))
        flat = cand.reshape(B * P)
        gen = jnp.arange(B * P)
        finite = jnp.isfinite(flat)
        eq = functools.reduce(
            jnp.logical_and,
            [(h[:, None] == h[None, :]) for h in h_list])
        dup = (eq & (gen[None, :] < gen[:, None]) & finite[None, :]
               & (flat[None, :] >= flat[:, None]))
        cand = jnp.where(dup.any(axis=1).reshape(B, P), INF, cand)

    sel_score, gather_oh, part_oh, parent, part = _rank_select(
        cand, out_slots)
    new_live = (jnp.arange(out_slots) < width) & (sel_score < _BIG_CUT)

    newhist = jnp.einsum("bB,BPR->bPR", gather_oh, hist,
                         preferred_element_type=jnp.float32)
    t_oh = (jnp.arange(R) == t).astype(jnp.float32)         # [R]
    newhist = newhist + part_oh[:, :, None] * t_oh[None, None, :]
    new_score = jnp.where(new_live, sel_score, INF)

    base = hist if out_slots == B else hist[:out_slots]
    hist_out = jnp.where(valid, newhist, base)
    score_out = jnp.where(valid, new_score,
                          score if out_slots == B else score[:out_slots])
    live_out = jnp.where(valid, new_live,
                         live if out_slots == B else live[:out_slots])
    out_parent = jnp.where(valid, parent,
                           jnp.arange(out_slots)).astype(jnp.int32)
    out_part = jnp.where(valid, part, -1).astype(jnp.int32)
    return hist_out, score_out, live_out, out_parent, out_part


def _step_planes(hist, cnt, score, live, t, off_t, start_t,
                 a_cov, wq_t, oh_t, zs, num_reads, eps64, epsq, width,
                 ploidy, out_slots, window, gs, part_active=None,
                 dedup=True):
    """Materialized-count-plane twin of _step_hist: the beam state keeps
    the window counts as a PERSISTENT f32 13-bit plane pair, fused as
    cnt [B, P, 2A, S] (channels [:A] the hi planes, [A:] the lo planes;
    value = hi * 2^13 + lo, every entry an exact integer-valued f32 —
    full-R sums stay < 2^24 for R <= _R_CHUNK), permuted by a one-hot
    matmul each step and updated with the new read's row planes,
    instead of reconstructing them from the assignment history by
    full-R matmuls. Fusing the pair into one tensor halves the per-step
    count of big-state ops (one slice / permutation / update / write
    instead of two).

    Why: the hist reconstruction streams the whole [R, A, Wn] weight-
    plane pair from device memory EVERY step — O(R^2 * A * Wn) bytes
    per scan, while the plane state is ~30x smaller per step
    (B*P*A*Wn * 8 B ~ 2.7 MB rw at G=8, R=320, S=2048), so carrying
    it beats recomputing it whenever R is large. Bit-identical to
    _step_hist BY CONSTRUCTION: both compute
    the same exact integers, merely re-associated (order-free — see
    _step_hist's exact-arithmetic note), and the one-hot permutation
    matmul sums exactly one nonzero product per output element.

    The permutation touches only the `window` columns (the _step
    pattern): columns behind every later window are never read again,
    so leaving them un-permuted (stale relative to slot order) is
    unobservable; columns ahead of the frontier are all-zero in every
    slot. Dedup still runs on the hist state's suffix-hash
    fingerprints, so hist [B, P, R] is carried too (cheap: ~0.5 MB/step
    vs the count planes' traffic)."""
    B, P, R = hist.shape
    A = cnt.shape[2] // 2
    f64 = jnp.float64
    cutoff = jnp.asarray(math.log(constants.PROB_CUTOFF), f64)
    div = jnp.asarray(constants.DIV_FACTOR, f64)
    valid = t < num_reads
    S = cnt.shape[3]

    if window < S:
        win = jax.lax.dynamic_slice(cnt, (_z(), _z(), _z(), off_t),
                                    (B, P, 2 * A, window))
        a_cov_w = jax.lax.dynamic_slice(a_cov, (off_t,), (window,))
        wq_w = jax.lax.dynamic_slice(wq_t, (off_t,), (window,))
        oh_w = jax.lax.dynamic_slice(oh_t, (_z(), off_t), (A, window))
    else:
        win = cnt
        a_cov_w, wq_w, oh_w = a_cov, wq_t, oh_t
    win_hi = win[:, :, :A]
    win_lo = win[:, :, A:]

    cov = a_cov_w[None, None, :]
    # Scoring: identical to _step_hist's fast path (exact f32 plane-pair
    # arithmetic; f64 only at [B, P]).
    ohf = oh_w[None, None]                              # [1, 1, A, Wn]
    at_hi = (win_hi * ohf).sum(axis=2)                  # [B, P, Wn]
    at_lo = (win_lo * ohf).sum(axis=2)
    empty = (win_hi.sum(axis=2) + win_lo.sum(axis=2)) == 0.0
    lt = _cmp_planes(at_hi[:, :, None] - win_hi,
                     at_lo[:, :, None] - win_lo) < 0.0
    lt_any = lt.any(axis=2)                             # [B, P, Wn]
    wq_hi_w = jnp.floor(wq_w * jnp.float32(1.0 / _PLANE_SPLIT))
    wq_lo_w = wq_w - wq_hi_w * jnp.float32(_PLANE_SPLIT)
    same_q = _plane_pair_sum(cov & ~empty & ~lt_any,
                             wq_hi_w, wq_lo_w)          # [B, P] f64
    diff_q = (_plane_pair_sum(cov & ~empty & lt_any,
                              wq_hi_w, wq_lo_w)
              + epsq * (cov & empty).sum(
                  -1, dtype=jnp.float32).astype(f64))
    same = same_q * _INV_WEIGHT_SCALE
    diff = diff_q * _INV_WEIGHT_SCALE
    pval = binom_tail_jnp(same + diff, diff, eps64, div)    # [B, P]
    if part_active is not None:
        pval = jnp.where(part_active[None, :], pval, -jnp.inf)
    lse = log_sum_exp_jnp(pval, axis=-1)                    # [B]
    keep = (pval - lse[:, None]) > cutoff
    if part_active is not None:
        keep = keep & part_active[None, :]
    cand = jnp.where(keep & live[:, None],
                     score[:, None] + diff_q, INF)          # [B, P]

    if dedup:
        # Identical hist-based fingerprint dedup (see _step_hist).
        h_list = []
        hmask = hist != 0
        zero = jnp.zeros((), jnp.uint32)
        for z, gp in zip(zs, gs):
            zt = jax.lax.dynamic_slice(z, (start_t, jnp.int32(0)),
                                       (1, R))[0]
            ph = jnp.where(hmask, zt[None, None, :], zero).sum(
                axis=-1, dtype=jnp.uint32)                   # [B, P]
            rc = zt[t]
            h_list.append(((ph * gp[None, :]).sum(axis=-1)[:, None]
                           + gp[None, :] * rc).reshape(B * P))
        flat = cand.reshape(B * P)
        gen = jnp.arange(B * P)
        finite = jnp.isfinite(flat)
        eq = functools.reduce(
            jnp.logical_and,
            [(h[:, None] == h[None, :]) for h in h_list])
        dup = (eq & (gen[None, :] < gen[:, None]) & finite[None, :]
               & (flat[None, :] >= flat[:, None]))
        cand = jnp.where(dup.any(axis=1).reshape(B, P), INF, cand)

    sel_score, gather_oh, part_oh, parent, part = _rank_select(
        cand, out_slots)
    new_live = (jnp.arange(out_slots) < width) & (sel_score < _BIG_CUT)

    # hist follows the selection (dedup fingerprints need it).
    newhist = jnp.einsum("bB,BPR->bPR", gather_oh, hist,
                         preferred_element_type=jnp.float32)
    t_oh = (jnp.arange(R) == t).astype(jnp.float32)         # [R]
    newhist = newhist + part_oh[:, :, None] * t_oh[None, None, :]
    new_score = jnp.where(new_live, sel_score, INF)

    # Count-plane permutation + read insertion, window columns only.
    # One-hot matmul: exactly one nonzero product per output element,
    # so it is exact for the integer-valued planes (no summation) — but
    # ONLY at full f32 multiply precision: plane values reach 2^24,
    # past TF32's 11 significand bits (EXACT_MATMUL_PRECISION note).
    nw = jnp.einsum("oB,BPXW->oPXW", gather_oh, win,
                    preferred_element_type=jnp.float32,
                    precision=EXACT_MATMUL_PRECISION)
    row = jnp.concatenate([oh_w * wq_hi_w[None, :],
                           oh_w * wq_lo_w[None, :]], axis=0)  # [2A, Wn]
    nw = nw + part_oh[:, :, None, None] * row[None, None]

    base = cnt if out_slots == B else cnt[:out_slots]
    if window < S:
        nw = jnp.where(valid, nw,
                       jax.lax.dynamic_slice(
                           base, (_z(), _z(), _z(), off_t),
                           (out_slots, P, 2 * A, window)))
        cnt_out = jax.lax.dynamic_update_slice(
            base, nw, (_z(), _z(), _z(), off_t))
    else:
        cnt_out = jnp.where(valid, nw, base)

    hist_out = jnp.where(valid, newhist,
                         hist if out_slots == B else hist[:out_slots])
    score_out = jnp.where(valid, new_score,
                          score if out_slots == B else score[:out_slots])
    live_out = jnp.where(valid, new_live,
                         live if out_slots == B else live[:out_slots])
    out_parent = jnp.where(valid, parent,
                           jnp.arange(out_slots)).astype(jnp.int32)
    out_part = jnp.where(valid, part, -1).astype(jnp.int32)
    return hist_out, cnt_out, score_out, live_out, \
        out_parent, out_part


def _beam_search_single_planes(alleles, weights, num_reads, epsilon,
                               num_parts=None, *, ploidy, beam_width,
                               max_alleles, window=0, dedup=True):
    """Scan wiring for _step_planes — see _beam_search_single_hist for
    the shared structure (same phases, records, and return shape)."""
    R, S = alleles.shape
    P = ploidy
    A = max_alleles
    B1 = ploidy * beam_width
    W = beam_width
    rec_dt = jnp.int8 if B1 <= 127 else jnp.int16
    if window <= 0 or window > S:
        window = S
    _require_x64()
    eps64 = epsilon.astype(jnp.float64)
    epsq = jnp.round(eps64 * _WEIGHT_SCALE)
    if num_parts is None:
        part_active = None
        warm_width = B1
    else:
        part_active = jnp.arange(P) < num_parts
        warm_width = num_parts * W

    covered_all = alleles >= 0
    oh_all = (alleles[:, None, :] == jnp.arange(A, dtype=alleles.dtype)[
        None, :, None]).astype(jnp.float32)
    offs = _window_offsets(covered_all, S, window)
    starts = _read_starts(covered_all, S)
    vs, gs = _hash_consts(A, S, P)
    wq = weights * jnp.float32(_WEIGHT_SCALE)   # exact f32 int quanta
    zs = [_suffix_hash(weights, oh_all, v) for v in vs]

    hist = jnp.zeros((B1, P, R), dtype=jnp.float32)
    cnt = jnp.zeros((B1, P, 2 * A, S), dtype=jnp.float32)
    score = jnp.where(jnp.arange(B1) == 0, 0.0, jnp.inf).astype(
        jnp.float64)
    live = jnp.arange(B1) == 0

    T1 = min(constants.BEAM_WARMUP_READS, R)

    def make_step(width, out_slots):
        def step_fn(state, xs):
            hist, cnt, score, live = state
            t, off_t, st_t, a_cov, wq_t, oh_t = xs
            hist, cnt, score, live, parent, part = _step_planes(
                hist, cnt, score, live, t, off_t, st_t,
                a_cov, wq_t, oh_t, zs, num_reads, eps64, epsq,
                width=width, ploidy=P, out_slots=out_slots,
                window=window, gs=gs, part_active=part_active,
                dedup=dedup)
            return ((hist, cnt, score, live),
                    (parent.astype(rec_dt), part.astype(rec_dt)))
        return step_fn

    ts = jnp.arange(R, dtype=jnp.int32)
    ((hist, cnt, score, live),
     (warm_parents, warm_parts)) = jax.lax.scan(
        make_step(warm_width, B1), (hist, cnt, score, live),
        (ts[:T1], offs[:T1], starts[:T1], covered_all[:T1],
         wq[:T1], oh_all[:T1]), unroll=_SCAN_UNROLL)

    if R <= T1:
        empty = jnp.zeros((0, W), dtype=rec_dt)
        return (warm_parents, warm_parts, empty, empty, score, live)

    hist, cnt, score, live, tr_parent, tr_part = _step_planes(
        hist, cnt, score, live, jnp.int32(T1), offs[T1],
        starts[T1], covered_all[T1], wq[T1], oh_all[T1], zs,
        num_reads, eps64, epsq, width=W, ploidy=P, out_slots=W,
        window=window, gs=gs, part_active=part_active, dedup=dedup)
    tr_parent = tr_parent.astype(rec_dt)
    tr_part = tr_part.astype(rec_dt)

    ((hist, cnt, score, live),
     (m_parents, m_parts)) = jax.lax.scan(
        make_step(W, W), (hist, cnt, score, live),
        (ts[T1 + 1:], offs[T1 + 1:], starts[T1 + 1:],
         covered_all[T1 + 1:], wq[T1 + 1:], oh_all[T1 + 1:]),
        unroll=_SCAN_UNROLL)

    main_parents = jnp.concatenate([tr_parent[None], m_parents], axis=0)
    main_parts = jnp.concatenate([tr_part[None], m_parts], axis=0)
    return (warm_parents, warm_parts, main_parents, main_parts, score,
            live)


def _suffix_hash(weights, oh_all, h):
    """zint[s, r] = sum_{s' >= s} m[r, s'] * H[allele_{r,s'}, s'] in
    wrapping uint32 (m = w * 2^26, see _hash_consts), padded with a zero
    row at s = S (fully truncated reads hash to exactly 0). Stored
    [S+1, R] so the per-step slice at a read's start column is
    contiguous."""
    hsel = jnp.where(oh_all != 0, h[None],
                     jnp.zeros((), jnp.uint32)).sum(
        axis=1, dtype=jnp.uint32)                             # [R, S]
    contrib = _int_weights(weights) * hsel
    z = jnp.cumsum(contrib[:, ::-1], axis=1,
                   dtype=jnp.uint32)[:, ::-1]
    z = jnp.concatenate(
        [z, jnp.zeros((z.shape[0], 1), dtype=z.dtype)], axis=1)
    return z.T


def _beam_search_single_hist(alleles, weights, num_reads, epsilon,
                             num_parts=None, *, ploidy, beam_width,
                             max_alleles, window=0, dedup=True):
    R, S = alleles.shape
    P = ploidy
    A = max_alleles
    B1 = ploidy * beam_width
    W = beam_width
    rec_dt = jnp.int8 if B1 <= 127 else jnp.int16
    if window <= 0 or window > S:
        window = S
    _require_x64()
    # epsilon is pre-quantized onto the 2^-26 grid (options.py) and
    # < 0.25, so its f32 storage is exact; epsq is its integer quanta.
    eps64 = epsilon.astype(jnp.float64)
    epsq = jnp.round(eps64 * _WEIGHT_SCALE)
    if num_parts is None:
        part_active = None
        warm_width = B1
    else:
        part_active = jnp.arange(P) < num_parts
        warm_width = num_parts * W

    covered_all = alleles >= 0
    oh_all = (alleles[:, None, :] == jnp.arange(A, dtype=alleles.dtype)[
        None, :, None]).astype(jnp.float32)
    offs = _window_offsets(covered_all, S, window)
    starts = _read_starts(covered_all, S)
    vs, gs = _hash_consts(A, S, P)
    wq, wa_hi, wa_lo = _split_weight_planes(oh_all, weights)
    zs = [_suffix_hash(weights, oh_all, v) for v in vs]

    hist = jnp.zeros((B1, P, R), dtype=jnp.float32)
    score = jnp.where(jnp.arange(B1) == 0, 0.0, jnp.inf).astype(
        jnp.float64)
    live = jnp.arange(B1) == 0

    T1 = min(constants.BEAM_WARMUP_READS, R)

    def make_step(width, out_slots):
        def step_fn(state, xs):
            hist, score, live = state
            t, off_t, st_t, a_cov, wq_t, oh_t = xs
            hist, score, live, parent, part = _step_hist(
                hist, score, live, t, off_t, st_t, a_cov, wq_t, oh_t,
                wa_hi, wa_lo, zs, num_reads, eps64, epsq, width=width,
                ploidy=P, out_slots=out_slots, window=window, gs=gs,
                part_active=part_active, dedup=dedup)
            # int8 traceback records: parent < B1 <= 127, part < P —
            # quarters the result download vs int32.
            return ((hist, score, live),
                    (parent.astype(rec_dt), part.astype(rec_dt)))
        return step_fn

    ts = jnp.arange(R, dtype=jnp.int32)
    (hist, score, live), (warm_parents, warm_parts) = jax.lax.scan(
        make_step(warm_width, B1), (hist, score, live),
        (ts[:T1], offs[:T1], starts[:T1], covered_all[:T1],
         wq[:T1], oh_all[:T1]), unroll=_SCAN_UNROLL)

    if R <= T1:
        empty = jnp.zeros((0, W), dtype=rec_dt)
        return (warm_parents, warm_parts, empty, empty, score, live)

    hist, score, live, tr_parent, tr_part = _step_hist(
        hist, score, live, jnp.int32(T1), offs[T1], starts[T1],
        covered_all[T1], wq[T1], oh_all[T1], wa_hi, wa_lo, zs,
        num_reads, eps64, epsq, width=W, ploidy=P, out_slots=W,
        window=window, gs=gs, part_active=part_active, dedup=dedup)
    tr_parent = tr_parent.astype(rec_dt)
    tr_part = tr_part.astype(rec_dt)

    (hist, score, live), (m_parents, m_parts) = jax.lax.scan(
        make_step(W, W), (hist, score, live),
        (ts[T1 + 1:], offs[T1 + 1:], starts[T1 + 1:],
         covered_all[T1 + 1:], wq[T1 + 1:], oh_all[T1 + 1:]),
        unroll=_SCAN_UNROLL)

    main_parents = jnp.concatenate([tr_parent[None], m_parents], axis=0)
    main_parts = jnp.concatenate([tr_part[None], m_parts], axis=0)
    return (warm_parents, warm_parts, main_parents, main_parts, score,
            live)


def _beam_search_single(alleles, weights, num_reads, epsilon,
                        num_parts=None, *, ploidy, beam_width,
                        max_alleles, window=0, dedup=True):
    R, S = alleles.shape
    P = ploidy
    A = max_alleles
    B1 = ploidy * beam_width
    W = beam_width
    rec_dt = jnp.int8 if B1 <= 127 else jnp.int16
    if window <= 0 or window > S:
        window = S
    _require_x64()
    eps64 = epsilon.astype(jnp.float64)
    epsq = jnp.round(eps64 * _WEIGHT_SCALE)
    if num_parts is None:
        part_active = None
        warm_width = B1
    else:
        part_active = jnp.arange(P) < num_parts
        warm_width = num_parts * W

    covered_all = alleles >= 0
    # One-hot over alleles with S minor: oh[r, a, s]
    oh_all = (alleles[:, None, :] == jnp.arange(A, dtype=alleles.dtype)[
        None, :, None]).astype(jnp.float32)
    offs = _window_offsets(covered_all, S, window)
    starts = _read_starts(covered_all, S)
    hc = _hash_consts(A, S, P) if dedup else None
    nf = _NUM_FINGERPRINTS if dedup else 0
    wq = weights * jnp.float32(_WEIGHT_SCALE)   # exact f32 int quanta

    # f64 integer-quanta count state (see _step_hist's exactness note).
    counts = jnp.zeros((B1, P, A, S), dtype=jnp.float64)
    qstate = jnp.zeros((B1, P, nf, S), dtype=jnp.uint32)
    score = jnp.where(jnp.arange(B1) == 0, 0.0, jnp.inf).astype(
        jnp.float64)
    live = jnp.arange(B1) == 0

    T1 = min(constants.BEAM_WARMUP_READS, R)

    def warm_step(state, xs):
        counts, qstate, score, live = state
        t, off_t, st_t, a_cov, wq_t, oh_t = xs
        counts, qstate, score, live, parent, part = _step(
            counts, qstate, score, live, t, off_t, a_cov, wq_t, oh_t,
            num_reads, eps64, epsq, width=warm_width, ploidy=P,
            out_slots=B1,
            window=window, part_active=part_active, start_t=st_t,
            hash_consts=hc)
        return ((counts, qstate, score, live),
                (parent.astype(rec_dt), part.astype(rec_dt)))

    ts = jnp.arange(R, dtype=jnp.int32)
    ((counts, qstate, score, live),
     (warm_parents, warm_parts)) = jax.lax.scan(
        warm_step, (counts, qstate, score, live),
        (ts[:T1], offs[:T1], starts[:T1], covered_all[:T1],
         wq[:T1], oh_all[:T1]), unroll=_SCAN_UNROLL)

    if R <= T1:
        empty = jnp.zeros((0, W), dtype=rec_dt)
        return (warm_parents, warm_parts, empty, empty, score, live)

    # Transition step (read index T1): full B1 parent space, width W.
    counts, qstate, score, live, tr_parent, tr_part = _step(
        counts, qstate, score, live, jnp.int32(T1), offs[T1],
        covered_all[T1], wq[T1], oh_all[T1], num_reads, eps64, epsq,
        width=W, ploidy=P, out_slots=W, window=window,
        part_active=part_active, start_t=starts[T1], hash_consts=hc)
    tr_parent = tr_parent.astype(rec_dt)
    tr_part = tr_part.astype(rec_dt)

    def main_step(state, xs):
        counts, qstate, score, live = state
        t, off_t, st_t, a_cov, wq_t, oh_t = xs
        counts, qstate, score, live, parent, part = _step(
            counts, qstate, score, live, t, off_t, a_cov, wq_t, oh_t,
            num_reads, eps64, epsq, width=W, ploidy=P, out_slots=W,
            window=window, part_active=part_active, start_t=st_t,
            hash_consts=hc)
        return ((counts, qstate, score, live),
                (parent.astype(rec_dt), part.astype(rec_dt)))

    ((counts, qstate, score, live),
     (m_parents, m_parts)) = jax.lax.scan(
        main_step, (counts, qstate, score, live),
        (ts[T1 + 1:], offs[T1 + 1:], starts[T1 + 1:],
         covered_all[T1 + 1:], wq[T1 + 1:], oh_all[T1 + 1:]),
        unroll=_SCAN_UNROLL)

    main_parents = jnp.concatenate([tr_parent[None], m_parents], axis=0)
    main_parts = jnp.concatenate([tr_part[None], m_parts], axis=0)
    return (warm_parents, warm_parts, main_parents, main_parts, score,
            live)


@jax.jit
def traceback_batch(result) -> jax.Array:
    """On-device twin of traceback() for a whole batch: walk each
    instance's best-slot parent chain with two reversed scans and return
    [G, R] assignments (int8). Padding steps recorded identity parents,
    so rows past num_reads are sliced off by the caller. Downloading
    this single small array replaces pulling all six BeamResult arrays
    per shape group."""
    def one(warm_parents, warm_parts, main_parents, main_parts, scores,
            live):
        best = jnp.argmin(jnp.where(live, scores, INF)).astype(jnp.int32)

        def back(b, rec):
            parents, parts = rec
            return parents[b].astype(jnp.int32), parts[b]

        b, m_assign = jax.lax.scan(back, best,
                                   (main_parents, main_parts),
                                   reverse=True)
        _b, w_assign = jax.lax.scan(back, b, (warm_parents, warm_parts),
                                    reverse=True)
        return jnp.concatenate([w_assign, m_assign])

    return jax.vmap(one)(*result)


def traceback(result_g, num_reads: int, ploidy: int) -> np.ndarray:
    """Recover the best beam's read -> part assignment for one instance.

    result_g: per-instance tuple (warm_parents [T1, B1], warm_parts,
    main_parents [T2, W], main_parts, scores, live). Mirrors the
    reference's parent-chain walk (global_clustering.rs:149-178).
    """
    warm_parents, warm_parts, main_parents, main_parts, scores, live = (
        np.asarray(a) for a in result_g)
    scores = np.where(live, scores, np.inf)
    b = int(np.argmin(scores))
    assignment = np.zeros(num_reads, dtype=np.int32)
    T1 = warm_parents.shape[0]
    T2 = main_parents.shape[0]
    # Walk the main phase (reads T1+T2-1 .. T1), then the warm phase.
    # Padding steps recorded identity parents, so the chain passes
    # through them untouched.
    for t in range(T2 - 1, -1, -1):
        read_idx = T1 + t
        if read_idx < num_reads:
            assignment[read_idx] = main_parts[t, b]
        b = int(main_parents[t, b])
    for t in range(T1 - 1, -1, -1):
        if t < num_reads:
            assignment[t] = warm_parts[t, b]
        b = int(warm_parents[t, b])
    return assignment
