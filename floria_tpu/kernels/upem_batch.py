"""Batched UPEM refinement across block instances.

The per-iteration move evaluation needs every read's epsilon-distance to
every part — reformulated here as matmuls: for each allele a, the
read-side factor w*(alleles==a) [R, S] contracts over sites with the
part-side masks (nonempty * (counts_a == maxc)) [S, P], so one iteration
over a whole batch of blocks is ~2A+1 batched matmuls plus elementwise
mask prep. The (cheap, sequential) move application stays on host exactly
as the reference applies it (local_clustering.rs:292-358).

All instances of one shape bucket iterate in lockstep with per-instance
convergence masking; converged instances simply stop changing.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from .beam import (_require_x64, _PLANE_SPLIT, EXACT_MATMUL_PRECISION,
                   _R_CHUNK, _WEIGHT_SCALE, _INV_WEIGHT_SCALE,
                   _cmp_planes)


def _chunked_exact_einsum(spec, lhs, rhs_hi, rhs_lo, axis_len):
    """Exact quanta contraction: two f32 einsums over 13-bit weight
    planes, R-chunked so partial sums stay < 2^24, combined in f64 (see
    kernels/beam.py _window_counts_q)."""
    out = None
    for r0 in range(0, axis_len, _R_CHUNK):
        r1 = min(r0 + _R_CHUNK, axis_len)
        li = lhs[:, r0:r1]
        hi = jnp.einsum(spec, li, rhs_hi[:, r0:r1],
                        preferred_element_type=jnp.float32,
                        precision=EXACT_MATMUL_PRECISION)
        lo = jnp.einsum(spec, li, rhs_lo[:, r0:r1],
                        preferred_element_type=jnp.float32,
                        precision=EXACT_MATMUL_PRECISION)
        part = hi.astype(jnp.float64) * _PLANE_SPLIT + lo.astype(
            jnp.float64)
        out = part if out is None else out + part
    return out


def _eval_diff_score(alleles, weights, assign, epsilon, ploidy,
                     max_alleles):
    """Move-evaluation core: (diff [G, R, P] f64 QUANTA, score [G] f64
    quanta). Runs once per hill-climb iteration, so it computes ONLY
    what the iteration needs; the unit-weight MEC stats live in
    _eval_mec (computed once on the final assignment — they never
    influence the climb).

    EXACT ARITHMETIC: all counts/distances are integer numbers of
    2^-26 weight quanta carried in f64 (exact, order-free — see
    kernels/beam.py _step_hist), reconstructed via 13-bit-plane f32
    einsums whose partial sums stay in the f32 exact-integer
    range."""
    P = ploidy
    A = max_alleles
    f64 = jnp.float64
    _require_x64()
    eps64 = epsilon.astype(f64)
    epsq = jnp.round(eps64 * _WEIGHT_SCALE)                  # [G]
    R = alleles.shape[1]
    S = alleles.shape[2]

    assign_oh = jax.nn.one_hot(assign, P, dtype=jnp.float32)  # [G, R, P]
    covered = (alleles >= 0)
    covf = covered.astype(jnp.float32)

    wq = weights * jnp.float32(_WEIGHT_SCALE)      # exact f32 quanta
    wq_hi = jnp.floor(wq / jnp.float32(_PLANE_SPLIT))
    wq_lo = wq - wq_hi * jnp.float32(_PLANE_SPLIT)

    wa_hi_list = []
    wa_lo_list = []
    for a in range(A):
        is_a = (alleles == a).astype(jnp.float32)
        wa_hi_list.append(wq_hi * is_a)                      # [G, R, S]
        wa_lo_list.append(wq_lo * is_a)

    if R <= _R_CHUNK:
        # Fast exact path (the production case): counts stay an f32
        # 13-bit plane pair (per-plane sums < 2^24 for R <= 2048);
        # comparisons use the exact f32 sign trick (_cmp_planes) and
        # the error sums combine planes in f64 only at the [G] level,
        # keeping the [G, A, P, S] elementwise work in f32.
        # Bit-identical diff/score to the fallback below.
        counts_hi = jnp.stack(
            [jnp.einsum("grp,grs->gps", assign_oh, wa,
                        preferred_element_type=jnp.float32,
                        precision=EXACT_MATMUL_PRECISION)
             for wa in wa_hi_list], axis=1)        # [G, A, P, S] f32
        counts_lo = jnp.stack(
            [jnp.einsum("grp,grs->gps", assign_oh, wa,
                        preferred_element_type=jnp.float32,
                        precision=EXACT_MATMUL_PRECISION)
             for wa in wa_lo_list], axis=1)
        # Per-allele counts partition a part's reads, so the A-axis
        # sums stay < R * 2^13 <= 2^24 and remain exact f32 integers.
        tot_hi = counts_hi.sum(axis=1)                       # [G, P, S]
        tot_lo = counts_lo.sum(axis=1)
        nonempty = (tot_hi + tot_lo) > 0.0
        nonempty32 = nonempty.astype(jnp.float32)
        empty32 = 1.0 - nonempty32
        # lt_a = (counts_a < maxc) = some allele strictly exceeds a.
        lt_list = []
        for a in range(A):
            acc = None
            for a2 in range(A):
                if a2 == a:
                    continue
                c = _cmp_planes(counts_hi[:, a] - counts_hi[:, a2],
                                counts_lo[:, a] - counts_lo[:, a2]) < 0.0
                acc = c if acc is None else (acc | c)
            lt_list.append(acc if acc is not None
                           else jnp.zeros_like(nonempty))
        # First weak argmax over A (ties resolve to the lowest allele,
        # only the VALUE maxc is selected so ties are immaterial).
        ge_all = jnp.stack([~lt for lt in lt_list], axis=1)  # [G,A,P,S]
        first = ge_all & (jnp.cumsum(
            ge_all.astype(jnp.float32), axis=1) == 1.0)
        firstf = first.astype(jnp.float32)
        maxc_hi = (counts_hi * firstf).sum(axis=1)           # [G, P, S]
        maxc_lo = (counts_lo * firstf).sum(axis=1)
    else:
        counts = jnp.stack(
            [_chunked_exact_einsum("grp,grs->gps", assign_oh,
                                   wa_hi_list[a], wa_lo_list[a], R)
             for a in range(A)], axis=1)       # [G, A, P, S] f64 quanta
        maxc = counts.max(axis=1)                            # [G, P, S]
        nonempty32 = (maxc > 0.0).astype(jnp.float32)
        empty32 = 1.0 - nonempty32
        lt_list = [nonempty32 * (counts[:, a] < maxc) for a in range(A)]

    # diff[g,r,p] = sum_a wq[r,s] . (nonempty*(counts_a<maxc))[p,s]
    #            + epsq * sum_s cov[r,s]*empty[p,s]      (f64 quanta)
    # The empty/lt masks are 0/1 and the site-count einsum sums are
    # integers <= S < 2^24, so the f32 mask einsums are exact.
    nempty = jnp.einsum("grs,gps->grp", covf, empty32,
                        preferred_element_type=jnp.float32)
    diff = nempty.astype(f64) * epsq[:, None, None]
    for a in range(A):
        lt = nonempty32 * lt_list[a].astype(jnp.float32)     # [G, P, S]
        out = None
        for s0 in range(0, S, _R_CHUNK):
            s1 = min(s0 + _R_CHUNK, S)
            hi = jnp.einsum("grs,gps->grp",
                            wa_hi_list[a][:, :, s0:s1], lt[:, :, s0:s1],
                            preferred_element_type=jnp.float32,
                            precision=EXACT_MATMUL_PRECISION)
            lo = jnp.einsum("grs,gps->grp",
                            wa_lo_list[a][:, :, s0:s1], lt[:, :, s0:s1],
                            preferred_element_type=jnp.float32,
                            precision=EXACT_MATMUL_PRECISION)
            part = hi.astype(f64) * _PLANE_SPLIT + lo.astype(f64)
            out = part if out is None else out + part
        diff = diff + out

    # Phred MEC-epsilon score (local_clustering.rs:218-260): per part and
    # site with any entry: errors += total - max + eps*(max <= 1).
    # has_key = "any read of part p covers site s" — one covf einsum;
    # the per-allele cover sum it replaces is exactly equal (both are
    # small-integer-valued counts compared against 0).
    pcov = jnp.einsum("grp,grs->gps", assign_oh, covf,
                      preferred_element_type=jnp.float32)
    has_key = pcov > 0                                       # [G, P, S]
    if R <= _R_CHUNK:
        # total - maxc per plane: exact f32 integer differences
        # (|.| < 2^24); the spatial sums upcast to f64 (exact: integer
        # magnitudes < P*S*2^24 << 2^53) and the planes combine at [G].
        d_hi = jnp.where(has_key, tot_hi - maxc_hi, 0.0)
        d_lo = jnp.where(has_key, tot_lo - maxc_lo, 0.0)
        errors = (d_hi.sum((1, 2), dtype=f64) * _PLANE_SPLIT
                  + d_lo.sum((1, 2), dtype=f64))
        max_le_one = _cmp_planes(
            maxc_hi - jnp.float32(_PLANE_SPLIT), maxc_lo) <= 0.0
        errors = errors + epsq * (max_le_one & has_key).sum(
            (1, 2), dtype=jnp.float32).astype(f64)
    else:
        total = counts.sum(axis=1)
        one_q = jnp.asarray(_WEIGHT_SCALE, f64)   # weight 1.0 in quanta
        errors = jnp.where(has_key, total - maxc, 0.0).sum((1, 2))
        errors = errors + (epsq
                           * ((maxc <= one_q) & has_key).sum((1, 2)))
    score = -errors                              # [G] f64 quanta
    return diff, score


def _eval_mec(alleles, assign, epsilon, ploidy, max_alleles):
    """Unit-weight MEC stats (get_mec_stats_epsilon_no_phred) for the
    ploidy-sweep stopping rules: mec_noph [G, 2] = (bases, errors).

    Unit counts are integers < 2^24, so the f32 einsums are exact; the
    epsilon term is added in f64 on the 2^-26 grid (exact, order-free —
    equal to the oracle's sequential f64 `errors += eps` walk)."""
    P = ploidy
    A = max_alleles
    f64 = jnp.float64
    _require_x64()
    eps64 = epsilon.astype(f64)
    eps_grid = jnp.round(eps64 * _WEIGHT_SCALE) / _WEIGHT_SCALE
    assign_oh = jax.nn.one_hot(assign, P, dtype=jnp.float32)
    covf = (alleles >= 0).astype(jnp.float32)
    ucounts = []
    for a in range(A):
        is_a = (alleles == a).astype(jnp.float32) * covf
        ucounts.append(jnp.einsum("grp,grs->gps", assign_oh, is_a,
                                  preferred_element_type=jnp.float32))
    ucounts = jnp.stack(ucounts, axis=1)
    umax = ucounts.max(axis=1)
    uhas = ucounts.sum(axis=1) > 0
    # Spatial sums upcast to f64 BEFORE reducing: per-cell unit counts
    # are exact f32 integers < 2^24, but a block with > 2^24 covered
    # read-site cells could push the f32 reduction out of the exact
    # range (advisor round 4).
    ubases = jnp.where(uhas, umax, 0.0).sum((1, 2), dtype=f64)
    uerr = jnp.where(uhas, ucounts.sum(axis=1) - umax, 0.0).sum(
        (1, 2), dtype=f64)
    uerr = uerr + eps_grid * ((umax <= 1.0) & uhas).sum(
        (1, 2), dtype=jnp.float32).astype(f64)
    return jnp.stack([ubases, uerr], axis=-1)


def upem_eval_batch(alleles, weights, assign, epsilon, ploidy,
                    max_alleles=constants.MAX_ALLELES):
    with jax.enable_x64():
        return _upem_eval_batch_jit(alleles, weights, assign, epsilon,
                                    ploidy, max_alleles)


@functools.partial(jax.jit, static_argnames=("ploidy", "max_alleles"))
def _upem_eval_batch_jit(alleles, weights, assign, epsilon, ploidy,
                         max_alleles=constants.MAX_ALLELES):
    """Evaluate a batch of partitions.

    alleles [G, R, S] int8, weights [G, R, S] f32, assign [G, R] int32
    (-1 = padding row), epsilon [G] f32.

    Returns (diff [G, R, P] f32 epsilon-distances,
             score [G] f32 = -(sum of phred MEC-epsilon errors),
             mec_noph [G, 2] f32 = (bases, errors) with unit weights).
    """
    diff, score = _eval_diff_score(alleles, weights, assign, epsilon,
                                   ploidy, max_alleles)
    mec_noph = _eval_mec(alleles, assign, epsilon, ploidy, max_alleles)
    # Internals carry integer 2^-26 quanta; the public unit is weights.
    # The power-of-two rescale is exact.
    return (diff * _INV_WEIGHT_SCALE, score * _INV_WEIGHT_SCALE,
            mec_noph)


def _apply_moves_single(assign, diff, num_reads):
    """Device twin of apply_moves for one instance: sorted prefix-capped
    sequential walk as a lax.scan over the flattened candidate list.
    Bit-equivalent to the host walk (same stable sort key, same running
    size/moved/break bookkeeping — local_clustering.rs:292-358)."""
    R, P = diff.shape
    r_idx = jnp.arange(R)
    live = r_idx < num_reads
    assign_oh = jax.nn.one_hot(assign, P, dtype=jnp.float32)
    sizes0 = (assign_oh * live[:, None].astype(jnp.float32)).sum(0)
    sizes0 = sizes0.astype(jnp.int32)                       # [P]
    own = jnp.take_along_axis(diff, assign[:, None], axis=1)[:, 0]
    gains = own[:, None] - diff                             # [R, P]
    valid = (gains > 0.0) & live[:, None]
    valid &= jnp.arange(P)[None, :] != assign[:, None]
    valid &= (sizes0[assign] > 1)[:, None]
    K = R * P
    valid_f = valid.reshape(K)
    key = jnp.where(valid_f, -gains.reshape(K), jnp.inf)
    order = jnp.argsort(key, stable=True)  # gain desc, generation asc
    n_valid = valid_f.sum()
    n_moves = n_valid // 10
    n_moves = jnp.where(n_moves == 0, n_valid // 3 + 1, n_moves)

    # Early-exiting walk: the reference breaks right after the applied
    # candidate whose index passes the cap, so on average only
    # ~n_valid/10 of the K = R*P sorted slots are ever visited — a
    # while_loop stops there instead of scanning all K.
    def cond(carry):
        k, _a, _m, _c, stop = carry
        return (k < n_valid) & ~stop

    def body(carry):
        k, new_assign, moved, cur, stop = carry
        idx = order[k].astype(jnp.int32)   # argsort yields i64 under x64
        r = idx // P
        j = idx % P
        i = assign[r]  # source = original part (reads move at most once)
        ok = ~moved[r] & (cur[i] != 1)
        new_assign = new_assign.at[r].set(
            jnp.where(ok, j, new_assign[r]))
        moved = moved.at[r].set(moved[r] | ok)
        d = ok.astype(jnp.int32)
        cur = cur.at[j].add(d).at[i].add(-d)
        stop = ok & (k > n_moves)
        return (k + 1, new_assign, moved, cur, stop)

    init = (jnp.int32(0), assign, jnp.zeros(R, dtype=bool), sizes0,
            jnp.zeros((), dtype=bool))
    _k, new_assign, _m, _c, _s = jax.lax.while_loop(cond, body, init)
    return new_assign


def upem_optimize_device(alleles, weights, assign0, num_reads, epsilon,
                         ploidy, max_alleles=constants.MAX_ALLELES):
    with jax.enable_x64():
        return _upem_optimize_device_jit(alleles, weights, assign0,
                                         num_reads, epsilon, ploidy,
                                         max_alleles)


@functools.partial(jax.jit, static_argnames=("ploidy", "max_alleles"))
def _upem_optimize_device_jit(alleles, weights, assign0, num_reads,
                              epsilon, ploidy,
                              max_alleles=constants.MAX_ALLELES):
    """Whole UPEM hill-climb (optimize_clustering,
    local_clustering.rs:71-130) as ONE device dispatch: a while_loop of
    at most NUM_ITER_OPTIMIZE lockstep iterations, each evaluating every
    instance's moves (matmuls, upem_eval_batch) and applying them
    via the scanned sequential walk — no host round trips.

    Returns (refined assigns [G, R], mec_noph [G, 2], diff [G, R, P])."""
    G, R, _S = alleles.shape

    def eval_all(asg):
        return _eval_diff_score(alleles, weights, asg, epsilon, ploidy,
                                max_alleles)

    diff0, score0 = eval_all(assign0)

    def cond(state):
        it, _best, _score, _diff, active = state
        return (it < constants.NUM_ITER_OPTIMIZE) & active.any()

    def body(state):
        it, best, best_score, diff, active = state
        proposal = jax.vmap(_apply_moves_single)(best, diff, num_reads)
        changed = (proposal != best).any(axis=1)
        active = active & changed
        new_diff, new_score = eval_all(proposal)
        improved = active & (new_score > best_score)
        imp_r = improved[:, None]
        best = jnp.where(imp_r, proposal, best)
        best_score = jnp.where(improved, new_score, best_score)
        diff = jnp.where(improved[:, None, None], new_diff, diff)
        return (it + 1, best, best_score, diff, improved)

    state = (jnp.int32(0), assign0, score0, diff0,
             jnp.ones(G, dtype=bool))
    _it, best, _score, diff, _active = jax.lax.while_loop(
        cond, body, state)
    # The unit-weight MEC stats never influence the climb; one final
    # eval on the winning assignment replaces computing them (A more
    # full-tensor einsums) inside every iteration.
    best_mec = _eval_mec(alleles, best, epsilon, ploidy, max_alleles)
    return best, best_mec, diff * _INV_WEIGHT_SCALE


def apply_moves(assign: np.ndarray, diff: np.ndarray, ploidy: int,
                num_reads: int) -> np.ndarray:
    """Host move application for one instance
    (local_clustering.rs:292-358). assign [R], diff [R, P].

    Candidate generation and the descending-gain sort are vectorized;
    ties keep (read-major, target-part) generation order via a stable
    sort, matching the sequential construction. The capped application
    walk stays sequential (part sizes update as moves land).
    """
    a = assign[:num_reads]
    sizes = np.bincount(a, minlength=ploidy)
    own = diff[np.arange(num_reads), a]                  # [R]
    gains = own[:, None] - diff[:num_reads]              # [R, P]
    cand = gains > 0.0
    cand[np.arange(num_reads), a] = False
    cand[sizes[a] <= 1] = False
    rr, jj = np.nonzero(cand)
    new_assign = assign.copy()
    if len(rr) == 0:
        return new_assign
    order = np.argsort(-gains[rr, jj], kind="stable")
    rr = rr[order]
    jj = jj[order]
    n_moves = len(rr) // 10
    if n_moves == 0:
        n_moves = len(rr) // 3 + 1
    moved = set()
    cur = sizes.copy()
    # Skipped candidates bypass the cap check entirely, exactly like the
    # reference's `continue` before its break (local_clustering.rs:341-355).
    for mv_num in range(len(rr)):
        r = int(rr[mv_num])
        if r in moved:
            continue
        i = int(a[r])
        if cur[i] == 1:
            continue
        j = int(jj[mv_num])
        new_assign[r] = j
        cur[j] += 1
        cur[i] -= 1
        moved.add(r)
        if mv_num > n_moves:
            break
    return new_assign


class _GroupState:
    """Lockstep-iteration state for one shape group."""

    def __init__(self, alleles, weights, assigns, num_reads, epsilon,
                 ploidy):
        self.ploidy = ploidy
        self.num_reads = num_reads
        self.alleles = jax.device_put(alleles)
        self.weights = jax.device_put(weights)
        self.epsilon = jax.device_put(epsilon)
        self.best = assigns.copy()
        self.proposal = None
        self.pending = None
        self.diff = None
        self.best_score = None
        self.best_mec = None
        self.active = np.ones(len(assigns), dtype=bool)

    def launch(self, assigns):
        self.pending = upem_eval_batch(self.alleles, self.weights,
                                       jnp.asarray(assigns),
                                       self.epsilon, self.ploidy)


def optimize_many(groups) -> None:
    """Drive many _GroupState lockstep loops together, launching every
    group's eval before pulling any result — hides per-dispatch latency
    across groups on remote devices. Mutates each group's .best/.best_mec
    in place."""
    for gs in groups:
        gs.launch(gs.best)
    for gs in groups:
        diff, score, mec = (np.array(x) for x in gs.pending)
        gs.diff, gs.best_score, gs.best_mec = diff, score, mec
    for _ in range(constants.NUM_ITER_OPTIMIZE):
        live = [gs for gs in groups if gs.active.any()]
        if not live:
            break
        launched = []
        for gs in live:
            proposal = gs.best.copy()
            for g in np.flatnonzero(gs.active):
                proposal[g] = apply_moves(gs.best[g], gs.diff[g],
                                          gs.ploidy,
                                          int(gs.num_reads[g]))
            changed = (proposal != gs.best).any(axis=1)
            gs.active &= changed
            if gs.active.any():
                gs.proposal = proposal
                gs.launch(proposal)
                launched.append(gs)
        if not launched:
            break
        for gs in launched:
            new_diff, new_score, new_mec = (np.array(x)
                                            for x in gs.pending)
            improved = gs.active & (new_score > gs.best_score)
            gs.best[improved] = gs.proposal[improved]
            gs.best_score[improved] = new_score[improved]
            gs.best_mec[improved] = new_mec[improved]
            gs.diff[improved] = new_diff[improved]
            gs.active &= improved


def optimize_batch(alleles: np.ndarray, weights: np.ndarray,
                   assigns: np.ndarray, num_reads: np.ndarray,
                   epsilon: np.ndarray, ploidy: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Lockstep UPEM over a batch (optimize_clustering semantics,
    local_clustering.rs:71-130). Padding rows must carry assign = -1...
    actually assign 0 with zero weights contributes nothing.

    Returns (refined assigns [G, R], mec_noph [G, 2] of the refined
    partitions).
    """
    G, R, S = alleles.shape
    best = assigns.copy()
    # Keep the block tensors device-resident for the whole lockstep loop;
    # re-uploading them every iteration dominates wall time on remote
    # devices.
    alleles = jax.device_put(alleles)
    weights = jax.device_put(weights)
    epsilon = jax.device_put(epsilon)
    diff, score, mec = (np.array(x) for x in upem_eval_batch(
        alleles, weights, jnp.asarray(best), epsilon, ploidy))
    best_score = score
    best_mec = mec
    active = np.ones(G, dtype=bool)
    for _ in range(constants.NUM_ITER_OPTIMIZE):
        if not active.any():
            break
        proposal = best.copy()
        for g in np.flatnonzero(active):
            proposal[g] = apply_moves(best[g], diff[g], ploidy,
                                      int(num_reads[g]))
        changed = (proposal != best).any(axis=1)
        active &= changed
        if not active.any():
            break
        new_diff, new_score, new_mec = (np.array(x) for x in
                                        upem_eval_batch(
            alleles, weights, jnp.asarray(proposal), epsilon, ploidy))
        improved = active & (new_score > best_score)
        best[improved] = proposal[improved]
        best_score[improved] = new_score[improved]
        best_mec[improved] = new_mec[improved]
        diff[improved] = new_diff[improved]
        active &= improved
    return best, best_mec
