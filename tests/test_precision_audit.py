"""Device precision contract, checked on the CPU by tracing.

The CPU backend computes every f32 dot exactly, so no CPU run can catch
a product that a GPU would round to TF32. Instead these tests trace the
production programs (the fused sweep chain, the three beam state impls,
UPEM) and assert that every dot_general with a floating operand carries
Precision.HIGHEST (kernels/beam.py EXACT_MATMUL_PRECISION: plain f32,
no TF32), except the named products whose operands are both exactly 0/1
(exact at any precision)."""

import linecache
import os

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import source_info_util

from floria_tpu.kernels import beam
from floria_tpu.kernels import upem_batch
from floria_tpu.phase import local

# (file, start of the call's source line): dots of two 0/1 operands —
# hist/planes history permutation, UPEM empty-site and cover counts.
ZERO_ONE_DOTS = (
    ("beam.py", "newhist = jnp.einsum("),
    ("upem_batch.py", "nempty = jnp.einsum("),
    ("upem_batch.py", "pcov = jnp.einsum("),
    ("upem_batch.py", "ucounts.append(jnp.einsum("),
)


def _subjaxprs(value):
    if isinstance(value, jex.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jex.Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def _dots(jaxpr):
    """Every dot_general equation, nested jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in _subjaxprs(v):
                yield from _dots(sub)


def _site(eqn):
    frame = source_info_util.user_frame(eqn.source_info.traceback)
    line = linecache.getline(frame.file_name, frame.start_line).strip()
    return os.path.basename(frame.file_name), frame.start_line, line


def audit(closed_jaxpr):
    """(violations, allow-listed sites seen) of one traced program."""
    bad, allowed = [], set()
    for eqn in _dots(closed_jaxpr.jaxpr):
        if not any(jnp.issubdtype(v.aval.dtype, jnp.floating)
                   for v in eqn.invars):
            continue
        fname, lineno, line = _site(eqn)
        entry = next((e for e in ZERO_ONE_DOTS
                      if fname == e[0] and line.startswith(e[1])), None)
        if entry is not None:
            allowed.add(entry)
            continue
        prec = eqn.params.get("precision")
        if prec != (jax.lax.Precision.HIGHEST,) * 2:
            bad.append(f"{fname}:{lineno} {line!r} precision={prec}")
    return bad, allowed


def _block_inputs(G, R, S, seed=0):
    rng = np.random.default_rng(seed)
    alleles = rng.integers(-1, 2, (G, R, S)).astype(np.int8)
    weights = np.where(alleles >= 0, 0.99, 0.0).astype(np.float32)
    return (alleles, weights, np.full(G, R, np.int32),
            np.full(G, 0.02, np.float32))


def _trace(case):
    with jax.enable_x64():
        if case in ("planes", "hist", "counts", "hist_long"):
            impl = "hist" if case == "hist_long" else case
            R = beam._R_CHUNK + 64 if case == "hist_long" else 40
            a, w, nr, eps = _block_inputs(2, R, 16)
            nparts = np.array([2, 3], np.int32)
            return jax.make_jaxpr(
                lambda *x: beam._beam_search_batch_mixed_jit(
                    *x, nparts, max_ploidy=3, beam_width=4,
                    max_alleles=2, impl=impl))(a, w, nr, eps)
        if case in ("upem", "upem_long"):
            R = beam._R_CHUNK + 64 if case == "upem_long" else 40
            a, w, nr, eps = _block_inputs(2, R, 16)
            assign = np.zeros((2, R), np.int32)
            return jax.make_jaxpr(
                lambda *x: upem_batch._upem_optimize_device_jit(
                    *x, ploidy=3, max_alleles=2))(a, w, assign, nr, eps)
        if case in ("sweep_chain", "sweep_chain_fused12"):
            fused = case.endswith("fused12")
            a, _w, nr, eps = _block_inputs(2, 40, 16)
            q = np.where(a >= 0, 20, 0).astype(np.uint8)
            fn = local._sweep_chain_fn(2 if fused else 3, 4, 0, 2, fused)
            return jax.make_jaxpr(fn)(a, q, np.arange(2, dtype=np.int32),
                                      nr, eps)
    raise ValueError(case)


CASES = ("planes", "hist", "counts", "hist_long", "upem", "upem_long",
         "sweep_chain", "sweep_chain_fused12")


@pytest.mark.parametrize("case", CASES)
def test_every_float_dot_is_exact_precision(case):
    bad, _allowed = audit(_trace(case))
    assert not bad, "dots below Precision.HIGHEST:\n" + "\n".join(bad)


def test_zero_one_allow_list_is_current():
    """Every allow-listed 0/1 product still exists, so the list cannot
    silently outlive the code it names."""
    seen = set()
    for case in CASES:
        seen |= audit(_trace(case))[1]
    assert seen == set(ZERO_ONE_DOTS)


def test_audit_flags_default_precision_dot():
    """The audit itself catches an unannotated f32 product."""
    closed = jax.make_jaxpr(lambda a, b: a @ b)(
        np.ones((2, 3), np.float32), np.ones((3, 4), np.float32))
    bad, _ = audit(closed)
    assert len(bad) == 1 and "precision=None" in bad[0]


@pytest.mark.parametrize("B,P,out", [(500, 5, 400), (2600, 2, 2400),
                                     (64, 4, 50)])
def test_rank_select_indices_match_top_k(B, P, out):
    """Integer index extraction stays exact past 2048 slots (where an
    f32 index matvec would need more than TF32's 11 bits), in
    lax.top_k's (score asc, index asc) order, ties and INFs included."""
    rng = np.random.default_rng(B)
    cand = rng.integers(0, 50, (B, P)).astype(np.float64)  # many ties
    cand[rng.random((B, P)) < 0.1] = np.inf
    with jax.enable_x64():
        score, gather_oh, part_oh, parent, part = jax.jit(
            lambda c: beam._rank_select(c, out))(cand)
        flat = jnp.minimum(jnp.asarray(cand).reshape(-1), beam._BIG)
        top_val, top_idx = jax.lax.top_k(-flat, out)
    top_idx = np.asarray(top_idx)
    assert parent.dtype == np.int32 and part.dtype == np.int32
    np.testing.assert_array_equal(parent, top_idx // P)
    np.testing.assert_array_equal(part, top_idx % P)
    np.testing.assert_array_equal(score, -np.asarray(top_val))
    np.testing.assert_array_equal(np.argmax(gather_oh, 1), top_idx // P)
    np.testing.assert_array_equal(np.argmax(part_oh, 1), top_idx % P)
