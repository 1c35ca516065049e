"""Device mesh & sharded block phasing.

Parallelism model (SURVEY.md §2.3): SNP-block instances are embarrassingly
parallel until the hap-graph join, so the batch axis of the beam kernel is
sharded over a 1-D ('block',) mesh with jax.sharding + shard_map — the
device analog of the reference's rayon loop over blocks
(graph_processing.rs:345-362). The only cross-shard communication is the
reduction of per-block summaries at the join (psum/all_gather),
mirroring the reference's process_chunks + update_hap_graph join.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore

from ..kernels import beam as beam_kernel


def make_block_mesh(num_devices: Optional[int] = None) -> Mesh:
    """Mesh over this process's LOCAL devices: block batches are per-host
    work (contigs are sharded across hosts by parallel/multihost.py, so
    different hosts dispatch different shapes and must not participate
    in one global mesh)."""
    devices = jax.local_devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.array(devices), ("block",))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def beam_search_sharded(mesh: Mesh, alleles: np.ndarray,
                        weights: np.ndarray, num_reads: np.ndarray,
                        epsilon: np.ndarray, num_parts: np.ndarray,
                        max_ploidy: int, beam_width: int,
                        window: int = 0,
                        max_alleles: int = None
                        ) -> Tuple[np.ndarray, ...]:
    """Beam-search a batch of block instances sharded over the mesh.

    The batch (leading) axis is padded to a multiple of the mesh size and
    split across devices; each device scans its local shard. Returns
    host-side numpy results trimmed to the original batch size.
    """
    n_dev = mesh.devices.size
    G = alleles.shape[0]
    G_pad = pad_to_multiple(G, n_dev)
    if G_pad != G:
        pad = G_pad - G
        alleles = np.concatenate(
            [alleles, np.full((pad,) + alleles.shape[1:], -1,
                              dtype=alleles.dtype)])
        weights = np.concatenate(
            [weights, np.zeros((pad,) + weights.shape[1:],
                               dtype=weights.dtype)])
        num_reads = np.concatenate(
            [num_reads, np.zeros(pad, dtype=num_reads.dtype)])
        epsilon = np.concatenate(
            [epsilon, np.full(pad, 0.01, dtype=epsilon.dtype)])
        num_parts = np.concatenate(
            [num_parts, np.ones(pad, dtype=num_parts.dtype)])

    S = alleles.shape[-1]
    if window <= 0 or window >= S:
        window = S
    if max_alleles is None:
        max_alleles = beam_kernel.constants.MAX_ALLELES
    # x64: the beam kernel carries exact f64 quanta (kernels/beam.py
    # _require_x64); the ctx must cover trace AND execution.
    with jax.enable_x64():
        fn = _sharded_beam_fn(mesh, max_ploidy, beam_width, window,
                              max_alleles)
        sharding = NamedSharding(mesh, P("block"))
        args = [jax.device_put(a, sharding)
                for a in (alleles, weights, num_reads, epsilon,
                          np.asarray(num_parts, dtype=np.int32))]
        out = fn(*args)
    return tuple(np.asarray(a)[:G] for a in out)


@functools.lru_cache(maxsize=64)
def _sharded_beam_fn(mesh: Mesh, max_ploidy: int, beam_width: int,
                     window: int, max_alleles: int = None):
    if max_alleles is None:
        max_alleles = beam_kernel.constants.MAX_ALLELES
    local = jax.vmap(functools.partial(
        beam_kernel._beam_search_single_hist, ploidy=max_ploidy,
        beam_width=beam_width,
        max_alleles=max_alleles, window=window))

    spec = P("block")

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(spec, spec, spec, spec, spec),
                       out_specs=(spec,) * 6,
                       check_vma=False)
    def run(alleles, weights, num_reads, epsilon, num_parts):
        return local(alleles, weights, num_reads, epsilon, num_parts)

    return jax.jit(run)


def training_step_sharded(mesh: Mesh, ploidy: int, beam_width: int):
    """The framework's full sharded 'step': phase the local shard of
    block instances, traceback each block's best-beam assignment ON
    DEVICE, then all_gather the per-block partition summaries across the
    mesh — the data the hap-graph join actually consumes
    (graph_processing.rs:306-372's `process_chunks` exchange). The
    all_gather rides ICI; raw read tensors never cross shards.

    Returns a jitted fn(alleles, weights, num_reads, epsilon) ->
    (assignments [G, R] replicated on every shard, total_mec []).
    """
    local = jax.vmap(functools.partial(
        beam_kernel._beam_search_single_hist, ploidy=ploidy,
        beam_width=beam_width,
        max_alleles=beam_kernel.constants.MAX_ALLELES, window=0))
    spec = P("block")

    def traceback_device(warm_parents, warm_parts, main_parents,
                         main_parts, scores, live):
        """Device twin of beam.traceback for one instance: walk the
        parent chain of the best final slot with two scans."""
        best = jnp.argmin(jnp.where(live, scores, jnp.inf)).astype(
            jnp.int32)

        def back_step(b, rec):
            parents, parts = rec
            # Records are int8/int16 (download compression); widen the
            # carry/output back to int32 indices.
            return (parents[b].astype(jnp.int32),
                    (parts[b].astype(jnp.int32), b))

        # Main phase (reads T1..R-1), reversed.
        b, (m_assign, _bs) = jax.lax.scan(
            back_step, best, (main_parents, main_parts), reverse=True)
        b, (w_assign, _bs) = jax.lax.scan(
            back_step, b, (warm_parents, warm_parts), reverse=True)
        return jnp.concatenate([w_assign, m_assign])

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(spec, spec, spec, spec),
                       out_specs=(P(), P()),
                       check_vma=False)
    def step(alleles, weights, num_reads, epsilon):
        out = local(alleles, weights, num_reads, epsilon)
        assigns = jax.vmap(traceback_device)(*out)       # [G_loc, R]
        scores, live = out[4], out[5]
        best = jnp.min(jnp.where(live, scores, jnp.inf), axis=1)
        best = jnp.where(jnp.isfinite(best), best, 0.0)
        total = jax.lax.psum(jnp.sum(best), "block")
        # The join's input: every shard's block partitions, gathered.
        all_assigns = jax.lax.all_gather(assigns, "block", tiled=True)
        return all_assigns, total

    jitted = jax.jit(step)

    def step_x64(*args):
        # The beam kernel requires x64 (exact f64 quanta); entering the
        # ctx here covers both the trace and every execution.
        with jax.enable_x64():
            return jitted(*args)

    return step_x64
