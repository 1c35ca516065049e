#!/usr/bin/env python3
"""On-card smoke check of the phasing system on one NVIDIA GPU.

Proves that the normal entry points phase a real-sized community on the
card and that every device kernel of that path returns, bit for bit,
what the CPU backend returns (the exact-arithmetic contract,
VALIDATION.md "Exact arithmetic"). Phases, in one process on the card:

  device     card name and power limit (nvidia-smi), JAX platform/kind
  precision  exactness of the 13-bit plane einsum, the 24-bit one-hot
             permutation and the rank-select index extraction at
             kernels/beam.py EXACT_MATMUL_PRECISION (DEFAULT and HIGH are
             probed and printed, not asserted)
  kernels    beam sweep (ploidies 2..5, beam 10, G=8 R=320 S=2048) in
             each state impl, UPEM and one 2^18-job NW chunk, compared
             with tolerance zero against XLA:CPU
  main path  the 2-strain E. coli config (bench.py e2e_config) through
             floria_tpu.cli.main, cold then warm, byte-compared with a
             CPU-backend CLI run and checked against the simulated truth

The CPU reference runs in a child process with JAX_PLATFORMS=cpu, so it
never opens the card. Device seconds are printed for information only.

Usage:
  python3 chip_smoke.py                one card; the last stdout line is
                                       {"ok": true, "device": {...}}
  python3 chip_smoke.py --four-cards   only the multi-device paths on a
                                       4-card host: one card, one process
                                       over 4 cards (('block',) mesh) and
                                       4 processes, byte-compared
  python3 chip_smoke.py --rehearse     the single-card flow at toy sizes
                                       on the CPU backend (never prints
                                       "ok": true)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")

# Real widths (the beam kernel's real block shape, bench.py) and the
# toy sizes of --rehearse.
SIZES = {
    "real": dict(G=8, R=320, S=2048, nw_jobs=1 << 18, community="ecoli2"),
    "toy": dict(G=2, R=64, S=256, nw_jobs=1 << 12, community="quick2"),
}
PLOIDIES = (2, 3, 4, 5)
BEAM_WIDTH = 10
UPEM_PLOIDY = 3
IMPLS = ("planes", "hist", "counts")
SEED = 0
# Output files left out of every comparison: cmd.log records argv.
SKIP = r"cmd\.log"
# Per-rank summary TSVs a multi-process run keeps beside the merged one.
RANK_TSV = r"contig_ploidy_info\.\d+\.tsv"


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    """Fail the current phase (an assert would vanish under -O)."""
    if not cond:
        raise AssertionError(msg)


# --- output comparison ----------------------------------------------------

def compare_outputs(dir_a: str, dir_b: str, skip: str = None) -> list:
    """Differences between two CLI output trees, paths normalised: every
    occurrence of a tree's own root in its files reads as "OUT" (headers
    embed the output path). Returns human-readable mismatch lines; an
    empty list means byte-identical. File names matching SKIP, or the
    `skip` regex, are left out."""
    pats = [re.compile(SKIP)] + ([re.compile(skip)] if skip else [])

    def files(root):
        out = set()
        for base, _dirs, names in os.walk(root):
            for n in names:
                if not any(p.fullmatch(n) for p in pats):
                    out.add(os.path.relpath(os.path.join(base, n), root))
        return out

    fa, fb = files(dir_a), files(dir_b)
    diffs = [f"only in {dir_a}: {n}" for n in sorted(fa - fb)]
    diffs += [f"only in {dir_b}: {n}" for n in sorted(fb - fa)]
    for name in sorted(fa & fb):
        with open(os.path.join(dir_a, name), "rb") as fh:
            a = fh.read().replace(os.fsencode(dir_a), b"OUT")
        with open(os.path.join(dir_b, name), "rb") as fh:
            b = fh.read().replace(os.fsencode(dir_b), b"OUT")
        if a != b:
            la, lb = a.splitlines(), b.splitlines()
            first = next((i for i, (x, y) in enumerate(zip(la, lb))
                          if x != y), min(len(la), len(lb)))
            diffs.append(f"{name}: first difference at line {first + 1}")
    return diffs


# --- inputs, made from SEED ----------------------------------------------

def beam_inputs(size):
    """The bench's synthetic 3-strain blocks, one copy per ploidy."""
    import numpy as np

    from bench import make_workload

    a, w, nr, eps = make_workload(size["G"], size["R"], size["S"],
                                  seed=SEED)
    k = len(PLOIDIES)
    return (np.concatenate([a] * k), np.concatenate([w] * k),
            np.concatenate([nr] * k), np.concatenate([eps] * k),
            np.repeat(np.array(PLOIDIES, np.int32), size["G"]))


def nw_inputs(size):
    """One chunk of realignment jobs: 32 bp query windows drawn from
    per-SNP reference windows with substitutions and 1-2 bp shifts (so
    gapped alignments win some jobs), two candidate alleles per SNP."""
    import numpy as np

    from floria_tpu.kernels import realign

    rng = np.random.default_rng(SEED + 2)
    T, W, n = 4096, realign.WINDOW, size["nw_jobs"]
    acgt = realign._ENC[np.frombuffer(b"ACGT", np.uint8)]
    genome = rng.integers(0, 4, T * 8 + 2 * W)
    starts = np.arange(T) * 8 + W
    ref = acgt[genome[starts[:, None] + np.arange(-realign.FLANK,
                                                  realign.FLANK)]]
    alt = acgt[(genome[starts] + rng.integers(1, 4, T)) % 4]
    al = np.stack([ref[:, realign.FLANK], alt], axis=1).astype(np.uint8)
    nal = np.full(T, 2, np.int32)
    si = rng.integers(0, T, n).astype(np.int32)
    shift = rng.choice([0, 0, 0, 1, -1, 2], n)
    pos = starts[si][:, None] + np.arange(-realign.FLANK,
                                          realign.FLANK) + shift[:, None]
    q = acgt[genome[pos]]
    use_alt = rng.random(n) < 0.5
    q[use_alt, realign.FLANK] = al[si[use_alt], 1]
    sub = rng.random((n, W)) < 0.03
    q[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
    return (realign._pack4(q).reshape(1, n, W // 2), si.reshape(1, n),
            ref.astype(np.uint8), al, nal)


# --- kernel runs (used by both the card and the CPU reference) ------------

def _timed(fn, reps=5):
    """(result, cold seconds, warm seconds): a first call, then the
    median of `reps` warm calls, each ended by block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return out, cold, sorted(warm)[reps // 2]


def run_beam(inputs, impl):
    import jax
    import numpy as np

    from floria_tpu.kernels import beam

    a, w, nr, eps, nparts = (jax.device_put(x) for x in inputs)

    def once():
        res = beam.beam_search_batch_mixed(
            a, w, nr, eps, nparts, max(PLOIDIES), BEAM_WIDTH,
            max_alleles=2, impl=impl)
        return beam.traceback_batch(tuple(res)), res.live, res.scores

    out, cold, warm = _timed(once)
    names = ("assign", "live", "scores")
    return {k: np.asarray(v) for k, v in zip(names, out)}, cold, warm


def run_upem(inputs):
    import jax
    import numpy as np

    from floria_tpu.kernels.upem_batch import upem_optimize_device

    a, w, nr, eps, _ = inputs
    rng = np.random.default_rng(SEED + 1)
    assign0 = rng.integers(0, UPEM_PLOIDY, a.shape[:2]).astype(np.int32)
    args = [jax.device_put(x) for x in (a, w, assign0, nr, eps)]
    out, cold, warm = _timed(lambda: upem_optimize_device(
        *args, UPEM_PLOIDY, max_alleles=2))
    names = ("best", "mec", "diff")
    return {k: np.asarray(v) for k, v in zip(names, out)}, cold, warm


def run_nw(inputs):
    import jax
    import numpy as np

    from floria_tpu.kernels import realign

    args = [jax.device_put(x) for x in inputs]
    out, cold, warm = _timed(lambda: realign._nw_best_chunked(
        *args, n_alleles_max=2))
    return {"best": np.asarray(out)}, cold, warm


# --- the CPU reference child ---------------------------------------------

def cli_run(argv, result_path):
    """floria_tpu.cli.main in this process; writes wall seconds, backend
    compile count, stage times and the device to result_path."""
    import jax

    from floria_tpu import cli, timing

    compiles = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda ev, dur, **kw: compiles.append(dur)
        if ev == "/jax/core/compile/backend_compile_duration" else None)
    t0 = time.perf_counter()
    cli.main(argv)
    secs = time.perf_counter() - t0
    d = jax.devices()[0]
    rec = {"seconds": secs, "compiles": len(compiles),
           "stages": dict(timing.STAGE_TIMES),
           "device": {"platform": d.platform, "kind": d.device_kind,
                      "count": len(jax.devices()),
                      "local_count": len(jax.local_devices())}}
    with open(result_path, "w") as fh:
        json.dump(rec, fh)
    return rec


def cpu_reference(size_name, work):
    """Child: the CPU-backend CLI run on the simulated community, then
    the kernel references (hist impl, UPEM, NW) saved as .npz."""
    import numpy as np

    size = SIZES[size_name]
    sim = os.path.join(work, "sim")
    cli_run(_cli_argv(sim, os.path.join(work, "out_cpu")),
            os.path.join(work, "cli_cpu.json"))
    inputs = beam_inputs(size)
    res, _c, _w = run_beam(inputs, "hist")
    np.savez(os.path.join(work, "ref_beam.npz"), **res)
    res, _c, _w = run_upem(inputs)
    np.savez(os.path.join(work, "ref_upem.npz"), **res)
    res, _c, _w = run_nw(nw_inputs(size))
    np.savez(os.path.join(work, "ref_nw.npz"), **res)


def _cli_argv(sim, out):
    return ["-b", os.path.join(sim, "sim.bam"),
            "-v", os.path.join(sim, "sim.vcf"),
            "-r", os.path.join(sim, "sim.fa"), "-o", out, "--overwrite"]


def _child_env(**extra):
    env = dict(os.environ)
    env.update(extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


# --- single-card phases ----------------------------------------------------

class Phases:
    """Runs named phases, recording failures without hiding them."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # recorded, reported, exit code nonzero
            import traceback

            traceback.print_exc()
            self.failed.append(f"{name}: {type(e).__name__}: {e}")
            log(f"== {name} FAILED ({e})")
            return
        log(f"== {name} passed ({time.perf_counter() - t0:.1f} s)")


def precision_probe():
    """Asserts exactness at EXACT_MATMUL_PRECISION and of the integer
    rank-select indices; prints whether DEFAULT and HIGH are exact."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from floria_tpu.kernels import beam

    prec = beam.EXACT_MATMUL_PRECISION
    P = jax.lax.Precision
    rng = np.random.default_rng(SEED)
    h = (rng.random((20, 320)) < 0.5).astype(np.float32)
    w = rng.integers(0, 8192, (320, 512)).astype(np.float32)
    want = h.astype(np.float64) @ w.astype(np.float64)

    def plane(p):
        return np.asarray(jax.jit(lambda a, b: jnp.einsum(
            "br,rx->bx", a, b, preferred_element_type=jnp.float32,
            precision=p))(h, w)).astype(np.float64)

    B, X = 50, 1024
    v = rng.integers(0, 1 << 24, (B, X)).astype(np.float32)
    perm = rng.permutation(B)
    oh = np.zeros((B, B), np.float32)
    oh[np.arange(B), perm] = 1.0

    def permute(p):
        return np.asarray(jax.jit(lambda a, b: jnp.einsum(
            "oB,BX->oX", a, b, preferred_element_type=jnp.float32,
            precision=p))(oh, v))

    found = {}
    for name, p in (("DEFAULT", P.DEFAULT), ("HIGH", P.HIGH),
                    ("EXACT_MATMUL_PRECISION", prec)):
        found[name] = {
            "plane_13bit_exact": bool(np.array_equal(plane(p), want)),
            "onehot_24bit_exact": bool(np.array_equal(permute(p),
                                                      v[perm]))}
    log(f"precision findings (EXACT_MATMUL_PRECISION = {prec}): "
        + json.dumps(found))
    check(found["EXACT_MATMUL_PRECISION"]["plane_13bit_exact"],
          "13-bit plane einsum inexact at EXACT_MATMUL_PRECISION")
    check(found["EXACT_MATMUL_PRECISION"]["onehot_24bit_exact"],
          "24-bit one-hot permutation inexact at EXACT_MATMUL_PRECISION")

    # Rank-select past 2048 slots (B = 2600 parents): integer indices
    # must match lax.top_k's (score asc, index asc) order exactly; an
    # f32 index matvec would need 12 bits, one more than TF32 keeps.
    Bs, Ps, out = 2600, 2, 2400
    cand = rng.integers(0, 1 << 20, (Bs, Ps)).astype(np.float64)
    cand[rng.random((Bs, Ps)) < 0.1] = np.inf
    sel = jax.jit(lambda c: beam._rank_select(c, out))(cand)
    _score, gather_oh, _part_oh, parent, part = (np.asarray(x)
                                                 for x in sel)
    order = np.argsort(np.minimum(cand.reshape(-1), 1e30),
                       kind="stable")[:out]
    check(np.array_equal(parent, order // Ps), "rank-select parent")
    check(np.array_equal(part, order % Ps), "rank-select part")
    old = np.asarray(jax.jit(lambda g: g @ jnp.arange(
        Bs, dtype=jnp.float32))(gather_oh))
    log("rank-select f32 matvec at DEFAULT would be exact: "
        f"{bool(np.array_equal(old.astype(np.int64), order // Ps))}")


def kernel_phase(size, work, report, ref):
    """Each device kernel vs the CPU backend's saved result, bitwise."""
    import numpy as np

    def same(name, got, ref):
        for k in ref.files:
            a, b = np.asarray(got[k]), ref[k]
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{name}.{k}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
            if a.tobytes() != b.tobytes():
                bad = np.flatnonzero((a != b).reshape(-1))
                raise AssertionError(
                    f"{name}.{k}: {len(bad)} elements differ from the "
                    f"CPU backend, first at flat index "
                    f"{bad[:1].tolist()}")

    inputs = beam_inputs(size)
    results = {}
    for impl in IMPLS:
        results[impl] = run_beam(inputs, impl)
        log(f"beam impl={impl}: cold {results[impl][1]:.3f} s, warm "
            f"(median of 5) {results[impl][2]:.4f} s")
    from floria_tpu.kernels import beam

    log(f"impl='auto' resolves to "
        f"{beam.resolve_impl('auto', size['R'])!r} on this backend")
    upem = run_upem(inputs)
    log(f"upem: cold {upem[1]:.3f} s, warm {upem[2]:.4f} s")
    nw = run_nw(nw_inputs(size))
    log(f"nw chunk ({size['nw_jobs']} jobs): cold {nw[1]:.3f} s, warm "
        f"{nw[2]:.4f} s")
    report["kernel_warm_seconds"] = {
        **{f"beam_{i}": results[i][2] for i in IMPLS},
        "upem": upem[2], "nw_chunk": nw[2]}
    _wait_reference(ref, work)
    beam_ref = np.load(os.path.join(work, "ref_beam.npz"))
    for impl in IMPLS:
        same(f"beam[{impl}]", results[impl][0], beam_ref)
    same("upem", upem[0], np.load(os.path.join(work, "ref_upem.npz")))
    same("nw", nw[0], np.load(os.path.join(work, "ref_nw.npz")))
    log("kernels: beam (planes, hist, counts), UPEM and NW bitwise equal "
        "to the CPU backend")


def _wait_reference(proc, work):
    """Wait for the CPU reference child (idempotent); raise if it
    failed."""
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"CPU reference child exited {rc}; see "
                           f"{os.path.join(work, 'cpu_ref.log')}")


def main_path_phase(work, report, ref):
    """E. coli config through the CLI on the card: cold, then warm."""
    import jax

    sim = os.path.join(work, "sim")
    dev = jax.devices()[0]
    peak0 = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    runs = {}
    for tag in ("cold", "warm"):
        runs[tag] = cli_run(
            _cli_argv(sim, os.path.join(work, f"out_gpu_{tag}")),
            os.path.join(work, f"cli_gpu_{tag}.json"))
        log(f"main path {tag}: {runs[tag]['seconds']:.2f} s, "
            f"{runs[tag]['compiles']} backend compiles")
    stats = dev.memory_stats() or {}
    stages = runs["warm"]["stages"]
    from floria_tpu import native

    tiers = ["native hamming<=2 precheck"] if native.get_lib() else []
    if "realign.device.cpp" in stages:
        tiers.append("C++ Gotoh")
    if "realign.device.dispatch" in stages:
        tiers.append("device NW")
    report["main_path"] = {
        "card": report.get("card"),
        "cold_seconds": runs["cold"]["seconds"],
        "warm_seconds": runs["warm"]["seconds"],
        "cold_compiles": runs["cold"]["compiles"],
        "warm_compiles": runs["warm"]["compiles"],
        "peak_bytes_in_use_before": peak0,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "realign_tiers": tiers,
        "warm_stages": stages}
    log("main path: " + json.dumps(report["main_path"]))
    _wait_reference(ref, work)
    cpu = json.load(open(os.path.join(work, "cli_cpu.json")))
    log(f"CPU-backend CLI run: {cpu['seconds']:.2f} s")
    out_cpu = os.path.join(work, "out_cpu")
    for tag in ("cold", "warm"):
        diffs = compare_outputs(out_cpu, os.path.join(work,
                                                      f"out_gpu_{tag}"))
        check(not diffs, f"GPU ({tag}) vs CPU outputs differ: {diffs}")
    log("main path: GPU outputs byte-identical to the CPU backend's")
    truth = json.load(open(os.path.join(work, "truth.json")))
    _check_truth(os.path.join(work, "out_gpu_cold"), truth, report)


def _check_truth(out_dir, truth_rec, report):
    """Both strains recovered: each is the best match of vartigs that
    cover >= 90% of the SNPs at >= 99% allele accuracy; haploset purity
    >= 0.99 (sim/evaluate.py)."""
    import numpy as np

    from floria_tpu.sim import evaluate
    from floria_tpu.sim.simulate import SimTruth

    truth = SimTruth(np.array(truth_rec["snp_positions"]),
                     np.array(truth_rec["strain_alleles"]),
                     truth_rec["read_strains"])
    contig = truth_rec["contig"]
    vpath = os.path.join(out_dir, contig, f"{contig}.vartigs")
    hpath = os.path.join(out_dir, contig, f"{contig}.haplosets")
    ve = evaluate.evaluate_vartigs(vpath, truth)
    he = evaluate.evaluate_haplosets(hpath, truth)
    n_snps = truth.strain_alleles.shape[1]
    covered = np.zeros((truth.strain_alleles.shape[0], n_snps), bool)
    for fields, seq in evaluate.parse_vartigs(vpath):
        left = int(fields["SNPRANGE"].split("-")[0])
        calls = np.frombuffer(seq.encode(), np.uint8)
        idx = np.arange(len(calls)) + left - 1
        ok = calls != ord("?")
        if not ok.any():
            continue
        acc = [(truth.strain_alleles[k, idx[ok]]
                == calls[ok] - ord("0")).mean()
               for k in range(len(covered))]
        k = int(np.argmax(acc))
        if acc[k] >= 0.99:
            covered[k, idx[ok]] = True
    strain_cov = covered.mean(axis=1).tolist()
    report["truth"] = {"vartig_accuracy": ve.weighted_accuracy,
                       "haploset_purity": he.weighted_purity,
                       "strain_snp_coverage": strain_cov}
    log("truth check: " + json.dumps(report["truth"]))
    check(min(strain_cov) >= 0.9,
          f"a strain was not recovered: {strain_cov}")
    check(ve.weighted_accuracy >= 0.99 and he.weighted_purity >= 0.99,
          "vartig accuracy or haploset purity below 0.99")


def simulate_community(community, work):
    """Simulate the community (host-only numpy) and save its truth."""
    from bench import e2e_config
    from floria_tpu.sim.simulate import simulate

    cfg, _tag = e2e_config(community == "quick2")
    truth = simulate(cfg, os.path.join(work, "sim"))
    with open(os.path.join(work, "truth.json"), "w") as fh:
        json.dump({"contig": cfg.contig_name,
                   "snp_positions": truth.snp_positions.tolist(),
                   "strain_alleles": truth.strain_alleles.tolist(),
                   "read_strains": truth.read_strains}, fh)


def single_card(rehearse: bool) -> int:
    import jax

    size = SIZES["toy" if rehearse else "real"]
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu" and not rehearse:
        print(f"chip_smoke: no GPU (JAX platform {d.platform!r})",
              file=sys.stderr)
        return 1
    device = {"platform": d.platform, "kind": d.device_kind,
              "count": len(devs)}
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    phases = Phases()
    report = {}

    def device_phase():
        from bench import nvidia_smi_card

        report["card"] = (nvidia_smi_card() if not rehearse
                          else "not measured (CPU rehearsal)")
        log(f"card: {report['card']}")
        log("jax device: " + json.dumps(device))
        from floria_tpu import native
        log(f"native library: {'built' if native.get_lib() else 'absent'}")

    phases.run("device", device_phase)
    t0 = time.perf_counter()
    simulate_community(size["community"], WORK)
    log(f"simulated {size['community']} in "
        f"{time.perf_counter() - t0:.1f} s")
    with open(os.path.join(WORK, "cpu_ref.log"), "w") as logf:
        ref = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference",
             "toy" if rehearse else "real"],
            cwd=REPO, stdout=logf, stderr=subprocess.STDOUT,
            env=_child_env(JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES=""))
    phases.run("precision", precision_probe)
    try:
        phases.run("kernels",
                   lambda: kernel_phase(size, WORK, report, ref))
        phases.run("main path", lambda: main_path_phase(WORK, report, ref))
    finally:
        if ref.poll() is None:
            ref.kill()
        ref.wait()
    log("card: " + str(report.get("card")))
    log("summary: " + json.dumps(report))
    if phases.failed:
        log("FAILED phases: " + "; ".join(phases.failed))
        return 1
    if rehearse:
        print(json.dumps({"rehearsal": True, "phases_failed": 0,
                          "device": device}))
        return 0
    print(json.dumps({"ok": True, "device": device}))
    return 0


# --- four cards ------------------------------------------------------------

def four_cards(rehearse: bool) -> int:
    """Multi-device paths only; this process stays off JAX. Children in
    turn: one card (--num-devices 1), one process over 4 cards, and 4
    processes with one card each; outputs byte-compared. Rehearsal runs
    the same children on 4 virtual CPU devices."""
    work = os.path.join(WORK, "four")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    from bench import nvidia_smi_card

    card = ("not measured (CPU rehearsal)" if rehearse
            else nvidia_smi_card())

    def env(n_virtual):
        if not rehearse:
            return _child_env()
        return _child_env(JAX_PLATFORMS="cpu", XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={n_virtual}"))

    sim = os.path.join(work, "sim")
    code = ("import sys; sys.path.insert(0, %r); "
            "from scripts.multihost_bench import build_sim; "
            "build_sim(50, %r)" % (REPO, sim))
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=_child_env(JAX_PLATFORMS="cpu",
                                  CUDA_VISIBLE_DEVICES=""))
    log(f"simulated 50 contigs x 60 kb in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for tag, extra in (("one_card", ["--num-devices", "1"]),
                       ("mesh_4", [])):
        res = os.path.join(work, f"{tag}.json")
        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cli-child", res,
             "--", *_cli_argv(sim, os.path.join(work, tag)), *extra],
            check=True, cwd=REPO, env=env(4))
        runs[tag] = json.load(open(res))
        log(f"{tag}: {runs[tag]['seconds']:.2f} s, device "
            f"{runs[tag]['device']}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = os.path.join(work, "procs_4")
    procs = []
    t0 = time.perf_counter()
    for pid in range(4):
        res = os.path.join(work, f"procs_4.{pid}.json")
        argv = [*_cli_argv(sim, out), "--num-processes", "4",
                "--process-id", str(pid), "--coordinator",
                f"localhost:{port}"]
        with open(os.path.join(work, f"procs_4.{pid}.log"), "w") as lf:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cli-child",
                 res, "--", *argv], cwd=REPO, env=env(1),
                stdout=lf, stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    check(rcs == [0] * 4, f"multi-process ranks exited {rcs}")
    ranks = [json.load(open(os.path.join(work, f"procs_4.{i}.json")))
             for i in range(4)]
    log(f"procs_4: {wall:.2f} s wall, rank devices "
        f"{[r['device'] for r in ranks]}")
    check(all(r["device"]["local_count"] == 1 for r in ranks),
          "each process must drive exactly one card")
    failed = []
    for tag, d in (("mesh_4", os.path.join(work, "mesh_4")),
                   ("procs_4", out)):
        diffs = compare_outputs(os.path.join(work, "one_card"), d,
                                skip=RANK_TSV)
        log(f"{tag} vs one_card: "
            f"{'byte-identical' if not diffs else diffs}")
        if diffs:
            failed.append(tag)
    dev = dict(runs["mesh_4"]["device"])
    del dev["local_count"]
    if dev["count"] != 4 or (dev["platform"] != "gpu" and not rehearse):
        failed.append(f"expected 4 GPUs, JAX saw {dev}")
    log(f"card: {card}")
    if failed:
        log("FAILED: " + "; ".join(failed))
        return 1
    print(json.dumps({"rehearsal": True, "device": dev} if rehearse
                     else {"ok": True, "device": dev}))
    return 0


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "floria_tpu")):
        print("chip_smoke: run from a checkout of the repository (the "
              "floria_tpu package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--cpu-reference", choices=sorted(SIZES),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cli-child", metavar="RESULT_JSON",
                    help=argparse.SUPPRESS)
    ap.add_argument("cli_argv", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_reference:
        cpu_reference(args.cpu_reference, WORK)
        return 0
    if args.cli_child:
        cli_run(args.cli_argv, args.cli_child)
        return 0
    if args.four_cards:
        return four_cards(args.rehearse)
    return single_card(args.rehearse)


if __name__ == "__main__":
    sys.exit(main())
