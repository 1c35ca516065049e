"""Benchmark: device beam-search phasing throughput vs a MEASURED
single-core CPU baseline, plus an end-to-end pipeline metric.

Kernel metric: unique (read, block) insertions per second through the
batched beam-search ploidy sweep (SURVEY.md §3.2: beam scoring dominates
the reference's runtime) on a synthetic 3-strain workload shaped like
real long-read blocks (R reads x S SNPs, ploidy sweep 2..5, beam width
10), batched G blocks per dispatch as the pipeline does.

vs_baseline: the reference publishes no numbers (BASELINE.md) and no Rust
toolchain exists in this image, so the denominator is MEASURED from
native/baseline.cpp's `faithful` variant — a single-core C++ port of the
reference's inner loop that reproduces the exact oracle semantics
(hashmap haplotypes, truncated block clones, duplicate-block dedup;
validated read-for-read against tests/oracle.py in tests/test_native.py)
— run on a slice of the same workload in the same process. The dense
(generous, no-hashmap, no-dedup) C++ upper bound is also reported.

e2e metric: the 2-strain E. coli config from BASELINE.md (1 Mbp, 50k
SNPs, ~100x => ~11k reads) through the full pipeline (ingest ->
realign -> beam -> UPEM -> graph/LP -> outputs), reads/s end to end.
Simulated input is cached under .bench_cache/ so repeat runs skip
generation.

Device numbers come only from a GPU: a run whose JAX backend is not
"gpu" exits nonzero before measuring, and every result names the
device_kind plus the card's name and power limit (nvidia-smi).
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

FALLBACK_BASELINE_READS_PER_SEC = 2000.0  # used only if native build fails


def make_workload(G, R, S, num_strains=3, epsilon=0.02, seed=0):
    rng = np.random.default_rng(seed)
    strains = rng.integers(0, 2, (G, num_strains, S))
    origin = rng.integers(0, num_strains, (G, R))
    span = S // 2
    starts = rng.integers(0, S - span, (G, R))
    alleles = np.full((G, R, S), -1, dtype=np.int8)
    weights = np.zeros((G, R, S), dtype=np.float32)
    for g in range(G):
        for r in range(R):
            s0 = starts[g, r]
            hap = strains[g, origin[g, r], s0:s0 + span].copy()
            err = rng.random(span) < epsilon
            hap[err] = 1 - hap[err]
            alleles[g, r, s0:s0 + span] = hap
            weights[g, r, s0:s0 + span] = 1.0 - 10.0 ** (
                rng.integers(10, 40, span) / -10.0)
    order = np.argsort(starts, axis=1, kind="stable")
    alleles = np.take_along_axis(alleles, order[:, :, None], axis=1)
    weights = np.take_along_axis(weights, order[:, :, None], axis=1)
    num_reads = np.full(G, R, dtype=np.int32)
    eps = np.full(G, epsilon, dtype=np.float32)
    return alleles, weights, num_reads, eps


def measure_kernel(args, quick):
    """Production-path sweep: ONE mixed-ploidy dispatch phases every
    block at ploidies 2..5 simultaneously (what phase_instances
    dispatches per shape bucket)."""
    import jax

    from floria_tpu.kernels.beam import beam_search_batch_mixed

    alleles, weights, num_reads, eps = args
    G, R, _S = alleles.shape
    ploidies = (2, 3, 4, 5)
    iters = 2 if quick else 3
    # Device-resident inputs: the kernel metric measures compute, not
    # the host->device copy (whose cost shows up in the e2e metric).
    alleles4 = jax.device_put(np.concatenate([alleles] * len(ploidies)))
    weights4 = jax.device_put(np.concatenate([weights] * len(ploidies)))
    nr4 = jax.device_put(np.concatenate([num_reads] * len(ploidies)))
    eps4 = jax.device_put(np.concatenate([eps] * len(ploidies)))
    nparts = jax.device_put(np.repeat(np.array(ploidies,
                                               dtype=np.int32), G))

    def sweep():
        # max_alleles=2: the pipeline dispatches at the batch's actual
        # allele-value width (biallelic here), and the C++ baseline
        # already runs at max_alleles=2 — apples to apples.
        out = beam_search_batch_mixed(alleles4, weights4, nr4, eps4,
                                      nparts, max(ploidies), 10,
                                      max_alleles=2)
        jax.block_until_ready(out)

    sweep()  # compile + warm
    t0 = time.time()
    for _ in range(iters):
        sweep()
    elapsed = time.time() - t0
    return G * R * iters / elapsed


def measure_cpu_baseline(args, quick):
    """Measured single-core denominators: (faithful, dense) reads/s, or
    (None, None) when the native toolchain is unavailable."""
    from floria_tpu import native

    if native.get_lib() is None:
        return None, None
    alleles, weights, _nr, eps = args
    g_sub = 2 if quick else 4
    a = alleles[:g_sub]
    w = weights[:g_sub]
    out = []
    for faithful in (True, False):
        t0 = time.time()
        n = native.baseline_sweep(a, w, [2, 3, 4, 5], 10,
                                  float(eps[0]), faithful=faithful)
        out.append(n / (time.time() - t0))
    return out[0], out[1]


def e2e_config(quick):
    """(SimConfig, tag) of the e2e benchmark community."""
    from floria_tpu.sim.simulate import SimConfig

    if quick:
        return SimConfig(contig_len=60_000, num_strains=2, num_snps=400,
                         coverage_per_strain=8.0, read_length=6_000,
                         read_length_sd=1_000.0, error_rate=0.02,
                         seed=11), "quick2"
    return SimConfig(contig_len=1_000_000, num_strains=2,
                     num_snps=50_000, coverage_per_strain=50.0,
                     read_length=9_000, read_length_sd=1_500.0,
                     error_rate=0.02, seed=11), "ecoli2"


def measure_baseline_e2e(quick, force=False):
    """Single-core oracle-pipeline e2e denominator (VERDICT r3 #6: the
    kernel ratio alone excludes ingest+join). The measurement is
    expensive (minutes, pinned to one cpu), so it persists in
    BASELINE_E2E.json (committed) and normal bench runs just read it;
    re-measure with --measure-baseline-e2e."""
    import subprocess

    repo = os.path.dirname(os.path.abspath(__file__))
    cfg, tag = e2e_config(quick)
    path = os.path.join(repo, "BASELINE_E2E.json")
    rec = {}
    if os.path.exists(path):
        with open(path) as fh:
            rec = json.load(fh)
    if not force:
        return rec.get(tag)
    from floria_tpu.sim.simulate import simulate

    cache = os.path.join(repo, ".bench_cache", tag)
    if not os.path.exists(os.path.join(cache, "sim.bam")):
        simulate(cfg, cache)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable,
         os.path.join(repo, "scripts", "oracle_e2e_baseline.py"),
         cache, cfg.contig_name],
        env=env, capture_output=True, text=True, timeout=7200)
    data = json.loads(out.stdout.strip().splitlines()[-1])
    rec[tag] = data
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    return data


def measure_e2e(quick, repeat=False):
    """Full-pipeline reads/s on the BASELINE.md E. coli config (small
    community under --quick). Returns (reads_per_sec, seconds, n_reads,
    stages). With repeat=True the pipeline runs again in-process: the
    second run reuses traced jits and warm device executables, giving
    the steady-state number (a long-lived service / multi-contig run),
    while the first includes one-time trace + executable-deserialize."""
    from floria_tpu.options import Options
    from floria_tpu.pipeline import run
    from floria_tpu.sim.simulate import simulate

    cfg, tag = e2e_config(quick)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache", tag)
    if not os.path.exists(os.path.join(cache, "sim.bam")):
        simulate(cfg, cache)
    out_dir = os.path.join(cache, "out")
    if os.path.exists(out_dir):
        shutil.rmtree(out_dir)
    opts = Options(bam_file=os.path.join(cache, "sim.bam"),
                   vcf_file=os.path.join(cache, "sim.vcf"),
                   reference_fasta=os.path.join(cache, "sim.fa"),
                   out_dir=out_dir, overwrite=True)
    t0 = time.time()
    run(opts)
    elapsed = time.time() - t0
    # Count phased reads (haploset members + snpless) from the outputs.
    n_reads = 0
    contig_dir = os.path.join(out_dir, cfg.contig_name)
    hs = os.path.join(contig_dir, f"{cfg.contig_name}.haplosets")
    if os.path.exists(hs):
        with open(hs) as fh:
            n_reads += sum(1 for line in fh if not line.startswith(">"))
    from floria_tpu import timing
    stages = {k: round(v, 1) for k, v in timing.STAGE_TIMES.items()}
    out = [(n_reads / elapsed, elapsed, n_reads, stages)]
    if repeat:
        # Steady state = best of two warm repeats: host stages swing
        # run to run, and the steady-state number should reflect the
        # pipeline, not a bad draw.
        best = None
        for _ in range(2):
            shutil.rmtree(out_dir, ignore_errors=True)
            opts2 = Options(bam_file=opts.bam_file,
                            vcf_file=opts.vcf_file,
                            reference_fasta=opts.reference_fasta,
                            out_dir=out_dir, overwrite=True)
            t0 = time.time()
            run(opts2)
            elapsed = time.time() - t0
            stages = {k: round(v, 1)
                      for k, v in timing.STAGE_TIMES.items()}
            if best is None or elapsed < best[1]:
                best = (n_reads / elapsed, elapsed, n_reads, stages)
        out.append(best)
    return out


def _xla_cache_entries():
    """Entries in the persistent XLA compile cache (empty => the next
    run pays first-contact compiles)."""
    from floria_tpu import cache_dir

    try:
        return len(os.listdir(cache_dir()))
    except OSError:
        return 0


def nvidia_smi_card() -> str:
    """First card's "name, power limit" as nvidia-smi reports them (a
    card below its maximum power limit runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_record():
    """The device every number of this run was taken on: JAX's platform,
    device_kind and count, plus nvidia-smi's card name and power limit.
    Raises SystemExit when the backend is not a GPU — a CPU number is
    never reported under a device metric."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py: no GPU (JAX platform "
                         f"{devs[0].platform!r}); device numbers come "
                         f"only from a GPU run")
    return {"platform": devs[0].platform,
            "device_kind": devs[0].device_kind, "count": len(devs),
            "card": nvidia_smi_card()}


def _check_kernel_floor(result, floors_path=None, best_path=None):
    """Fail LOUDLY on a silent kernel regression (VERDICT r4: the exact-
    arithmetic rework shipped a ~3x device-kernel slowdown that no
    bench run re-measured). Two tiers:

    - committed floors (bench_floors.json when present): absolute
      minimums for the capture of record; a result below a floor marks
      the JSON and prints to stderr. None is committed until a GPU
      capture sets them.
    - session bests (.bench_cache/kernel_best.json, per-machine): only
      improve; a result < 0.5x a recorded best is flagged the same way.

    Returns True when a regression fired (main() exits nonzero under
    --assert-floors)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    if floors_path is None:
        floors_path = os.path.join(repo, "bench_floors.json")
    if best_path is None:
        best_path = os.path.join(repo, ".bench_cache",
                                 "kernel_best.json")
    keys = ("value", "kernel_realshape_reads_per_sec")
    floors = {}
    if os.path.exists(floors_path):
        with open(floors_path) as fh:
            floors = json.load(fh)
    best = {}
    if os.path.exists(best_path):
        with open(best_path) as fh:
            best = json.load(fh)
    regressions = {}
    for k in keys:
        v = result.get(k)
        if v is None:
            continue
        fl = floors.get(k)
        if fl is not None and v < fl:
            regressions[k] = {"reads_per_sec": v, "committed_floor": fl}
        b = best.get(k)
        if b is not None and v < 0.5 * b:
            regressions.setdefault(k, {}).update(
                {"reads_per_sec": v, "recorded_best": b})
        if b is None or v > b:
            best[k] = v
    os.makedirs(os.path.dirname(best_path), exist_ok=True)
    with open(best_path, "w") as fh:
        json.dump(best, fh)
    if regressions:
        result["kernel_regression"] = regressions
        print(f"KERNEL REGRESSION: {json.dumps(regressions)}",
              file=sys.stderr)
        return True
    return False


def _check_stage_regressions(result):
    """Track per-stage recorded bests across runs and flag >2x
    regressions (VERDICT r2: a 3x stage swing would ship silently).
    Uses the WARM stages (steady state); bests persist in
    .bench_cache/stage_best.json and only improve."""
    stages = result.get("e2e_warm_stages") or result.get("e2e_stages")
    if not stages:
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        ".bench_cache", "stage_best.json")
    best = {}
    if os.path.exists(path):
        with open(path) as fh:
            best = json.load(fh)
    regressions = {}
    for k, v in stages.items():
        b = best.get(k)
        if b is not None and b >= 0.3 and v > 2.0 * b:
            regressions[k] = {"seconds": v, "recorded_best": b}
        if b is None or v < b:
            best[k] = v
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(best, fh)
    if regressions:
        result["stage_regressions"] = regressions


def main():
    quick = "--quick" in sys.argv
    skip_e2e = "--no-e2e" in sys.argv
    device = device_record()
    # Snapshot BEFORE any device work: measure_kernel's own compiles
    # populate the cache, so reading the count later would mislabel a
    # first-contact e2e run as warm (seen in the round-5 run-1 log:
    # phase.launch 531s yet labeled warm-cache).
    cache_entries_at_start = _xla_cache_entries()

    G, R, S = (8, 64, 128) if quick else (32, 256, 256)
    args = make_workload(G, R, S)

    kernel_rps = measure_kernel(args, quick)
    # Real-block-shape kernel config: e2e blocks bucket at R~320,
    # S~1536-2048 (reads' tails extend past block ends), where per-step
    # cost is several times the S=256 config's — report both so the
    # headline reflects what the pipeline actually pays (VERDICT r2 #4).
    real_rps = real_base = None
    if not quick:
        real_args = make_workload(8, 320, 2048)
        real_rps = measure_kernel(real_args, quick)
        from floria_tpu import native
        if native.get_lib() is not None:
            a1, w1 = real_args[0][:1], real_args[1][:1]
            t0 = time.time()
            n = native.baseline_sweep(a1, w1, [2, 3, 4, 5], 10,
                                      float(real_args[3][0]),
                                      faithful=True)
            real_base = n / (time.time() - t0)
    base_faithful, base_dense = measure_cpu_baseline(args, quick)
    denom = base_faithful or FALLBACK_BASELINE_READS_PER_SEC

    result = {
        "device": device,
        "metric": "reads_per_sec_per_chip",
        "value": round(kernel_rps, 1),
        "unit": "reads/s (full 2..5 ploidy sweep, beam 10)",
        "vs_baseline": round(kernel_rps / denom, 2),
        "baseline_cpu_faithful_reads_per_sec": (
            round(base_faithful, 1) if base_faithful else None),
        "baseline_cpu_dense_reads_per_sec": (
            round(base_dense, 1) if base_dense else None),
        "baseline_measured": base_faithful is not None,
    }
    if real_rps is not None:
        result["kernel_realshape_reads_per_sec"] = round(real_rps, 1)
        result["kernel_realshape_config"] = "G=8 R=320 S=2048"
        if real_base:
            result["kernel_realshape_vs_baseline"] = round(
                real_rps / real_base, 2)
            result["baseline_realshape_reads_per_sec"] = round(
                real_base, 1)
    if not skip_e2e:
        cache_entries = cache_entries_at_start
        runs = measure_e2e(quick, repeat=not quick)
        e2e_rps, e2e_s, e2e_reads, e2e_stages = runs[0]
        result["e2e_reads_per_sec"] = round(e2e_rps, 1)
        result["e2e_seconds"] = round(e2e_s, 1)
        # Cold semantics: on an empty persistent cache the first run
        # blends one-time compiles into e2e_seconds — label it so the
        # capture is interpretable.
        result["e2e_cold_kind"] = (
            "first-contact-compile-empty-cache" if cache_entries == 0
            else "in-process-first-run-warm-cache")
        result["e2e_reads"] = e2e_reads
        result["e2e_stages"] = e2e_stages
        if len(runs) > 1:
            w_rps, w_s, _, w_stages = runs[1]
            result["e2e_warm_reads_per_sec"] = round(w_rps, 1)
            result["e2e_warm_seconds"] = round(w_s, 1)
            result["e2e_warm_stages"] = w_stages
        base_e2e = measure_baseline_e2e(
            quick, force="--measure-baseline-e2e" in sys.argv)
        if base_e2e:
            denom_e2e = base_e2e["baseline_e2e_reads_per_sec"]
            best_rps = (result.get("e2e_warm_reads_per_sec")
                        or result["e2e_reads_per_sec"])
            result["e2e_vs_baseline"] = round(best_rps / denom_e2e, 2)
            result["baseline_e2e_reads_per_sec"] = denom_e2e
        if not quick:  # quick-config stage times would poison the bests
            _check_stage_regressions(result)
    regressed = False
    if not quick:   # quick-config numbers must not poison the floors
        regressed = _check_kernel_floor(result)
    print(json.dumps(result))
    if regressed and "--assert-floors" in sys.argv:
        sys.exit(1)


if __name__ == "__main__":
    main()
