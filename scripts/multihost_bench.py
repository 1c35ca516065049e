"""Multi-process scaling benchmark: the 500-contig metagenome config
(BASELINE.json configs #5) phased by 1/2/4 jax.distributed CPU
processes, wall-clocked, with scaling efficiency.

Why CPU processes: the multi-HOST axis (the reference's rayon pool
analog, parse_cmd_line.rs:153-156, scaled out) is emulated by real
jax.distributed processes on the CPU backend — the same contig-sharded
run_multihost path a multi-host deployment uses, with real coordinator
handshakes and the rank-0 TSV merge barrier. Host-side stages (ingest,
join/outputs) dominate e2e cost and are what this axis scales.

Two measurement modes:
  * pinned (default, the honest strong-scaling emulation on one box):
    every process is bound to its own core via taskset, so per-"host"
    resources are constant across N — T(1 proc, 1 core) vs
    T(N procs, N cores), efficiency = T1 / (N * TN).
  * --no-pin: free-for-all on all cores (reported for context; the
    1-proc baseline then already multi-threads, understating scaling).

Usage:
    python scripts/multihost_bench.py [--contigs 500] [--procs 1,2,4]
        [--no-pin] [--json MULTIHOST_BENCH.json]

Outputs one JSON line per run plus a final summary JSON (written to
--json), and byte-compares the N-process vartigs against the 1-process
run (500-contig correctness evidence).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_sim(n_contigs: int, base: str) -> None:
    """Cache a metagenome: n_contigs x 60 kb, 2 strains each, ~300
    SNPs/contig, ~8x per strain of 6 kb reads (the 50-contig
    VALIDATION.md config scaled out)."""
    if os.path.exists(os.path.join(base, "sim.bam")):
        return
    from floria_tpu.sim.simulate import SimConfig, simulate_multi

    cfgs = [
        SimConfig(contig_name=f"mg{c:04d}", contig_len=60_000,
                  num_strains=2, num_snps=300, coverage_per_strain=8.0,
                  read_length=6_000, read_length_sd=1_000.0,
                  error_rate=0.02, seed=4000 + c)
        for c in range(n_contigs)
    ]
    t0 = time.time()
    simulate_multi(cfgs, base)
    print(f"sim: built {n_contigs} contigs in {time.time() - t0:.0f}s",
          flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_main(args) -> None:
    """One rank: CPU backend, jax.distributed, run_multihost TWICE.

    Pass 1 (cold: fresh process against a warm machine-local XLA cache
    — trace + executable-deserialize dominate its fixed cost) phases
    into a scratch dir; pass 2 (steady: the long-lived pod-process
    model, jits warm in-process) produces the kept outputs. Per-rank
    pass times land in rank<pid>.times.json for the parent to
    aggregate."""
    import shutil

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.nproc > 1:
        jax.distributed.initialize(
            coordinator_address=f"127.0.0.1:{args.port}",
            num_processes=args.nproc, process_id=args.pid)
    from floria_tpu.options import Options
    from floria_tpu.parallel.multihost import run_multihost

    from floria_tpu import timing

    times = {}
    for label, out in (("cold_s", args.out + ".warmup"),
                       ("steady_s", args.out)):
        options = Options(
            bam_file=os.path.join(args.base, "sim.bam"),
            vcf_file=os.path.join(args.base, "sim.vcf"),
            reference_fasta=os.path.join(args.base, "sim.fa"),
            out_dir=out, epsilon=0.02, block_length=6_000,
            overwrite=True)
        t0 = time.time()
        run_multihost(options, args.nproc, args.pid,
                      coordinator=f"127.0.0.1:{args.port}")
        times[label] = round(time.time() - t0, 1)
        # Stage attribution per pass (run() resets the accumulator at
        # entry, so this snapshot is this pass's breakdown).
        times[label + "_stages"] = {
            k: round(v, 2) for k, v in sorted(
                timing.STAGE_TIMES.items(), key=lambda kv: -kv[1])[:12]}
    if args.pid == 0:
        shutil.rmtree(args.out + ".warmup", ignore_errors=True)
    with open(os.path.join(args.out,
                           f"rank{args.pid}.times.json"), "w") as fh:
        json.dump(times, fh)


def run_config(base: str, out: str, nproc: int, pin: bool,
               ncores: int) -> float:
    """Spawn nproc ranks, return wall seconds (spawn -> all joined)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    # Machine-local persistent XLA cache: a long-lived deployment does
    # not recompile per rank, so neither should the scaling numbers.
    env["FLORIA_CPU_CACHE"] = "1"
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(base, ".xla_cache")
    port = _free_port()
    me = os.path.abspath(__file__)
    t0 = time.time()
    procs = []
    os.makedirs(out, exist_ok=True)
    logs = []
    for pid in range(nproc):
        cmd = [sys.executable, me, "--worker", "--base", base,
               "--out", out, "--nproc", str(nproc), "--pid", str(pid),
               "--port", str(port)]
        if pin:
            cmd = ["taskset", "-c", str(pid % ncores)] + cmd
        # Worker output goes to FILES, never PIPEs: a rank blocked on a
        # full 64 KB pipe (the parent drains rank 0 first) stalls
        # mid-log while rank 0 waits for it at the TSV-merge barrier —
        # a deadlock at real contig counts (hit at 500, not at 16).
        log = open(os.path.join(out, f"rank{pid}.log"), "wb")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    fail = None
    for pid, p in enumerate(procs):
        p.wait(timeout=14_400)
        logs[pid].close()
        if p.returncode != 0 and fail is None:
            with open(os.path.join(out, f"rank{pid}.log")) as fh:
                fail = fh.read()[-4000:]
    if fail:
        raise RuntimeError(f"worker failed:\n{fail}")
    return time.time() - t0


def count_reads(out: str) -> int:
    n = 0
    for root, _dirs, files in os.walk(out):
        for f in files:
            if f.endswith(".haplosets"):
                with open(os.path.join(root, f)) as fh:
                    n += sum(1 for ln in fh if not ln.startswith(">"))
    return n


def compare_outputs(ref_out: str, out: str) -> int:
    """Byte-compare every .vartigs/.haplosets between two runs (HAP
    headers embed out_dir; normalized). Returns #files compared."""
    n = 0
    for root, _dirs, files in os.walk(ref_out):
        for f in files:
            if not (f.endswith(".vartigs") or f.endswith(".haplosets")):
                continue
            rel = os.path.relpath(os.path.join(root, f), ref_out)
            a = open(os.path.join(ref_out, rel)).read()
            b = open(os.path.join(out, rel)).read()
            assert a.replace(ref_out, "O") == b.replace(out, "O"), rel
            n += 1
    return n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--base")
    ap.add_argument("--out")
    ap.add_argument("--nproc", type=int)
    ap.add_argument("--pid", type=int)
    ap.add_argument("--port", type=int)
    ap.add_argument("--contigs", type=int, default=500)
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--no-pin", action="store_true")
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--json", default=os.path.join(
        REPO, "MULTIHOST_BENCH.json"))
    args = ap.parse_args()

    if args.worker:
        worker_main(args)
        return

    ncores = os.cpu_count() or 4
    base = args.base or os.path.join(REPO, ".bench_cache",
                                     f"meta{args.contigs}")
    build_sim(args.contigs, base)

    proc_counts = [int(x) for x in args.procs.split(",")]
    pin = not args.no_pin
    results = {}
    ref_out = None
    import shutil

    for i, nproc in enumerate(proc_counts):
        out = os.path.join(base, f"out_p{nproc}")
        if not args.no_warm:
            # Discarded pass PER PROC COUNT: each rank's contig shard
            # jits its own shape variants, so the persistent XLA cache
            # must be populated at every topology (rank > 0 writes need
            # multihost._allow_rank_cache_writes). Compile cost is fixed
            # per process and absent on a long-lived deployment, so it
            # must not masquerade as scaling loss; the pass also faults
            # the BAM into the page cache.
            shutil.rmtree(out, ignore_errors=True)
            warm_wall = run_config(base, out, nproc, pin, ncores)
            print(json.dumps({"nproc": nproc, "warm_pass_wall_s":
                              round(warm_wall, 1)}), flush=True)
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(out + ".warmup", ignore_errors=True)
        wall = run_config(base, out, nproc, pin, ncores)
        reads = count_reads(out)
        # Per-pass times: slowest rank bounds each pass (the barrier).
        cold = steady = 0.0
        for pid in range(nproc):
            with open(os.path.join(out,
                                   f"rank{pid}.times.json")) as fh:
                t = json.load(fh)
            cold = max(cold, t["cold_s"])
            steady = max(steady, t["steady_s"])
        results[nproc] = {"wall_s": round(wall, 1),
                          "cold_s": cold, "steady_s": steady,
                          "steady_reads_per_sec": round(reads / steady,
                                                        1),
                          "reads": reads}
        if 1 in results and nproc > 1:
            for key, eff in (("cold_s", "cold_efficiency"),
                             ("steady_s", "steady_efficiency")):
                t1 = results[1][key]
                results[nproc][eff] = round(
                    t1 / (nproc * results[nproc][key]), 3)
        print(json.dumps({"nproc": nproc, **results[nproc]}),
              flush=True)
        if ref_out is None:
            ref_out = out
        else:
            n = compare_outputs(ref_out, out)
            results[nproc]["outputs_match_1proc"] = n
            print(f"outputs byte-identical to 1-proc run "
                  f"({n} files)", flush=True)

    summary = {
        "config": f"{args.contigs}-contig metagenome "
                  f"(60kb x 2 strains x ~300 SNPs each)",
        "mode": "pinned 1 core/process" if pin else "unpinned",
        "results": results,
    }
    with open(args.json, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
