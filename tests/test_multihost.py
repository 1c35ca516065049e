"""Multi-host tests: shard assignment, output merging, and REAL
multi-process execution — two jax.distributed CPU processes phase a
contig-sharded metagenome and must produce outputs byte-identical to a
single-process run."""

import os
import socket
import subprocess
import sys

import pytest

from floria_tpu import constants
from floria_tpu.options import Options
from floria_tpu.parallel.multihost import (_merge_ploidy_tsvs,
                                           contigs_for_process)


def test_contig_sharding_partition():
    contigs = [f"c{i}" for i in range(11)]
    shards = [contigs_for_process(contigs, p, 4) for p in range(4)]
    flat = [c for s in shards for c in s]
    assert sorted(flat) == sorted(contigs)
    assert len(set(flat)) == len(contigs)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1


def test_contig_sharding_weighted():
    """LPT sharding: a partition, deterministic, and balanced even when
    one contig dwarfs the rest (the case round-robin loses:
    [1000,1,1,...] round-robin puts 1000+k/4 on shard 0)."""
    contigs = [f"c{i}" for i in range(13)]
    weights = [1000.0] + [10.0] * 12
    shards = [contigs_for_process(contigs, p, 4, weights)
              for p in range(4)]
    flat = [c for s in shards for c in s]
    assert sorted(flat) == sorted(contigs)
    assert len(set(flat)) == len(contigs)
    # The giant contig sits alone; the 12 small ones split 4/4/4.
    loads = [sum(weights[contigs.index(c)] for c in s) for s in shards]
    assert sorted(len(s) for s in shards) == [1, 4, 4, 4]
    assert max(loads[1:]) == min(loads[1:]) == 40.0
    # Same assignment recomputed by every rank (pure function).
    assert shards == [contigs_for_process(contigs, p, 4, weights)
                      for p in range(4)]
    # Within-shard order preserves input order.
    for s in shards:
        assert s == sorted(s, key=contigs.index)


def test_contig_sharding_weighted_uniform_balances():
    """Equal weights degrade to an even split."""
    contigs = [f"c{i}" for i in range(11)]
    shards = [contigs_for_process(contigs, p, 4, [5.0] * 11)
              for p in range(4)]
    sizes = sorted(len(s) for s in shards)
    assert sizes == [2, 3, 3, 3]
    assert sorted(c for s in shards for c in s) == sorted(contigs)


def test_merge_ploidy_tsvs(tmp_path):
    opts = Options(out_dir=str(tmp_path))
    rows = {
        0: ["c0\t1.0\n", "c2\t2.0\n"],
        1: ["c1\t1.5\n"],
    }
    for pid, lines in rows.items():
        with open(tmp_path / f"contig_ploidy_info.{pid}.tsv", "w") as f:
            f.write(constants.CONTIG_PLOIDY_HEADER)
            f.writelines(lines)
    _merge_ploidy_tsvs(opts, ["c0", "c1", "c2"])
    merged = (tmp_path / "contig_ploidy_info.tsv").read_text().splitlines()
    assert merged[0].startswith("contig\t")
    assert [l.split("\t")[0] for l in merged[1:]] == ["c0", "c1", "c2"]


def _build_multi_sim(base):
    from floria_tpu.ingest.bam import BamFile
    from floria_tpu.ingest.fasta import write_fasta
    from floria_tpu.sim import bamwrite
    from floria_tpu.sim.simulate import SimConfig, simulate

    contigs = []
    all_records = []
    fastas = {}
    vcf_lines = ["##fileformat=VCFv4.2\n"]
    refs = []
    for c in range(4):
        cfg = SimConfig(contig_name=f"mc{c}", contig_len=9_000,
                        num_strains=2, num_snps=45,
                        coverage_per_strain=9.0, read_length=2_500,
                        read_length_sd=250.0, error_rate=0.01,
                        seed=200 + c)
        sub = os.path.join(base, f"sub{c}")
        simulate(cfg, sub)
        contigs.append(cfg)
        refs.append((cfg.contig_name, cfg.contig_len))
        bf = BamFile(os.path.join(sub, "sim.bam"))
        fastas[cfg.contig_name] = open(
            os.path.join(sub, "sim.fa"), "rb").read()
        vcf_lines.append(f"##contig=<ID={cfg.contig_name}>\n")
        for line in open(os.path.join(sub, "sim.vcf")):
            if not line.startswith("#"):
                vcf_lines.append(line)
        for rec in bf.fetch(cfg.contig_name):
            all_records.append((c, rec))
    records = []
    for tid, rec in all_records:
        cigar = [(int(ln), "MIDNSHP=X"[int(op)])
                 for op, ln in zip(*rec.cigar_ops())]
        records.append(bamwrite.encode_record(
            rec.qname, rec.flag, tid, rec.pos, rec.mapq, cigar,
            rec.seq.tobytes(), list(rec.qual)))
    bamwrite.write_bam(os.path.join(base, "multi.bam"), refs, records)
    vcf_lines.insert(1 + len(contigs),
                     "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
    with open(os.path.join(base, "multi.vcf"), "w") as f:
        f.write("".join(vcf_lines))
    seqs = {name: b"".join(data.split(b"\n")[1:])
            for name, data in fastas.items()}
    write_fasta(os.path.join(base, "multi.fa"), seqs)
    return [c.contig_name for c in contigs]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers(base, out, nproc, port, contigs=""):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "multihost_worker.py")
    procs = []
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, worker, "--base", base, "--out", out,
             "--nproc", str(nproc), "--pid", str(pid), "--port",
             str(port), "--contigs", contigs],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        outs.append((p.returncode, stdout, stderr))
    for rc, stdout, stderr in outs:
        assert rc == 0, stderr.decode()[-3000:]
    return outs


@pytest.fixture(scope="module")
def multihost_sim(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("mh_sim"))
    names = _build_multi_sim(base)
    return base, names


def test_two_process_run_matches_single(multihost_sim, tmp_path):
    """Two real jax.distributed CPU processes; outputs byte-identical to
    one process (contig round-robin sharding + rank-0 TSV merge behind
    the cross-process barrier)."""
    base, names = multihost_sim
    single_out = str(tmp_path / "single")
    from floria_tpu.parallel.multihost import run_multihost

    opts = Options(bam_file=os.path.join(base, "multi.bam"),
                   vcf_file=os.path.join(base, "multi.vcf"),
                   reference_fasta=os.path.join(base, "multi.fa"),
                   out_dir=single_out, epsilon=0.02, block_length=3000,
                   snp_count_filter=10, overwrite=True)
    run_multihost(opts, 1, 0)

    multi_out = str(tmp_path / "multi")
    _spawn_workers(base, multi_out, 2, _free_port())

    for name in names:
        for fname in (f"{name}.vartigs", f"{name}.haplosets"):
            a = open(os.path.join(single_out, name, fname)).read()
            b = open(os.path.join(multi_out, name, fname)).read()
            # HAP headers embed the out_dir path; normalize it.
            assert a.replace(single_out, "OUT") == b.replace(
                multi_out, "OUT"), fname
    tsv_a = open(os.path.join(single_out,
                              "contig_ploidy_info.tsv")).read()
    tsv_b = open(os.path.join(multi_out,
                              "contig_ploidy_info.tsv")).read()
    assert tsv_a == tsv_b
    # Per-process shard TSVs existed before the merge.
    assert os.path.exists(os.path.join(
        multi_out, "contig_ploidy_info.1.tsv"))


def test_two_process_contig_restriction(multihost_sim, tmp_path):
    """-G restriction intersects each rank's shard: only the listed
    contigs are phased, wherever they were assigned."""
    base, names = multihost_sim
    keep = names[:3]
    out = str(tmp_path / "restricted")
    _spawn_workers(base, out, 2, _free_port(), contigs=",".join(keep))
    for name in names:
        exists = os.path.exists(os.path.join(out, name,
                                             f"{name}.vartigs"))
        assert exists == (name in keep), name
