"""Native fast-ingest path must produce fragments identical to the pure
Python extraction."""

import numpy as np
import pytest

from floria_tpu import native
from floria_tpu.ingest import bam as bamlib
from floria_tpu.ingest import vcf
from floria_tpu.ingest.fragments import get_frags_from_bam
from floria_tpu.options import Options


@pytest.fixture(scope="module")
def have_native():
    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")


def test_fast_matches_pure(have_native, small_sim):
    cfg, truth, out = small_sim
    from floria_tpu.ingest.fastingest import FastBam

    prof = vcf.read_vcf(out + "/sim.vcf")
    cv = prof.get(cfg.contig_name)
    opts = Options()

    pure_bam = bamlib.BamFile(out + "/sim.bam")
    fast_bam = FastBam(out + "/sim.bam")
    assert fast_bam.references == pure_bam.references
    assert fast_bam.n_records == sum(
        len(v) for v in pure_bam.records_by_contig().values())

    with_p, without_p = get_frags_from_bam(pure_bam, None, cv, opts,
                                           None, cfg.contig_name)
    with_f, without_f = get_frags_from_bam(fast_bam, None, cv, opts,
                                           None, cfg.contig_name)
    assert len(with_p) == len(with_f)
    assert len(without_p) == len(without_f)
    pure_by_id = {f.id: f for f in with_p}
    for f in with_f:
        g = pure_by_id[f.id]
        assert f.seq_dict == g.seq_dict, f.id
        assert f.qual_dict == g.qual_dict
        assert f.snp_pos_to_seq_pos == g.snp_pos_to_seq_pos
        assert f.first_pos_base == g.first_pos_base
        assert f.last_pos_base == g.last_pos_base
        assert f.seq_string[0] == g.seq_string[0]
        assert f.qual_string[0] == g.qual_string[0]


def test_fast_with_realignment(have_native, small_sim):
    cfg, truth, out = small_sim
    from floria_tpu.ingest.fastingest import FastBam

    prof = vcf.read_vcf(out + "/sim.vcf")
    cv = prof.get(cfg.contig_name)
    opts = Options()
    ref_seq = open(out + "/sim.fa", "rb").read().split(b"\n", 1)[1]
    ref_seq = ref_seq.replace(b"\n", b"")

    pure_bam = bamlib.BamFile(out + "/sim.bam")
    fast_bam = FastBam(out + "/sim.bam")
    with_p, _ = get_frags_from_bam(pure_bam, None, cv, opts, ref_seq,
                                   cfg.contig_name)
    with_f, _ = get_frags_from_bam(fast_bam, None, cv, opts, ref_seq,
                                   cfg.contig_name)
    pure_by_id = {f.id: f for f in with_p}
    for f in with_f:
        assert f.seq_dict == pure_by_id[f.id].seq_dict


def test_partial_decode_matches_full(have_native, tmp_path, monkeypatch):
    """Sidecar-indexed partial decode (the htslib-.bai analog used by
    contig sharding) must reproduce the full decode's fields and
    payloads exactly for the restricted contigs."""
    from floria_tpu.ingest.fastingest import FastBam
    from floria_tpu.sim.simulate import SimConfig, simulate_multi

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path / "cache"))
    cfgs = [SimConfig(contig_name=f"c{i}", contig_len=8_000,
                      num_strains=2, num_snps=40,
                      coverage_per_strain=4.0, read_length=1_500,
                      read_length_sd=200.0, seed=900 + i)
            for i in range(6)]
    simulate_multi(cfgs, str(tmp_path / "sim"))
    path = str(tmp_path / "sim" / "sim.bam")

    want = {"c1", "c4"}
    # No sidecar yet: restricted open falls back to full decode and
    # WRITES the sidecar.
    first = FastBam(path, restrict=want)
    assert first.n_records > 0
    import os
    assert os.path.exists(FastBam._sidecar_path(path))

    full = FastBam(path)
    part = FastBam(path, restrict=want)
    tids = [full.references.index(c) for c in sorted(want)]
    sel = np.flatnonzero(np.isin(full.tid, tids))
    assert part.n_records == len(sel) < full.n_records
    for nm in ("rec_off", "tid", "pos", "mapq", "flag", "n_cigar",
               "l_seq", "l_read_name"):
        np.testing.assert_array_equal(getattr(part, nm),
                                      getattr(full, nm)[sel])
    for k in (0, len(sel) // 2, len(sel) - 1):
        assert part.qname(k) == full.qname(int(sel[k]))
        assert part.payload(k) == full.payload(int(sel[k]))
    sb, qb, offs = part.payloads_batch(np.arange(part.n_records))
    sb2, qb2, offs2 = full.payloads_batch(sel)
    np.testing.assert_array_equal(sb, sb2)
    np.testing.assert_array_equal(qb, qb2)
    np.testing.assert_array_equal(offs, offs2)


def test_partial_decode_stale_sidecar(have_native, tmp_path, monkeypatch):
    """A sidecar whose mtime/size no longer match the BAM must be
    ignored (full decode + rewrite), never trusted."""
    import os

    from floria_tpu.ingest.fastingest import FastBam
    from floria_tpu.sim.simulate import SimConfig, simulate_multi

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path / "cache"))
    cfgs = [SimConfig(contig_name=f"s{i}", contig_len=6_000,
                      num_strains=2, num_snps=30,
                      coverage_per_strain=3.0, read_length=1_200,
                      read_length_sd=100.0, seed=950 + i)
            for i in range(3)]
    simulate_multi(cfgs, str(tmp_path / "a"))
    path = str(tmp_path / "a" / "sim.bam")
    FastBam(path)  # writes the sidecar
    sp = FastBam._sidecar_path(path)
    assert os.path.exists(sp)

    # Regenerate the BAM with different content at the same path.
    cfgs2 = [SimConfig(contig_name=f"s{i}", contig_len=6_000,
                       num_strains=2, num_snps=30,
                       coverage_per_strain=4.0, read_length=1_100,
                       read_length_sd=100.0, seed=970 + i)
             for i in range(3)]
    simulate_multi(cfgs2, str(tmp_path / "b"))
    os.replace(str(tmp_path / "b" / "sim.bam"), path)

    full = FastBam(path)
    part = FastBam(path, restrict={"s1"})
    tid = full.references.index("s1")
    sel = np.flatnonzero(full.tid == tid)
    assert part.n_records == len(sel)
    np.testing.assert_array_equal(part.rec_off, full.rec_off[sel])


def test_contig_snp_counts_cache(tmp_path, monkeypatch, small_sim):
    """VCF SNP-count sidecar: cached result == fresh scan; stale
    entries are rebuilt."""
    import json
    import os

    from floria_tpu.parallel.multihost import _contig_snp_counts

    cfg, _truth, out = small_sim
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       str(tmp_path / "cache"))
    vcf = os.path.join(out, "sim.vcf")
    fresh = _contig_snp_counts(vcf)
    assert fresh[cfg.contig_name] > 0
    again = _contig_snp_counts(vcf)  # served from the sidecar
    assert again == fresh
    # Poison the sidecar; a stale (mtime-mismatched) entry must not
    # be served.
    caches = list((tmp_path / "cache").glob("vcfsnps_*.json"))
    assert len(caches) == 1
    data = json.loads(caches[0].read_text())
    data["num_snps"] = {cfg.contig_name: 1}
    data["mtime_ns"] = 0
    caches[0].write_text(json.dumps(data))
    rebuilt = _contig_snp_counts(vcf)
    assert rebuilt == fresh
