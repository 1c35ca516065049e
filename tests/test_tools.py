"""Tests for the auxiliary tools: vartig-dump, legacy frag files,
haplotagging, ecosystem scripts."""

import os
import subprocess
import sys

import numpy as np
import pytest

from floria_tpu.ingest.bam import BamFile
from floria_tpu.ingest.fragfile import read_frags_file, write_frags_file
from floria_tpu.out.haplotag import (haplotag_records, read_haploset,
                                     write_bam_records)
from floria_tpu import vartig_dump

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_vartig_dump(small_sim, tmp_path):
    cfg, truth, out = small_sim
    dest = str(tmp_path / "dump_vartigs.txt")
    vartig_dump.main(["-b", out + "/sim.bam", "-v", out + "/sim.vcf",
                      "-o", dest])
    lines = open(dest).read().splitlines()
    assert lines[0].startswith(">HAP")
    assert f"SNPRANGE:1-{cfg.num_snps}" in lines[0]
    seq = lines[1]
    assert len(seq) == cfg.num_snps
    # consensus of a mixed community is mostly 0/1 calls
    assert set(seq) <= set("0123?")


def test_fragfile_roundtrip(tmp_path):
    from floria_tpu.frag import Frag
    f1 = Frag("r1", 0, False)
    for snp, allele, q in [(3, 1, 30), (4, 0, 20), (7, 1, 25)]:
        f1.add_site(snp, allele, q, 0, 0)
    path = str(tmp_path / "frags.txt")
    write_frags_file([f1], path)
    back = read_frags_file(path)["frag_contig"]
    assert len(back) == 1
    g = back[0]
    assert g.seq_dict == {3: 1, 4: 0, 7: 1}
    assert g.qual_dict == {3: 30, 4: 20, 7: 25}
    assert g.first_position == 3 and g.last_position == 7


def test_haploset_parse_and_haplotag(small_sim, tmp_path):
    cfg, truth, out = small_sim
    hs = tmp_path / "c.haplosets"
    hs.write_text(
        ">HAP0.dir\tCONTIG:c\tSNPRANGE:1-5\tBASERANGE:1-50\tCOV:3.0\t"
        "ERR:0.01\tHAPQ:20\tREL_ERR:1.0\n"
        "read_0_s0\t1\t5\n"
        ">HAP1.dir\tCONTIG:c\tSNPRANGE:6-9\tBASERANGE:60-90\tCOV:3.0\t"
        "ERR:0.01\tHAPQ:3\tREL_ERR:1.0\n"
        "read_1_s1\t6\t9\n")
    parts = read_haploset(str(hs), min_hapq=10)
    assert 0 in parts and 1 not in parts
    assert parts[0] == {"read_0_s0"}

    bam = BamFile(out + "/sim.bam")
    target = bam.fetch(cfg.contig_name)[0].qname
    name_to_part = {target: 0}
    records = haplotag_records(bam, cfg.contig_name, name_to_part)
    assert len(records) == len(bam.fetch(cfg.contig_name))
    dest = str(tmp_path / "tagged.bam")
    write_bam_records(dest, bam, records)
    tagged = BamFile(dest)
    recs = tagged.fetch(cfg.contig_name)
    by_name = {}
    for r in recs:
        by_name[r.qname] = r
    assert b"HPi" in by_name[target].raw
    assert len(recs) == len(bam.fetch(cfg.contig_name))


def test_script_write_contig_headers(tmp_path):
    vcf = tmp_path / "t.vcf"
    vcf.write_text("##fileformat=VCFv4.2\n"
                   "##source=x\n"
                   "#CHROM\tPOS\tID\tREF\tALT\n"
                   "ctg1\t5\t.\tA\tT\n")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "write_contig_headers_vcf.py"),
         str(vcf)], capture_output=True, text=True,
        env=dict(os.environ))
    assert r.returncode == 0, r.stderr
    out = open(str(vcf) + ".with_header").read()
    assert "##contig=<ID=ctg1>" in out


def test_script_output_snpped_contigs(small_sim, tmp_path):
    cfg, truth, out = small_sim
    vartigs = tmp_path / "v.vartigs"
    # One vartig covering SNPs 1-3 with alt alleles everywhere.
    import floria_tpu.ingest.vcf as vcfmod
    cv = vcfmod.read_vcf(out + "/sim.vcf").get(cfg.contig_name)
    base_lo = cv.snp_to_gn(1) + 1
    base_hi = cv.snp_to_gn(3) + 1
    vartigs.write_text(
        f">HAP0.x\tCONTIG:{cfg.contig_name}\tSNPRANGE:1-3\t"
        f"BASERANGE:{base_lo}-{base_hi}\tCOV:3.0\tERR:0.01\tHAPQ:30\t"
        "REL_ERR:1.0\n111\n")
    dest = str(tmp_path / "contigs.fa")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "output_snpped_contigs.py"),
         "-f", out + "/sim.fa", "-v", out + "/sim.vcf", "-t",
         str(vartigs), "-o", dest], capture_output=True, text=True,
        env=dict(os.environ))
    assert r.returncode == 0, r.stderr
    lines = open(dest).read().splitlines()
    seq = lines[1]
    # The alt allele should now be at each of the 3 SNP offsets.
    for snp in (1, 2, 3):
        rel = cv.snp_to_gn(snp) - (base_lo - 1)
        assert seq[rel] == chr(cv.pos_allele_map[cv.snp_to_gn(snp)][1])
